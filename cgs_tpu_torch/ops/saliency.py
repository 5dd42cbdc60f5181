"""Input-gradient saliency baseline (port of `cgs_tpu/ops/saliency.py`;
reference main.py:949-953,976-998).

The map is |d mean(pred) / d X| summed over channels, from
`torch.autograd.grad` of the critic alone. The two normalisations run
on host numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

# main.py:992 adds sys.float_info.min, a float64 denormal that underflows
# to 0 in float32 (0/0 = NaN on ReLU-dead frames); float32's smallest
# normal keeps the guard.
_EPS = float(np.finfo(np.float32).tiny)


def critic_with_saliency(critic, x: torch.Tensor, generator=None
                         ) -> Tuple[torch.Tensor, List[torch.Tensor],
                                    torch.Tensor]:
    """One critic forward and its input gradient.

    x: (B, C, H, W) float. Returns (pred (B, 1), embeds detached,
    saliency (B, 1, H, W)) with saliency = sum_c |d mean(pred) / dx|.
    """
    with torch.enable_grad():
        x = x.detach().requires_grad_(True)
        pred, embeds = critic(x, collect=True, generator=generator)
        (grad,) = torch.autograd.grad(pred.mean(), x)
    sal = grad.abs().sum(dim=1, keepdim=True)
    return pred.detach(), [None if e is None else e.detach()
                           for e in embeds], sal


def normalize_saliency_global(sal: np.ndarray, preds: np.ndarray,
                              thresh: float):
    """Global-mean normalisation (main.py:980-982,992-995).

    sal: (B, H, W, 1); preds: (B,). Returns (soft, hard uint8 {0,1})."""
    norm = np.mean(sal * (sal >= 0)) * thresh
    sal = sal / (norm + _EPS)
    sal = sal * preds[:, None, None, None]
    sal = np.where(sal >= 1.0, 1.0, sal)
    hard = (sal > thresh).astype(np.uint8)
    return sal, hard


def normalize_saliency_topk(sal: np.ndarray, preds: np.ndarray,
                            thresh: float):
    """Per-frame k-th order-statistic normalisation (main.py:984-995):
    each frame is divided by its k-th smallest value, k =
    floor(H*W*thresh)."""
    b, h, w, _ = sal.shape
    k = int(h * w * thresh)
    norm = np.sort(sal.reshape(b, -1), axis=-1)[:, min(k, h * w - 1)]
    sal = sal / (norm[:, None, None, None] + _EPS)
    sal = sal * preds[:, None, None, None]
    sal = np.where(sal >= 1.0, 1.0, sal)
    hard = (sal > thresh).astype(np.uint8)
    return sal, hard
