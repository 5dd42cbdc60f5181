"""Contrastive set extraction (PyTorch port of
`cgs_tpu/train/contrastive.py`; reference main.py:238-312).

A no-grad critic sweep in eval mode over the device-resident train
frames splits them into positives (pred > --high-rew-thresh, default
0.7) and negatives (pred < --low-rew-thresh, default 0.3); numpy
samplers then draw (K pos, K neg, 2K contrast-neg) index triples per
step (K=32, main.py:306-312). Only the (N,) prediction vector comes
down for the split; the pos/neg frame banks are gathered on the card.

Over a mesh (port of `cgs_tpu/handler.py:340-356`) every rank sweeps,
and rank 0's split is broadcast, so no rank can split differently (two
cards may round a pred at the threshold apart).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from cgs_tpu_torch.train.losses import ingest


def critic_sweep(critic: torch.nn.Module, x_dev: torch.Tensor,
                 batch: int = 4096) -> np.ndarray:
    """Preds of every frame of x_dev (N, 64, 64, 3) uint8, with the
    critic in eval mode (main.py:240); host (N,) float32."""
    was_training = critic.training
    critic.eval()
    try:
        with torch.no_grad():
            preds = [critic(ingest(x_dev[lo:lo + batch])).squeeze(-1)
                     for lo in range(0, x_dev.shape[0], batch)]
    finally:
        critic.train(was_training)
    if not preds:
        return np.zeros((0,), np.float32)
    return torch.cat(preds).cpu().numpy()


@dataclasses.dataclass
class ContrastiveSets:
    """Device-resident pos/neg frame banks + label rows."""
    xpos: torch.Tensor       # (P, 64, 64, 3) uint8
    ypos: torch.Tensor       # (P,) float32, row rewidx
    xneg: torch.Tensor       # (N, 64, 64, 3) uint8
    yneg: torch.Tensor       # (N,) float32
    preds: np.ndarray        # (total,) critic preds (host)
    pos_mask: np.ndarray
    neg_mask: np.ndarray

    @property
    def n_pos(self) -> int:
        return int(self.xpos.shape[0])

    @property
    def n_neg(self) -> int:
        return int(self.xneg.shape[0])


def extract_contrastive_sets(cfg, critic, x_dev: torch.Tensor,
                             y_row: np.ndarray, rng: np.random.Generator,
                             min_count: int = 500,
                             mesh=None) -> ContrastiveSets:
    """Sweep + threshold split (main.py:238-312). critic: the trained
    critic module on x_dev's device; y_row: host (N,) labels at row
    rewidx. Raises AssertionError below min_count per side (parity
    with main.py:281). mesh: the split is rank 0's on every rank."""
    n = int(x_dev.shape[0])
    if cfg.critic or cfg.cload:
        preds = critic_sweep(critic, x_dev)
        pos = preds > cfg.high_rew_thresh
        neg = preds < cfg.low_rew_thresh
    else:
        # no critic -> random split (main.py:268-272)
        pos = rng.random(n) > 0.5
        neg = ~pos
        preds = pos.astype(np.float32)
    if mesh is not None:
        preds, pos, neg = mesh.broadcast_object((preds, pos, neg))

    assert pos.sum() >= min_count and neg.sum() >= min_count, (
        f"contrastive split too small: {int(pos.sum())} pos / "
        f"{int(neg.sum())} neg (need >={min_count} each, main.py:281)")
    if cfg.critic or cfg.cload:
        assert preds[pos].mean() > cfg.high_rew_thresh  # main.py:302

    dev = x_dev.device
    pos_idx = torch.from_numpy(np.nonzero(pos)[0]).to(dev)
    neg_idx = torch.from_numpy(np.nonzero(neg)[0]).to(dev)
    y_row = np.asarray(y_row, np.float32)
    return ContrastiveSets(
        xpos=x_dev.index_select(0, pos_idx),
        ypos=torch.from_numpy(np.ascontiguousarray(y_row[pos])).to(dev),
        xneg=x_dev.index_select(0, neg_idx),
        yneg=torch.from_numpy(np.ascontiguousarray(y_row[neg])).to(dev),
        preds=preds, pos_mask=pos, neg_mask=neg,
    )


def sample_index_stacks(rng: np.random.Generator, n_pos: int,
                        n_neg: int, n_steps: int, k: int = 32,
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hidx (S,K), lidx (S,K), cidx (S,2K)) int32 with replacement
    (np.random.choice semantics, main.py:310-312)."""
    h = rng.integers(0, n_pos, (n_steps, k), dtype=np.int32)
    l = rng.integers(0, n_neg, (n_steps, k), dtype=np.int32)
    c = rng.integers(0, n_neg, (n_steps, 2 * k), dtype=np.int32)
    return h, l, c
