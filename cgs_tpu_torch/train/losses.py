"""Loss builders of the two training phases (PyTorch port of
`cgs_tpu/train/losses.py`).

Masker-phase gradient topology (reference main.py:360-429):

    pred, embeds = critic(A)        # grads flow (live) through pred AND
    negpred      = critic(B)        #   through embeds into Z
    Z            = masker(A, embeds[or sepcrit(A) embeds if separate])
    replaceloss  = MSE(critic(A(1-Z)+ZB), negpred.detach())
    injectloss   = MSE(critic(B(1-Z)+ZA), pred.detach())
    sparsity     = L1*mean|vf*Z| + L2*mean((vf*Z)^2),
                   vf = 1 (staticnorm) or 1 - pred.detach()
    critic_loss  = lfak * MSE(pred, Y)          (live only)

`.detach()` sits exactly where the JAX package puts `stop_gradient`
(losses.py:125,131,174,184). Which modules train is decided by the
caller (`requires_grad` of each module, `train/steps.py`); a frozen
critic still passes gradients through to its input, as in JAX.

fuse batches the data-independent critic passes into one call each:
"none" is the reference's 4 calls, "merges" fuses (replaced, injected),
"both" (default) also fuses (A, B). The gradient topology is the same
in all three (no cross-batch op in the critic); a fused pair draws its
dropout once over the merged batch.

With inject on, the two merges go through `ops.merge.merge_both`, the
`merge_pair` / `merge_pair_bwd` kernels on the card. With inject off,
the replace merge is plain PyTorch, as JAX falls back to jnp there
(losses.py:150-154).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from cgs_tpu_torch.ops.kernels import normalize_u8
from cgs_tpu_torch.ops.merge import merge_both, replace_merge


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return ((pred - target) ** 2).mean()


def _clamped_log(x: torch.Tensor) -> torch.Tensor:
    """log(x) clamped at -100 like torch F.binary_cross_entropy, with
    a zero (not NaN) gradient at x == 0 (the clamp is active there)."""
    pos = x > 0
    safe = torch.where(pos, x, torch.ones_like(x))
    return torch.where(pos, torch.clamp(torch.log(safe), min=-100.0),
                       torch.full_like(x, -100.0))


def bce(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Binary cross-entropy on sigmoid outputs (main.py:193,381) with
    the logs clamped at -100 and no epsilon inside the log."""
    logp = _clamped_log(pred)
    lognp = _clamped_log(1.0 - pred)
    return -(target * logp + (1.0 - target) * lognp).mean()


def ingest(x_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, 3, H, W) float32 in [0, 1], stored
    channels_last (main.py:189 `.float()/255`). On the card this is the
    `normalize_u8` kernel, bit-equal to `x.float() * float32(1/255)`."""
    return normalize_u8(x_u8).permute(0, 3, 1, 2)


def build_critic_loss(cfg):
    """(critic, x f32 NCHW, y (B,), dropout generator) -> scalar loss
    (main.py:189-195)."""
    use_bce = bool(cfg.threshrew)

    def loss_fn(critic, x, y, generator: Optional[torch.Generator] = None):
        pred = critic(x, generator=generator).squeeze(-1)
        return bce(pred, y) if use_bce else mse(pred, y)

    return loss_fn


def build_masker_loss(cfg, fuse: str = "both"):
    """(models {'critic', 'masker'[, 'sepcrit']}, a f32, y, b f32,
    dropout generator) -> (loss, aux); aux carries the per-term metrics
    and the tensors the reference visualizes (main.py:364-429,466-530).
    a and b are NCHW float32 frames stored channels_last."""
    live = bool(cfg.live)
    inject = bool(cfg.inject)
    separate = bool(cfg.separate)
    staticnorm = bool(cfg.staticnorm)
    use_bce = bool(cfg.threshrew)
    l1 = float(cfg.L1)
    l2 = float(cfg.L2)
    lfak = float(cfg.lfak)
    if fuse not in ("none", "merges", "both"):
        raise ValueError(f"fuse={fuse!r} not in ('none','merges','both')")
    fuse_ab = fuse == "both"
    fuse_merge = fuse in ("merges", "both")

    def loss_fn(models: Dict[str, torch.nn.Module], a, y, b,
                generator: Optional[torch.Generator] = None):
        critic = models["critic"]
        n = a.shape[0]
        zero = torch.zeros((), device=a.device)
        if fuse_ab:
            out, embeds = critic(torch.cat([a, b], dim=0), collect=True,
                                 generator=generator)
            out = out.squeeze(-1)
            pred = out[:n]
            negpred = out[n:].detach()
            embeds = [e[:n] for e in embeds]
        else:
            pred, embeds = critic(a, collect=True, generator=generator)
            pred = pred.squeeze(-1)
            negpred = critic(b, generator=generator).squeeze(-1).detach()

        aux = {"pred": pred, "negpred": negpred}
        loss = 0.0
        if live:  # main.py:378-385
            closs = bce(pred, y) if use_bce else mse(pred, y)
            loss = loss + lfak * closs
            aux["critic"] = closs
        else:
            aux["critic"] = zero

        if separate:  # main.py:389-390
            _, embeds = models["sepcrit"](a, collect=True,
                                          generator=generator)

        z = models["masker"](a, embeds)
        aux["z"] = z

        if inject:
            replaced, injected = merge_both(a, b, z)  # main.py:395,406
        else:
            replaced, injected = replace_merge(a, b, z), None
        aux["replaced"], aux["injected"] = replaced, injected
        if fuse_merge and inject:
            vals = critic(torch.cat([replaced, injected], dim=0),
                          generator=generator).squeeze(-1)
            replacevalue = vals[:n]
            injectvalue = vals[n:]
        else:
            replacevalue = critic(replaced,
                                  generator=generator).squeeze(-1)
            injectvalue = None
        replaceloss = mse(replacevalue, negpred)  # main.py:400
        loss = loss + replaceloss
        aux["replace"] = replaceloss
        aux["replacevalue"] = replacevalue

        if inject:  # main.py:405-413
            if injectvalue is None:
                injectvalue = critic(injected,
                                     generator=generator).squeeze(-1)
            injectloss = mse(injectvalue, pred.detach())
            loss = loss + injectloss
            aux["inject"] = injectloss
            aux["injectvalue"] = injectvalue
        else:
            aux["inject"] = zero
            aux["injectvalue"] = torch.zeros_like(negpred)

        # sparsity (main.py:415-429)
        vf = 1.0 if staticnorm else (1.0 - pred.detach())[:, None, None,
                                                          None]
        norm = zero
        logged_norm = zero
        if l1:
            logged_norm = l1 * (vf * z).abs().mean()
            norm = norm + logged_norm
        if l2:
            # when BOTH penalties are on, the reference's log shows
            # only the L2 term (`normloss` is overwritten,
            # main.py:421-429); the total loss still contains both
            logged_norm = l2 * ((vf * z) ** 2).mean()
            norm = norm + logged_norm
        loss = loss + norm
        aux["norm"] = logged_norm
        aux["loss"] = loss
        return loss, aux

    return loss_fn
