"""Legacy merge-training variants (PyTorch port of
`cgs_tpu/sandbox/merge_variants.py`; reference
`contrastive_merge_segmentation_old`, TrainHandler.py:1098-1421, and
the old single-net `segment`, TrainHandler.py:1697-1894): the full
`zoo.Unet` scored by its own critic head, the path TrainHandler ran
before main.py's split critic / decoder design.

  * `percentile_split`: the >= 80th / <= 20th percentile of the critic's
    scores (TrainHandler.py:1153-1157).
  * `distnorm_loss`: the centroid pull, with the reference's
    `sqrt(xs^2 + xs^2)` typo (TrainHandler.py:1283) unless fixed=True.
  * `make_single_net_merge_step`: within-batch negatives
    (pred < 1 - threshold), one replace merge pushed to a zero critic
    logit, the live critic loss's double sigmoid (TrainHandler.py:
    1742-1743) and the `-clustercritic` channels.
  * `make_pair_merge_step`: a pre-sampled (high || low, negative) pair,
    the replace and inject merges scored by the net's own head.

Frames are NCHW (B, C, 64, 64) floats; the masks (B, 1, 64, 64). A step
is a function that runs one forward, one backward and one step of the
given optimizer (Adam in the reference) on the U-Net in place, and
returns the detached metrics.

Stop-gradient topology: a weight-stopped score is
`torch.func.functional_call` of the same module with its parameters
detached (or with a frozen snapshot state_dict the caller made once),
not a deepcopy per step; gradients still flow through it to its input,
the merged frames, and so to the mask, as `jax.lax.stop_gradient` of
the parameters does.

Merges: the pair step's replaced and injected (`merge_variants.py:
254-263`) are one `ops.merge.merge_both` call, the `merge_pair` kernel
writing replaced || injected as one batch that one critic pass scores,
its backward the `merge_pair_bwd` kernel asked for dz alone (the frames
need no gradient). Without inject the one replace merge is plain
PyTorch, as is the single-net step's, as XLA computed them.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.func import functional_call

from cgs_tpu_torch.ops.kernels import blend
from cgs_tpu_torch.ops.merge import merge_both

CL = torch.channels_last


# ---------------------------------------------------------------------------
# percentile split (TrainHandler.py:1153-1165)
# ---------------------------------------------------------------------------

def percentile_split(preds: torch.Tensor, hi: float = 0.8, lo: float = 0.2
                     ) -> Dict[str, torch.Tensor]:
    """The value at rank int(round(100 hi)) * n // 100 of the sorted
    scores as `high`, at the lo rank as `low` (the reference indexes
    `sorted[8*len//10]` / `sorted[2*len//10]`), and the selectors
    preds >= high, preds <= low."""
    order = torch.argsort(preds)
    n = preds.shape[0]
    high = preds[order[min(n - 1, int(round(hi * 100)) * n // 100)]]
    low = preds[order[min(n - 1, int(round(lo * 100)) * n // 100)]]
    return {"high": high, "low": low,
            "highsel": preds >= high, "lowsel": preds <= low}


# ---------------------------------------------------------------------------
# dist-norm loss (TrainHandler.py:1270-1287)
# ---------------------------------------------------------------------------

def distnorm_loss(z: torch.Tensor, fixed: bool = False) -> torch.Tensor:
    """Centroid pull: per-mask centroid votes from coordinate grids,
    target = clamp(mask - dist, 0), loss = 5 * MSE(mask, target).
    z (B, 1, H, W). fixed=False keeps the reference's
    `sqrt(xs^2 + xs^2)` typo (the y distance ignored)."""
    _, _, h, w = z.shape
    mask = z.detach()
    xs = (torch.arange(w, dtype=z.dtype, device=z.device) / w).view(
        1, 1, 1, w)
    ys = (torch.arange(h, dtype=z.dtype, device=z.device) / h).view(
        1, 1, h, 1)
    xvote = (xs * mask).mean((2, 3), keepdim=True)
    yvote = (ys * mask).mean((2, 3), keepdim=True)
    dx = xs - xvote
    dy = ys - yvote
    second = dy if fixed else dx          # TrainHandler.py:1283 typo
    dist = torch.sqrt(dx ** 2 + second ** 2)
    target = torch.clamp(mask - dist, min=0.0)
    return 5.0 * torch.mean((z - target) ** 2)


def bce_with_logits(logits: torch.Tensor, targets: torch.Tensor
                    ) -> torch.Tensor:
    """torch F.binary_cross_entropy_with_logits (mean), written as the
    JAX package writes it."""
    return torch.mean(logits.clamp_min(0) - logits * targets
                      + torch.log1p(torch.exp(-logits.abs())))


def _detached(unet: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The U-Net's parameters, cut from autograd: a weight-stopped
    snapshot that shares their storage (no copy)."""
    return {k: v.detach() for k, v in unet.named_parameters()}


def _score(unet, params: Optional[Dict[str, torch.Tensor]],
           frames: torch.Tensor) -> torch.Tensor:
    """The net's critic head, (B,); params None: the live parameters."""
    if params is None:
        return unet(frames, critic=True).squeeze(-1)
    return functional_call(unet, params, (frames,),
                           {"critic": True}).squeeze(-1)


def _apply(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()


# ---------------------------------------------------------------------------
# old single-net `segment` step (TrainHandler.py:1697-1894)
# ---------------------------------------------------------------------------

def make_single_net_merge_step(
        unet, optimizer: torch.optim.Optimizer, *, threshold: float = 0.9,
        l1: float = 0.0, l2: float = 0.0, staticnorm: bool = False,
        distnorm: bool = False, live: bool = False,
        n_cluster_channels: int = 0) -> Callable:
    """One step of the old merge training: the U-Net masks its own
    batch, the negatives come from within it (pred < 1 - threshold), and
    the one replace merge is pushed to a zero critic logit with
    BCE-with-logits (TrainHandler.py:1750-1770). Port of
    `make_single_net_merge_step`.

    n_cluster_channels > 0 is the `-clustercritic` variant: the net
    (built with colorchs = 3 + n) scores concat(frames, channels) and the
    merge merges the channels too (TrainHandler.py:1763-1767). Merges
    and pred are scored with the weights stopped; only the live critic
    loss trains the head (the reference's separate critic_opti).

    Returns step(x, y, generator=None, channels=None, negatives=None)
    -> metrics. The negatives (B,) int64 are drawn uniformly among the
    frames with pred < 1 - threshold (all frames when none is) from
    `generator`, unless given (torch cannot replay the JAX step's
    `jax.random.categorical`; the tests pass its draw)."""

    def critic_in(frames, channels):
        return frames if channels is None else torch.cat(
            [frames, channels], 1)

    def loss_fn(x, y, generator, channels, negatives):
        fparams = _detached(unet)
        pred = torch.sigmoid(_score(unet, fparams, critic_in(x, channels)))
        critic_loss = (bce_with_logits(torch.sigmoid(
            _score(unet, None, critic_in(x, channels))), y)
            if live else torch.zeros((), device=x.device))
        negmask = pred.detach() < (1.0 - threshold)
        if negatives is None:
            # all-positive fallback: uniform (the reference `continue`s)
            probs = torch.where(negmask.any(), negmask.float(),
                                torch.ones_like(pred))
            negatives = torch.multinomial(probs, x.shape[0],
                                          replacement=True,
                                          generator=generator)
        a, b = x, x[negatives]
        z = unet(critic_in(a, channels))
        merged = blend(a, b, z)
        mergechs = (None if channels is None
                    else blend(channels, channels[negatives], z))
        mergevalue = _score(unet, fparams, critic_in(merged, mergechs))
        valueloss = bce_with_logits(mergevalue, torch.zeros_like(mergevalue))
        loss = valueloss + critic_loss
        valuefak = 1.0 if staticnorm else (
            1.0 - pred.detach().reshape(-1, 1, 1, 1))
        norm = torch.zeros((), device=x.device)
        if l1:                              # L1 wins over L2 (elif)
            norm = l1 * torch.mean(torch.abs(valuefak * z))
        elif l2:
            norm = l2 * torch.mean((valuefak * z) ** 2)
        loss = loss + norm
        if distnorm:
            loss = loss + distnorm_loss(z)
        return loss, {"loss": loss, "value": valueloss, "norm": norm,
                      "critic": critic_loss,
                      "n_neg": negmask.sum().float()}

    def step(x, y, generator=None, channels=None, negatives=None):
        loss, metrics = loss_fn(x.contiguous(memory_format=CL), y,
                                generator, channels, negatives)
        _apply(optimizer, loss)
        return {k: v.detach() for k, v in metrics.items()}

    return step


# ---------------------------------------------------------------------------
# contrastive_merge_segmentation_old step (TrainHandler.py:1098-1421)
# ---------------------------------------------------------------------------

def make_pair_merge_step(
        unet, optimizer: torch.optim.Optimizer, *, lfak: float = 1.0,
        clossfak: float = 1.0, l1: float = 0.0, l2: float = 0.0,
        staticnorm: bool = False, distnorm: bool = False,
        inject: bool = True, live: bool = False, use_copy: bool = False
) -> Callable:
    """One step of the percentile-split pair training: a is [high ||
    low] frames (`percentile_split`), b their random low negatives, and
    the U-Net's own critic head scores the merges (the `-ucritic` path).
    Port of `make_pair_merge_step`.

    Critic freezing (TrainHandler.py:1107-1113, 1226):
      * live, not use_copy: merges scored by the live net, with
        gradients into its weights;
      * live, use_copy: by the weights stopped for this step;
      * not live: everything scored by a snapshot frozen once at set-up,
        given as `frozen` (a state_dict of the net's parameters; without
        it, the weights stopped for this step, as the JAX step).
    live adds clossfak * MSE(score, y) (TrainHandler.py:1215-1222).

    Returns step(a, y, b, frozen=None) -> metrics."""

    def loss_fn(a, y, b, frozen):
        fparams = _detached(unet) if frozen is None else frozen
        score_params = None if live else fparams
        merge_params = fparams if (use_copy or not live) else None
        pred = _score(unet, score_params, a)
        negpred = _score(unet, score_params, b)

        loss = torch.zeros((), device=a.device)
        critic_loss = torch.mean((pred - y) ** 2)
        if live:
            loss = loss + clossfak * critic_loss

        z = unet(a)
        n = a.shape[0]
        injectloss = torch.zeros((), device=a.device)
        if inject:      # replaced || injected: one kernel, one pass
            values = _score(unet, merge_params, merge_both(a, b, z))
            replacevalue, injectvalue = values[:n], values[n:]
        else:
            replacevalue = _score(unet, merge_params, blend(a, b, z))
        replaceloss = torch.mean((replacevalue - negpred.detach()) ** 2)
        loss = loss + lfak * replaceloss
        if inject:
            injectloss = torch.mean((injectvalue - pred.detach()) ** 2)
            loss = loss + lfak * injectloss

        valuefak = 1.0 if staticnorm else (
            1.0 - pred.detach().reshape(-1, 1, 1, 1))
        if not l2:                         # L2 flag wins here (:1261)
            norm = l1 * torch.mean(torch.abs(valuefak * z))
        else:
            norm = l2 * torch.mean((valuefak * z) ** 2)
        loss = loss + norm
        if distnorm:
            loss = loss + distnorm_loss(z)
        return loss, {"loss": loss, "replace": replaceloss,
                      "inject": injectloss, "norm": norm,
                      "critic": critic_loss}

    def step(a, y, b, frozen=None):
        loss, metrics = loss_fn(a.contiguous(memory_format=CL), y,
                                b.contiguous(memory_format=CL), frozen)
        _apply(optimizer, loss)
        return {k: v.detach() for k, v in metrics.items()}

    return step
