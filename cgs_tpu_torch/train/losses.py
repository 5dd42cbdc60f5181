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
dropout once over the merged batch. A critic whose BatchNorm runs on
batch statistics (a live `--critic resnet18`) couples the frames of a
pass, so fusing would mix A's statistics with B's: its passes run
unfused, as the reference's separate calls (main.py:394-413), and its
running statistics move once a pass. A frozen one runs BatchNorm on its
running statistics (`train/steps.py:set_masker_modes`), fused and exact.
A live `--critic convnext_t` or `swin_v2_t` draws its drop-path per
frame, couples no frames (Swin's attention stays within a frame's
windows), and fuses as dropout does; its pyramid's first tap is None (no
32x32 level), which the A || B pass slices as it is.

Every critic and masker pass goes through `models/build.py:
critic_forward` / `masker_forward`: the spans `cgs.model.critic` and
`cgs.model.masker`, and the frame and BatchNorm counters.

The fused passes read joined batches without a `torch.cat` on the
step's path: the (A, B) pass reads the ingest's joined batch `ab` when
the caller passes it (`train/steps.py:masker_step` does), and with
inject on the two merges go through `ops.merge.merge_both`, the
`merge_pair` / `merge_pair_bwd` kernels on the card, which write
replaced || injected as the one batch the (replaced, injected) pass
reads. With inject off, the replace merge is plain PyTorch, as JAX
falls back to jnp there (losses.py:150-154).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from cgs_tpu_torch.models.build import (
    batch_norms, critic_forward, masker_forward,
)
from cgs_tpu_torch.ops.kernels import (
    Segment, gather_normalize_u8, normalize_u8,
)
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


def mse_rows(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(R, n) -> (R,): each row's MSE."""
    return ((pred - target) ** 2).mean(1)


def bce_rows(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """(R, n) -> (R,): each row's `bce`."""
    logp = _clamped_log(pred)
    lognp = _clamped_log(1.0 - pred)
    return -(target * logp + (1.0 - target) * lognp).mean(1)


def ingest(x_u8: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) uint8 -> (N, 3, H, W) float32 in [0, 1], stored
    channels_last (main.py:189 `.float()/255`). On the card this is the
    `normalize_u8` kernel, bit-equal to `x.float() * float32(1/255)`."""
    return normalize_u8(x_u8).permute(0, 3, 1, 2)


def ingest_segments(segments: Sequence[Segment], out=None):
    """(frames, labels): the segments gathered, rolled and ingested into
    one (N, 3, H, W) float32 batch stored channels_last, and the
    labelled segments' labels (`ops.kernels.gather_normalize_u8`, one
    kernel launch on the card), written into `out` (the NHWC frames and
    the labels buffers) when given."""
    x, y = gather_normalize_u8(segments, out=out)
    return x.permute(0, 3, 1, 2), y


def build_critic_loss(cfg):
    """(critic, x f32 NCHW, y (B,), dropout generator) -> scalar loss
    (main.py:189-195)."""
    use_bce = bool(cfg.threshrew)

    def loss_fn(critic, x, y, generator: Optional[torch.Generator] = None):
        pred = critic_forward(critic, x, generator=generator).squeeze(-1)
        return bce(pred, y) if use_bce else mse(pred, y)

    return loss_fn


def masker_terms(cfg, pred, negpred, y, z, replacevalue,
                 injectvalue=None):
    """The masker loss of each of R rows (seeds) from its critic outputs
    (main.py:378-429), shared by `build_masker_loss` (R = 1) and the
    seed-parallel runner. pred, negpred, y, replacevalue, injectvalue:
    (R, n), negpred detached by the caller, injectvalue None without
    --inject; z: the (R*n, 1, H, W) masks, row r's at [r*n, (r+1)*n).
    Returns (loss (R,), replace, inject, norm, critic (R,) each), norm
    as the reference logs it."""
    r, n = pred.shape
    zero = torch.zeros(r, device=pred.device)
    terms = []          # the loss is their sum, in this order
    if cfg.live:  # main.py:378-385
        closs = (bce_rows if cfg.threshrew else mse_rows)(pred, y)
        terms.append(float(cfg.lfak) * closs)
    else:
        closs = zero
    replaceloss = mse_rows(replacevalue, negpred)  # main.py:400
    terms.append(replaceloss)
    if cfg.inject:  # main.py:405-413
        injectloss = mse_rows(injectvalue, pred.detach())
        terms.append(injectloss)
    else:
        injectloss = zero
    # sparsity (main.py:415-429); vf = 1 under staticnorm, where vf * z
    # is z itself
    vz = z if cfg.staticnorm else \
        (1.0 - pred.detach()).reshape(r * n, 1, 1, 1) * z
    vz = vz.reshape(r, -1)
    l1, l2 = float(cfg.L1), float(cfg.L2)
    norm = logged_norm = None
    if l1:
        logged_norm = l1 * vz.abs().mean(1)
        norm = logged_norm
    if l2:
        # when BOTH penalties are on, the reference's log shows only the
        # L2 term (`normloss` is overwritten, main.py:421-429); the
        # total loss still contains both
        logged_norm = l2 * (vz ** 2).mean(1)
        norm = logged_norm if norm is None else norm + logged_norm
    if norm is None:
        norm = logged_norm = zero
    loss = terms[0]
    for t in terms[1:] + [norm]:
        loss = loss + t
    return loss, replaceloss, injectloss, logged_norm, closs


def build_masker_loss(cfg, fuse: str = "both"):
    """(models {'critic', 'masker'[, 'sepcrit']}, a f32, y, b f32,
    dropout generator) -> (loss, aux); aux carries the per-term metrics
    and the tensors the reference visualizes (main.py:364-429,466-530).
    a and b are NCHW float32 frames stored channels_last."""
    inject = bool(cfg.inject)
    separate = bool(cfg.separate)
    if fuse not in ("none", "merges", "both"):
        raise ValueError(f"fuse={fuse!r} not in ('none','merges','both')")
    fuse_ab = fuse == "both"
    fuse_merge = fuse in ("merges", "both")

    def loss_fn(models: Dict[str, torch.nn.Module], a, y, b,
                generator: Optional[torch.Generator] = None, ab=None):
        """ab: optional (2N) batch whose halves are a and b; the fused
        (A, B) critic pass reads it instead of `torch.cat([a, b])`."""
        critic = models["critic"]
        n = a.shape[0]
        # batch statistics couple a pass's frames: no fused pass then
        fusable = not any(m.training for m in batch_norms(critic))
        if fuse_ab and fusable:
            out, embeds = critic_forward(
                critic, torch.cat([a, b]) if ab is None else ab,
                collect=True, generator=generator)
            out = out.squeeze(-1)
            pred = out[:n]
            negpred = out[n:].detach()
            embeds = [None if e is None else e[:n] for e in embeds]
        else:
            pred, embeds = critic_forward(critic, a, collect=True,
                                          generator=generator)
            pred = pred.squeeze(-1)
            negpred = critic_forward(critic, b, generator=generator
                                     ).squeeze(-1).detach()

        aux = {"pred": pred, "negpred": negpred}
        if separate:  # main.py:389-390
            _, embeds = critic_forward(models["sepcrit"], a, collect=True,
                                       generator=generator)

        z = masker_forward(models["masker"], a, embeds)
        aux["z"] = z

        if inject:  # main.py:395,406: replaced || injected, one batch
            merged = merge_both(a, b, z)
            replaced, injected = merged[:n], merged[n:]
        else:
            replaced, injected = replace_merge(a, b, z), None
        aux["replaced"], aux["injected"] = replaced, injected
        injectvalue = None
        if fuse_merge and inject and fusable:
            vals = critic_forward(critic, merged,
                                  generator=generator).squeeze(-1)
            replacevalue = vals[:n]
            injectvalue = vals[n:]
        else:
            replacevalue = critic_forward(critic, replaced,
                                          generator=generator).squeeze(-1)
            if inject:
                injectvalue = critic_forward(
                    critic, injected, generator=generator).squeeze(-1)
        aux["replacevalue"] = replacevalue
        aux["injectvalue"] = (injectvalue if inject
                              else torch.zeros_like(negpred))

        loss, *terms = masker_terms(
            cfg, pred[None], negpred[None], y[None], z, replacevalue[None],
            None if injectvalue is None else injectvalue[None])
        for key, t in zip(("replace", "inject", "norm", "critic"), terms):
            aux[key] = t[0]
        aux["loss"] = loss[0]
        return loss[0], aux

    return loss_fn
