"""The uint8 ingest (gather by index, roll, normalise), the fused
counterfactual merges and their gradient, and the fused threshold+IoU
count: CUDA kernel wrappers and their plain PyTorch versions.

Ports of `cgs_tpu/ops/pallas_kernels.py:normalize_u8` (with the
gather, concatenation and roll a JAX train step fuses around it),
`:merge_pair`, `:merge_pair_bwd` and `:threshold_iou`. On a CUDA
tensor each wrapper launches its kernel (`csrc/normalize_u8.cu`,
`csrc/merge_pair.cu`, `csrc/threshold_iou.cu`) or raises; on a CPU
tensor it runs the plain version, which is also the oracle the kernel
is held against on the card. There is no fallback from the kernel to
the plain version.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from cgs_tpu_torch.ops import _build

# float32(1/255) == 0x3B808081: the JAX kernel and plain path multiply
# by it (pallas_kernels.py:67, pipeline.py:338); x / 255 rounds
# differently for many byte values
INV255 = float(np.float32(1.0 / 255.0))


# ---------------------------------------------------------------------
# uint8 ingest: gather by index, roll along W, normalise
# ---------------------------------------------------------------------

MAX_SEGMENTS = 3        # csrc/normalize_u8.cu: kMaxSeg
INGEST_DTYPES = (torch.float32, torch.bfloat16)


class Segment(NamedTuple):
    """Frames for `gather_normalize_u8`: rows `idx` of `bank` (all of
    its rows, in order, when idx is None), rolled by `shift` pixels
    along W (`torch.roll`'s sign, any integer), with their `labels`
    gathered beside them when labels (one float32 per bank row) are
    given."""
    bank: torch.Tensor                      # (M, H, W, C) uint8
    idx: Optional[torch.Tensor] = None      # (n,) int64, values in [0, M)
    shift: int = 0
    labels: Optional[torch.Tensor] = None   # (M,) float32

    @property
    def rows(self) -> int:
        return self.bank.shape[0] if self.idx is None else self.idx.shape[0]


def normalize_u8_plain(x_u8: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (x_u8.to(torch.float32) * INV255).to(dtype)


def gather_normalize_u8_plain(segments: Sequence[Segment],
                              dtype: torch.dtype = torch.float32):
    """The kernel's function in plain PyTorch: index_select, roll,
    cat, normalise."""
    frames, labels = [], []
    for seg in segments:
        x = seg.bank if seg.idx is None else seg.bank.index_select(0,
                                                                   seg.idx)
        frames.append(torch.roll(x, int(seg.shift), dims=2))
        if seg.labels is not None:
            labels.append(seg.labels if seg.idx is None
                          else seg.labels.index_select(0, seg.idx))
    return (normalize_u8_plain(torch.cat(frames), dtype),
            torch.cat(labels) if labels else None)


def _check_segments(segments: Sequence[Segment], dtype) -> None:
    name = "gather_normalize_u8"
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"{name}: 1 to {MAX_SEGMENTS} segments, got "
                         f"{len(segments)}")
    if dtype not in INGEST_DTYPES:
        raise ValueError(f"{name}: dtype {dtype} not in {INGEST_DTYPES}")
    frame, dev = segments[0].bank.shape[1:], segments[0].bank.device
    labelled = [seg.labels is not None for seg in segments]
    if labelled != sorted(labelled, reverse=True):
        raise ValueError(f"{name}: the segments with labels must come "
                         "first")
    for seg in segments:
        b = seg.bank
        if b.dtype != torch.uint8 or b.dim() != 4:
            raise ValueError(f"{name}: a bank must be uint8 (M, H, W, C), "
                             f"got {b.dtype} {tuple(b.shape)}")
        if b.shape[1:] != frame or b.device != dev:
            raise ValueError(f"{name}: banks differ in frame shape or "
                             "device")
        if seg.idx is not None and (seg.idx.dtype != torch.int64
                                    or seg.idx.dim() != 1
                                    or seg.idx.device != dev):
            raise ValueError(f"{name}: idx must be 1-D int64 on the "
                             "banks' device")
        if seg.labels is not None and (
                seg.labels.dtype != torch.float32
                or tuple(seg.labels.shape) != (b.shape[0],)
                or seg.labels.device != dev):
            raise ValueError(f"{name}: labels must be float32 "
                             f"({b.shape[0]},) on the banks' device")


def gather_normalize_u8(segments: Sequence[Segment],
                        dtype: torch.dtype = torch.float32):
    """(frames, labels): the segments' frames gathered, rolled and
    normalised (`x * float32(1/255)`, then rounded to `dtype`), laid end
    to end in one (sum n, H, W, C) buffer, and the labels of the
    labelled segments, which come first, or None. One kernel launch on
    the card. Bit-equal to `gather_normalize_u8_plain`.

    The kernel does not check the indices: a caller that builds them
    validates them first (`train/loops.py:_upload`)."""
    _check_segments(segments, dtype)
    if segments[0].bank.device.type == "cpu":
        return gather_normalize_u8_plain(segments, dtype)
    for seg in segments:
        _build.require_cuda_tensor(seg.bank, "gather_normalize_u8")
        for t in (seg.idx, seg.labels):
            if t is not None:
                _build.require_cuda_tensor(t, "gather_normalize_u8")
    dev = segments[0].bank.device
    n = sum(seg.rows for seg in segments)
    h, w, c = segments[0].bank.shape[1:]
    out = torch.empty((n, h, w, c), dtype=dtype, device=dev)
    n_lab = sum(seg.rows for seg in segments if seg.labels is not None)
    labels = (torch.empty(n, dtype=torch.float32, device=dev)
              if segments[0].labels is not None else None)
    if out.numel() == 0:   # a grid of 0 blocks is an invalid launch
        if n_lab:
            raise ValueError("gather_normalize_u8: labels of empty frames")
        return out, labels
    desc = np.array([[seg.bank.data_ptr(),
                      0 if seg.idx is None else seg.idx.data_ptr(),
                      seg.rows, int(seg.shift),
                      0 if seg.labels is None else seg.labels.data_ptr()]
                     for seg in segments], dtype=np.int64)
    lib = _build.kernel("normalize_u8")
    err = lib.cgs_normalize_u8(
        desc.ctypes.data, len(segments), h, w, c, out.data_ptr(),
        0 if labels is None else labels.data_ptr(),
        int(dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(err, "normalize_u8")
    _build.launches["normalize_u8"] += 1
    return out, (None if labels is None else labels[:n_lab])


def normalize_u8(x_u8: torch.Tensor,
                 dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 tensor of any shape -> `x * float32(1/255)` rounded to
    `dtype` (float32 or bfloat16), same shape: the one-segment case of
    `gather_normalize_u8`. Bit-equal to `normalize_u8_plain`."""
    if x_u8.dtype != torch.uint8:
        raise ValueError(f"normalize_u8: expected uint8, got {x_u8.dtype}")
    if x_u8.device.type == "cuda":
        _build.require_cuda_tensor(x_u8, "normalize_u8")
    shape = x_u8.shape
    if x_u8.dim() != 4:    # as frames of one row each
        lead = x_u8.shape[0] if x_u8.dim() else 1
        x_u8 = x_u8.reshape(lead, 1, x_u8.numel() // max(lead, 1), 1)
    out, _ = gather_normalize_u8([Segment(x_u8)], dtype)
    return out.view(shape)


# ---------------------------------------------------------------------
# fused replace + inject merge and its gradient
# ---------------------------------------------------------------------
#
# Frames a, b are NCHW (N, C, H, W) float32 stored channels_last (the
# layout the critic takes); the mask z is (N, 1, H, W), one float per
# pixel, broadcast over the channels inside the kernel (the TPU kernel
# took it pre-broadcast, pallas_kernels.py:broadcast_mask).

def blend(x: torch.Tensor, y: torch.Tensor, z: torch.Tensor
          ) -> torch.Tensor:
    """x with its masked pixels taken from y: x(1 - z) + zy, in the
    kernel's order of operations. Both merges are this blend."""
    return x * (1.0 - z) + z * y


def merge_pair_plain(a: torch.Tensor, b: torch.Tensor, z: torch.Tensor
                     ) -> torch.Tensor:
    """replaced || injected (main.py:395,406), one (2N, C, H, W)
    batch."""
    return torch.cat([blend(a, b, z), blend(b, a, z)])


NEED_ALL = (True, True, True)


def merge_pair_bwd_plain(a, b, z, g, need: Sequence[bool] = NEED_ALL):
    """(da, db, dz): the merges' VJP for the gradient g of their joined
    (2N, C, H, W) output (gr its first N frames, gi the rest); an output
    that `need` does not ask for is None. dz is summed over the channels
    in the order ((d0 + d1) + d2)."""
    n = a.shape[0]
    gr, gi = g[:n], g[n:]
    da = db = dz = None
    if need[0] or need[1]:
        keep = 1.0 - z
        if need[0]:
            da = gr * keep + gi * z
        if need[1]:
            db = gr * z + gi * keep
    if need[2]:
        d = (gr - gi) * (b - a)
        dz = d[:, 0:1]
        for c in range(1, d.shape[1]):
            dz = dz + d[:, c:c + 1]
    return da, db, dz


def _check_merge_args(name: str, a, b, z, g=None) -> None:
    if a.dim() != 4 or a.shape != b.shape:
        raise ValueError(f"{name}: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} must be one (N, C, H, W) shape")
    n, c, h, w = a.shape
    if tuple(z.shape) != (n, 1, h, w):
        raise ValueError(f"{name}: z {tuple(z.shape)} must be "
                         f"{(n, 1, h, w)}")
    if g is not None and tuple(g.shape) != (2 * n, c, h, w):
        raise ValueError(f"{name}: gradient {tuple(g.shape)} must be the "
                         f"joined {(2 * n, c, h, w)}")
    for t in (a, b, z) + ((g,) if g is not None else ()):
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: expected float32, got {t.dtype}")
        if t.device != a.device:
            raise ValueError(f"{name}: tensors on different devices")


def _nchw_empty(like: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(like, memory_format=torch.channels_last)


def _grad_strides(g: torch.Tensor, name: str) -> Tuple[int, int, int]:
    """(n, c, pixel) element strides of a gradient dense in either
    memory format, which the kernel reads in place."""
    sn, sc = g.stride()[:2]
    if g.is_contiguous():
        return sn, sc, 1
    if g.is_contiguous(memory_format=torch.channels_last):
        return sn, sc, g.shape[1]
    raise ValueError(f"{name}: gradient is neither NCHW- nor "
                     "channels_last-dense")


def merge_pair(a: torch.Tensor, b: torch.Tensor, z: torch.Tensor
               ) -> torch.Tensor:
    """replaced || injected: one (2N, C, H, W) channels_last buffer,
    a(1-z) + zb in its first half and b(1-z) + za in its second, the
    batch the critic's fused pass reads. a and b may be halves of one
    such buffer. Bit-equal to `merge_pair_plain`."""
    _check_merge_args("merge_pair", a, b, z)
    if a.device.type == "cpu":
        return merge_pair_plain(a, b, z)
    for t in (a, b):
        _build.require_cuda_tensor(t, "merge_pair", torch.channels_last)
    _build.require_cuda_tensor(z, "merge_pair")
    n, c, h, w = a.shape
    out = torch.empty((2 * n, c, h, w), device=a.device,
                      memory_format=torch.channels_last)
    if a.numel() == 0:
        return out
    lib = _build.kernel("merge_pair")
    err = lib.cgs_merge_pair(a.data_ptr(), b.data_ptr(), z.data_ptr(),
                             out.data_ptr(), out[n:].data_ptr(), n * h * w,
                             c, _build.stream_ptr(a.device))
    _build.check(err, "merge_pair")
    _build.launches["merge_pair"] += 1
    return out


def merge_pair_bwd(a, b, z, g, need: Sequence[bool] = NEED_ALL):
    """(da, db, dz) for the gradient g of `merge_pair`'s joined (2N, C,
    H, W) output, as autograd hands it over: da and db channels_last
    like a, dz (N, 1, H, W) summed over the channels, and None for an
    output `need` does not ask for (`MergeBoth.backward` passes
    `ctx.needs_input_grad`; the masker step asks for dz alone). g may be
    NCHW- or channels_last-dense; the kernel reads either in place, the
    latter on its fast path. One launch writes only the outputs asked
    for. Bit-equal to `merge_pair_bwd_plain`."""
    _check_merge_args("merge_pair_bwd", a, b, z, g)
    need = tuple(bool(x) for x in need)
    if len(need) != 3:
        raise ValueError(f"merge_pair_bwd: need has 3 flags, got {need}")
    if a.device.type == "cpu":
        return merge_pair_bwd_plain(a, b, z, g, need)
    for t in (a, b):
        _build.require_cuda_tensor(t, "merge_pair_bwd", torch.channels_last)
    _build.require_cuda_tensor(z, "merge_pair_bwd")
    if g.device.type != "cuda":
        raise ValueError("merge_pair_bwd: expected a CUDA gradient")
    g_s = _grad_strides(g, "merge_pair_bwd")
    da = _nchw_empty(a) if need[0] else None
    db = _nchw_empty(a) if need[1] else None
    dz = (torch.empty_like(z, memory_format=torch.contiguous_format)
          if need[2] else None)
    n, c, h, w = a.shape
    if a.numel() == 0 or not any(need):
        return da, db, dz
    lib = _build.kernel("merge_pair")
    err = lib.cgs_merge_pair_bwd(
        a.data_ptr(), b.data_ptr(), z.data_ptr(), g.data_ptr(),
        *(0 if t is None else t.data_ptr() for t in (da, db, dz)),
        n, h * w, c, *g_s, _build.stream_ptr(a.device))
    _build.check(err, "merge_pair_bwd")
    _build.launches["merge_pair_bwd"] += 1
    return da, db, dz


# ---------------------------------------------------------------------
# fused threshold + IoU counts
# ---------------------------------------------------------------------

def _check_iou_args(masks: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    if masks.dtype != torch.float32:
        raise ValueError(f"threshold_iou: masks must be float32, got "
                         f"{masks.dtype}")
    if gt.dtype not in (torch.bool, torch.uint8):
        raise ValueError(f"threshold_iou: gt must be bool or uint8, got "
                         f"{gt.dtype}")
    if masks.shape != gt.shape:
        raise ValueError(f"threshold_iou: masks {tuple(masks.shape)} and "
                         f"gt {tuple(gt.shape)} differ in shape")
    if masks.device != gt.device:
        raise ValueError("threshold_iou: masks and gt on different "
                         "devices")
    return gt.view(torch.uint8) if gt.dtype == torch.bool else gt


def threshold_iou_plain(masks: torch.Tensor, gt: torch.Tensor,
                        thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
    hard = masks > thresh
    g = gt > 0
    return (hard & g).sum(), (hard | g).sum()


# csrc/threshold_iou.cu: kMaxBlocks, the per-block slots of its scratch
IOU_MAX_BLOCKS = 2048
# (device index, stream) -> the kernel's scratch on that stream
_iou_scratch: Dict[Tuple[int, int], torch.Tensor] = {}


def _iou_scratch_for(device: torch.device) -> Tuple[torch.Tensor, int]:
    """The kernel's scratch for the current stream of `device` (per-block
    partial counts and the last-block ticket), made and zeroed on the
    stream's first call, and the stream. The kernel leaves the ticket at
    0, but two launches that shared a scratch at once would mix their
    slots: calls on one stream run in order, and a call on another
    stream gets a scratch of its own."""
    stream = _build.stream_ptr(device)
    key = (device.index, stream)
    scratch = _iou_scratch.get(key)
    if scratch is None:
        scratch = _iou_scratch[key] = torch.zeros(
            2 * IOU_MAX_BLOCKS + 1, dtype=torch.int64, device=device)
    return scratch, stream


def threshold_iou(masks: torch.Tensor, gt: torch.Tensor,
                  thresh: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(inter, union) int64 0-dim tensors on the masks' device: counts
    of (masks > thresh) AND / OR (gt > 0). masks float32 and gt bool or
    uint8 of one shape, e.g. (N, H*W). On the card one kernel launch
    per call, which writes both counts (no fill, no second launch; the
    first call on a stream also zeroes that stream's scratch). Does not
    synchronise."""
    gt_u8 = _check_iou_args(masks, gt)
    if masks.device.type == "cpu":
        return threshold_iou_plain(masks, gt_u8, thresh)
    _build.require_cuda_tensor(masks, "threshold_iou")
    _build.require_cuda_tensor(gt_u8, "threshold_iou")
    scratch, stream = _iou_scratch_for(masks.device)
    counts = torch.empty(2, dtype=torch.int64, device=masks.device)
    lib = _build.kernel("threshold_iou")
    err = lib.cgs_threshold_iou(masks.data_ptr(), gt_u8.data_ptr(),
                                masks.numel(), float(thresh),
                                counts.data_ptr(), scratch.data_ptr(),
                                stream)
    _build.check(err, "threshold_iou")
    _build.launches["threshold_iou"] += 1
    return counts[0], counts[1]
