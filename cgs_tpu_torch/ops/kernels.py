"""The uint8 ingest (gather by index, roll, normalise), the fused
counterfactual merges and their gradient, the fused threshold+IoU
count, the convolution epilogue (bias, activation, 2x2 max-pool), the
mask head after its first convolution and the whole mask head: CUDA
kernel wrappers and their plain PyTorch versions.

Ports of `cgs_tpu/ops/pallas_kernels.py:normalize_u8` (with the
gather, concatenation and roll a JAX train step fuses around it),
`:merge_pair`, `:merge_pair_bwd` and `:threshold_iou`; the epilogue
and the mask heads replace no Pallas kernel (XLA fused them into the
convolutions on the TPU). On a CUDA tensor each wrapper launches its
kernel (`csrc/normalize_u8.cu`, `csrc/merge_pair.cu`,
`csrc/threshold_iou.cu`, `csrc/conv_epilogue.cu`, `csrc/mask_head.cu`,
`csrc/conv_mask_head.cu`) or raises; on a CPU tensor it runs the plain
version, which is also the oracle the kernel is held against on the
card. There is no fallback from the kernel to the plain version.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from cgs_tpu_torch.ops import _build

# float32(1/255) == 0x3B808081: the JAX kernel and plain path multiply
# by it (pallas_kernels.py:67, pipeline.py:338); x / 255 rounds
# differently for many byte values
INV255 = float(np.float32(1.0 / 255.0))


# ---------------------------------------------------------------------
# uint8 ingest: gather by index, roll along W, normalise
# ---------------------------------------------------------------------

MAX_SEGMENTS = 3        # csrc/normalize_u8.cu: kMaxSeg
MAX_SEEDS = 64          # csrc/normalize_u8.cu: kMaxSeeds
INGEST_DTYPES = (torch.float32, torch.bfloat16)


class Segment(NamedTuple):
    """Frames for `gather_normalize_u8`: rows `idx` of `bank` (all of
    its rows, in order, when idx is None), rolled by `shift` pixels
    along W (`torch.roll`'s sign, any integer), with their `labels`
    gathered beside them when labels (one float32 per bank row) are
    given.

    For R seeds at once, idx is (R, n), row r naming seed r's frames,
    and shift is one int for all seeds or a sequence of R ints, seed
    r's roll."""
    bank: torch.Tensor                      # (M, H, W, C) uint8
    idx: Optional[torch.Tensor] = None      # (n,) or (R, n) int64 in [0, M)
    shift: Union[int, Sequence[int]] = 0
    labels: Optional[torch.Tensor] = None   # (M,) float32

    @property
    def seeds(self) -> int:
        return 1 if self.idx is None or self.idx.dim() == 1 \
            else self.idx.shape[0]

    @property
    def rows(self) -> int:
        """Frames over all seeds."""
        return self.bank.shape[0] if self.idx is None else self.idx.numel()

    def shifts(self) -> List[int]:
        """Each seed's roll."""
        if isinstance(self.shift, (int, np.integer)):
            return [int(self.shift)] * self.seeds
        return [int(s) for s in self.shift]

    def per_seed(self) -> List["Segment"]:
        """One single-seed segment per seed, in seed order."""
        if self.idx is None or self.idx.dim() == 1:
            return [self._replace(shift=self.shifts()[0])]
        return [self._replace(idx=i, shift=s)
                for i, s in zip(self.idx, self.shifts())]


def normalize_u8_plain(x_u8: torch.Tensor,
                       dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (x_u8.to(torch.float32) * INV255).to(dtype)


def gather_normalize_u8_plain(segments: Sequence[Segment],
                              dtype: torch.dtype = torch.float32, out=None):
    """The kernel's function in plain PyTorch: per segment and seed,
    index_select and roll; then cat and normalise. For R seeds this is
    the R single-seed calls' pieces, segment by segment. out: as
    `gather_normalize_u8`'s, copied into."""
    frames, labels = [], []
    for seg in (one for s in segments for one in s.per_seed()):
        x = seg.bank if seg.idx is None else seg.bank.index_select(0,
                                                                   seg.idx)
        frames.append(torch.roll(x, int(seg.shift), dims=2))
        if seg.labels is not None:
            labels.append(seg.labels if seg.idx is None
                          else seg.labels.index_select(0, seg.idx))
    x = normalize_u8_plain(torch.cat(frames), dtype)
    y = torch.cat(labels) if labels else None
    if out is None:
        return x, y
    out[0].copy_(x)
    if y is not None:
        out[1].copy_(y)
    return out


def _check_segments(segments: Sequence[Segment], dtype) -> None:
    name = "gather_normalize_u8"
    if not 1 <= len(segments) <= MAX_SEGMENTS:
        raise ValueError(f"{name}: 1 to {MAX_SEGMENTS} segments, got "
                         f"{len(segments)}")
    if dtype not in INGEST_DTYPES:
        raise ValueError(f"{name}: dtype {dtype} not in {INGEST_DTYPES}")
    frame, dev = segments[0].bank.shape[1:], segments[0].bank.device
    seeds = segments[0].seeds
    labelled = [seg.labels is not None for seg in segments]
    if labelled != sorted(labelled, reverse=True):
        raise ValueError(f"{name}: the segments with labels must come "
                         "first")
    if not 1 <= seeds <= MAX_SEEDS:
        raise ValueError(f"{name}: 1 to {MAX_SEEDS} seeds, got {seeds}")
    for seg in segments:
        b = seg.bank
        if b.dtype != torch.uint8 or b.dim() != 4:
            raise ValueError(f"{name}: a bank must be uint8 (M, H, W, C), "
                             f"got {b.dtype} {tuple(b.shape)}")
        if b.shape[1:] != frame or b.device != dev:
            raise ValueError(f"{name}: banks differ in frame shape or "
                             "device")
        if seg.idx is not None and (seg.idx.dtype != torch.int64
                                    or seg.idx.dim() not in (1, 2)
                                    or seg.idx.device != dev):
            raise ValueError(f"{name}: idx must be (n,) or (R, n) int64 on "
                             "the banks' device")
        if seg.seeds != seeds or (seeds > 1 and seg.idx.dim() != 2):
            raise ValueError(f"{name}: every segment must name index rows "
                             f"for the same {seeds} seeds")
        if len(seg.shifts()) != seeds:
            raise ValueError(f"{name}: {len(seg.shifts())} shifts for "
                             f"{seeds} seeds")
        if seg.labels is not None and (
                seg.labels.dtype != torch.float32
                or tuple(seg.labels.shape) != (b.shape[0],)
                or seg.labels.device != dev):
            raise ValueError(f"{name}: labels must be float32 "
                             f"({b.shape[0]},) on the banks' device")


def _check_out(segments: Sequence[Segment], dtype, out):
    """The (frames, labels) buffers an `out=` call writes: frames a
    contiguous (sum rows, H, W, C) tensor of `dtype` on the banks'
    device, labels a contiguous float32 (labelled rows,) tensor there,
    or None exactly when no segment has labels."""
    name = "gather_normalize_u8"
    frames, labels = out
    dev = segments[0].bank.device
    n = sum(seg.rows for seg in segments)
    n_lab = sum(seg.rows for seg in segments if seg.labels is not None)
    shape = (n, *segments[0].bank.shape[1:])
    if (tuple(frames.shape) != shape or frames.dtype != dtype
            or frames.device != dev or not frames.is_contiguous()):
        raise ValueError(f"{name}: out frames must be a contiguous {dtype} "
                         f"{shape} tensor on {dev}, got {frames.dtype} "
                         f"{tuple(frames.shape)} on {frames.device}")
    if (labels is None) != (segments[0].labels is None):
        raise ValueError(f"{name}: out labels must be given with labelled "
                         "segments, and only with them")
    if labels is not None and (
            tuple(labels.shape) != (n_lab,) or labels.dtype != torch.float32
            or labels.device != dev or not labels.is_contiguous()):
        raise ValueError(f"{name}: out labels must be a contiguous float32 "
                         f"({n_lab},) tensor on {dev}, got {labels.dtype} "
                         f"{tuple(labels.shape)} on {labels.device}")


def gather_normalize_u8(segments: Sequence[Segment],
                        dtype: torch.dtype = torch.float32, out=None):
    """(frames, labels): the segments' frames gathered, rolled and
    normalised (`x * float32(1/255)`, then rounded to `dtype`), laid end
    to end in one (sum rows, H, W, C) buffer, and the labels of the
    labelled segments, which come first, or None. With R seeds each
    segment holds its seeds' frames end to end (segment-major, seed-major
    within a segment), each seed rolled by its own shift. One kernel
    launch on the card, whatever R is. Bit-equal to
    `gather_normalize_u8_plain`.

    out: (frames, labels) buffers to write instead of fresh ones
    (`_check_out`), returned as they are: the captured masker step's
    static inputs (`train/graph.py`).

    The kernel does not check the indices: a caller that builds them
    validates them first (`train/loops.py:_upload`)."""
    _check_segments(segments, dtype)
    if out is not None:
        _check_out(segments, dtype, out)
    if segments[0].bank.device.type == "cpu":
        return gather_normalize_u8_plain(segments, dtype, out)
    for seg in segments:
        _build.require_cuda_tensor(seg.bank, "gather_normalize_u8")
        for t in (seg.idx, seg.labels):
            if t is not None:
                _build.require_cuda_tensor(t, "gather_normalize_u8")
    dev = segments[0].bank.device
    seeds = segments[0].seeds
    n = sum(seg.rows for seg in segments)
    h, w, c = segments[0].bank.shape[1:]
    n_lab = sum(seg.rows for seg in segments if seg.labels is not None)
    if out is not None:
        frames, labels = out
    else:
        frames = torch.empty((n, h, w, c), dtype=dtype, device=dev)
        labels = (torch.empty(n_lab, dtype=torch.float32, device=dev)
                  if segments[0].labels is not None else None)
    if frames.numel() == 0:   # a grid of 0 blocks is an invalid launch
        if n_lab:
            raise ValueError("gather_normalize_u8: labels of empty frames")
        return frames, labels
    desc = np.array([[seg.bank.data_ptr(),
                      0 if seg.idx is None else seg.idx.data_ptr(),
                      seg.rows // seeds,
                      0 if seg.labels is None else seg.labels.data_ptr()]
                     for seg in segments], dtype=np.int64)
    shifts = np.array([seg.shifts() for seg in segments],
                      dtype=np.int64).T.copy()          # (R, segments)
    lib = _build.kernel("normalize_u8")
    with torch.cuda.device(dev):   # launch on the tensor's card
        err = lib.cgs_normalize_u8(
            desc.ctypes.data, len(segments), seeds, shifts.ctypes.data, h, w,
            c, frames.data_ptr(), 0 if labels is None else labels.data_ptr(),
            int(dtype == torch.bfloat16), _build.stream_ptr(dev))
    _build.check(err, "normalize_u8")
    _build.launches["normalize_u8"] += 1
    return frames, labels


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
    with torch.cuda.device(a.device):   # launch on the tensor's card
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
    with torch.cuda.device(a.device):   # launch on the tensor's card
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
    with torch.cuda.device(masks.device):   # launch on the tensor's card
        err = lib.cgs_threshold_iou(masks.data_ptr(), gt_u8.data_ptr(),
                                    masks.numel(), float(thresh),
                                    counts.data_ptr(), scratch.data_ptr(),
                                    stream)
    _build.check(err, "threshold_iou")
    _build.launches["threshold_iou"] += 1
    return counts[0], counts[1]


# ---------------------------------------------------------------------
# convolution epilogue: bias, activation, 2x2 max-pool
# ---------------------------------------------------------------------

ACTS = ("none", "relu", "leaky_relu", "sigmoid")  # csrc/conv_epilogue.cu: Act
EPILOGUE_DTYPES = (torch.float32, torch.bfloat16)


def bias_act_pool_plain(y: torch.Tensor, bias: torch.Tensor,
                        act: str = "none", pool: int = 1,
                        slope: float = 0.01, out_dtype=None) -> torch.Tensor:
    """The eager chain the kernel replaces, on NHWC y: `y + bias` in y's
    type (the add after cuDNN), cast to `out_dtype`, the activation, and
    with pool 2 the 2x2 max-pool; NHWC, contiguous."""
    s = (y + bias).to(out_dtype or y.dtype)
    if act == "relu":
        s = torch.relu(s)
    elif act == "leaky_relu":
        s = F.leaky_relu(s, slope)
    elif act == "sigmoid":
        s = torch.sigmoid(s)
    if pool == 2:
        s = F.max_pool2d(s.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
    return s.contiguous()


def _check_epilogue(y, bias, act, pool, out_dtype) -> None:
    name = "bias_act_pool"
    if y.dim() != 4 or y.dtype not in EPILOGUE_DTYPES:
        raise ValueError(f"{name}: expected an f32 or bf16 (N, H, W, C) "
                         f"tensor, got {y.dtype} {tuple(y.shape)}")
    if (tuple(bias.shape) != (y.shape[3],) or bias.dtype != y.dtype
            or bias.device != y.device):
        raise ValueError(f"{name}: bias must be ({y.shape[3]},) {y.dtype} "
                         f"on {y.device}, got {bias.dtype} "
                         f"{tuple(bias.shape)} on {bias.device}")
    if act not in ACTS:
        raise ValueError(f"{name}: act {act!r} not in {ACTS}")
    if pool not in (1, 2) or (pool == 2 and (y.shape[1] % 2
                                             or y.shape[2] % 2)):
        raise ValueError(f"{name}: pool {pool} of {tuple(y.shape)}: 1, or "
                         "2 over an even H and W")
    if out_dtype not in (y.dtype, torch.float32):
        raise ValueError(f"{name}: output {out_dtype} of a {y.dtype} input: "
                         "the input's type or float32")


def bias_act_pool(y: torch.Tensor, bias: torch.Tensor, act: str = "none",
                  pool: int = 1, slope: float = 0.01,
                  out_dtype=None) -> torch.Tensor:
    """One convolution's epilogue: y (N, H, W, C), the NHWC view of a
    channels_last convolution output made without its bias, f32 or
    bf16; bias (C,) in y's type -> act(y + bias) with pool 2 its 2x2
    max, (N, H/pool, W/pool, C) contiguous in `out_dtype` (y's type, or
    float32). act: "none", "relu", "leaky_relu" (of `slope`) or
    "sigmoid". One launch on the card, reading y once and writing only
    the output. Bit-equal to `bias_act_pool_plain`, and so to PyTorch's
    own bias add, activation and pool."""
    out_dtype = out_dtype or y.dtype
    _check_epilogue(y, bias, act, pool, out_dtype)
    if y.device.type == "cpu":
        return bias_act_pool_plain(y, bias, act, pool, slope, out_dtype)
    if y.device.type != "cuda" or not y.is_contiguous():
        # a strided NHWC view: the convolution output was not
        # channels_last, and a copy here would cost what the kernel saves
        raise ValueError("bias_act_pool: expected a contiguous NHWC CUDA "
                         "tensor (a convolution output stored "
                         f"channels_last), got {y.device} strides "
                         f"{y.stride()}")
    _build.require_cuda_tensor(bias, "bias_act_pool")
    n, h, w, c = y.shape
    out = torch.empty((n, h // pool, w // pool, c), dtype=out_dtype,
                      device=y.device)
    if out.numel() == 0:
        return out
    lib = _build.kernel("conv_epilogue")
    with torch.cuda.device(y.device):   # launch on the tensor's card
        err = lib.cgs_bias_act_pool(
            y.data_ptr(), bias.data_ptr(), out.data_ptr(), n, h, w, c,
            ACTS.index(act), pool, float(slope),
            int(y.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16),
            _build.stream_ptr(y.device))
    _build.check(err, "bias_act_pool")
    _build.launches["bias_act_pool"] += 1
    return out


# ---------------------------------------------------------------------
# the mask head after its first convolution: LeakyReLU, the C -> 1 3x3
# convolution, its bias and the sigmoid
# ---------------------------------------------------------------------

MASK_HEAD_MAX_C = 64    # csrc/mask_head.cu: kMaxC


def mask_head_takes(dtype: torch.dtype, c: int) -> bool:
    """Whether `mask_head` takes a first convolution's output of this
    type and channel count."""
    return dtype in EPILOGUE_DTYPES and 1 <= c <= MASK_HEAD_MAX_C


def mask_head_plain(y0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor,
                    b2: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """The eager chain the kernel replaces, on NHWC y0: the LeakyReLU
    epilogue, the convolution of its output without the bias, then the
    sigmoid epilogue to float32; (N, H, W). On float64 tensors, the head
    in float64 throughout: the yardstick the kernel is held to."""
    h = bias_act_pool_plain(y0, b0, "leaky_relu", 1, slope)
    z = F.conv2d(h.permute(0, 3, 1, 2), w2, None, 1, 1)
    mask = bias_act_pool_plain(z.permute(0, 2, 3, 1), b2, "sigmoid", 1,
                               out_dtype=torch.promote_types(
                                   y0.dtype, torch.float32))
    return mask.view(mask.shape[:3])


def _check_mask_head(y0, b0, w2, b2) -> None:
    name = "mask_head"
    if y0.dim() != 4 or not mask_head_takes(y0.dtype, y0.shape[3]):
        raise ValueError(f"{name}: expected an f32 or bf16 (N, H, W, C) "
                         f"tensor with 1 <= C <= {MASK_HEAD_MAX_C}, got "
                         f"{y0.dtype} {tuple(y0.shape)}")
    c = y0.shape[3]
    for t, shape, what in ((b0, (c,), "b0"), (w2, (1, c, 3, 3), "w2"),
                           (b2, (1,), "b2")):
        if (tuple(t.shape) != shape or t.dtype != y0.dtype
                or t.device != y0.device):
            raise ValueError(f"{name}: {what} must be {shape} {y0.dtype} "
                             f"on {y0.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def mask_head(y0: torch.Tensor, b0: torch.Tensor, w2: torch.Tensor,
              b2: torch.Tensor, slope: float = 0.01) -> torch.Tensor:
    """The mask head after its first convolution: y0 (N, H, W, C), the
    NHWC view of that convolution's channels_last output made without
    its bias, f32 or bf16, C <= MASK_HEAD_MAX_C; b0 (C,) its bias, w2
    (1, C, 3, 3) and b2 (1,) the last convolution's (padding 1), all in
    y0's type -> sigmoid(conv3x3(leaky_relu(y0 + b0), w2) + b2), (N, H,
    W) float32, which is the (N, 1, H, W) mask. One launch on the card,
    reading y0 once. The products are summed in another order than
    cuDNN's, so the mask is close to `mask_head_plain`'s, not bit-equal;
    the rounding to y0's type is the chain's."""
    _check_mask_head(y0, b0, w2, b2)
    if y0.device.type == "cpu":
        return mask_head_plain(y0, b0, w2, b2, slope)
    if y0.device.type != "cuda" or not y0.is_contiguous():
        raise ValueError("mask_head: expected a contiguous NHWC CUDA "
                         "tensor (a convolution output stored "
                         f"channels_last), got {y0.device} strides "
                         f"{y0.stride()}")
    for t in (b0, b2):
        _build.require_cuda_tensor(t, "mask_head")
    n, h, w, c = y0.shape
    out = torch.empty((n, h, w), dtype=torch.float32, device=y0.device)
    if out.numel() == 0:
        return out
    lib = _build.kernel("mask_head")
    with torch.cuda.device(y0.device):   # launch on the tensor's card
        err = lib.cgs_mask_head(
            y0.data_ptr(), b0.data_ptr(), w2.data_ptr(), *w2.stride()[1:],
            b2.data_ptr(), out.data_ptr(), n, h, w, c, float(slope),
            int(y0.dtype == torch.bfloat16), _build.stream_ptr(y0.device))
    _build.check(err, "mask_head")
    _build.launches["mask_head"] += 1
    return out


# ---------------------------------------------------------------------
# the whole mask head: the C -> 16 3x3 convolution, then as above
# ---------------------------------------------------------------------

CONV_MASK_HEAD_MID = 16     # csrc/conv_mask_head.cu: kMid
CONV_MASK_HEAD_W = 64       # ... kW, the frame's width
CONV_MASK_HEAD_MAX_C = 128  # ... kMaxC


def conv_mask_head_takes(dtype: torch.dtype, c: int, mid: int,
                         w: int) -> bool:
    """Whether `conv_mask_head` takes a head of C input and `mid` middle
    channels on frames `w` wide, in this type."""
    return (dtype == torch.float32 and 1 <= c <= CONV_MASK_HEAD_MAX_C
            and mid == CONV_MASK_HEAD_MID and w == CONV_MASK_HEAD_W)


def conv_mask_head_plain(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                         w2: torch.Tensor, b2: torch.Tensor,
                         slope: float = 0.01) -> torch.Tensor:
    """The chain the kernel replaces, on NHWC x: the first convolution
    without its bias, then `mask_head_plain`; (N, H, W). On float64
    tensors, the head in float64 throughout."""
    y0 = F.conv2d(x.permute(0, 3, 1, 2), w0, None, 1, 1)
    return mask_head_plain(y0.permute(0, 2, 3, 1), b0, w2, b2, slope)


def _check_conv_mask_head(x, w0, b0, w2, b2) -> None:
    name = "conv_mask_head"
    if x.dim() != 4:
        raise ValueError(f"{name}: expected an (N, H, W, C) tensor, got "
                         f"{tuple(x.shape)}")
    c, w = x.shape[3], x.shape[2]
    if not conv_mask_head_takes(x.dtype, c, CONV_MASK_HEAD_MID, w):
        raise ValueError(f"{name}: expected an f32 (N, H, "
                         f"{CONV_MASK_HEAD_W}, C) tensor with 1 <= C <= "
                         f"{CONV_MASK_HEAD_MAX_C}, got {x.dtype} "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        # a strided view: the join was not channels_last, and a copy here
        # would cost what the kernel saves
        raise ValueError(f"{name}: expected a contiguous NHWC tensor (a "
                         f"join stored channels_last), got strides "
                         f"{x.stride()}")
    mid = CONV_MASK_HEAD_MID
    for t, shape, what in ((w0, (mid, c, 3, 3), "w0"), (b0, (mid,), "b0"),
                           (w2, (1, mid, 3, 3), "w2"), (b2, (1,), "b2")):
        if (tuple(t.shape) != shape or t.dtype != x.dtype
                or t.device != x.device):
            raise ValueError(f"{name}: {what} must be {shape} {x.dtype} "
                             f"on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def conv_mask_head(x: torch.Tensor, w0: torch.Tensor, b0: torch.Tensor,
                   w2: torch.Tensor, b2: torch.Tensor,
                   slope: float = 0.01) -> torch.Tensor:
    """The decoder's whole mask head: x (N, H, 64, C), the NHWC view of
    the last skip join stored channels_last, f32, C <=
    CONV_MASK_HEAD_MAX_C; w0 (16, C, 3, 3) and b0 (16,) the first
    convolution's, w2 (1, 16, 3, 3) and b2 (1,) the last one's (padding
    1 each) -> sigmoid(conv3x3(leaky_relu(conv3x3(x, w0) + b0), w2) +
    b2), (N, H, 64) float32, which is the (N, 1, H, 64) mask. One launch
    on the card, reading x once; the first convolution's output never
    reaches device memory. The sums run in another order than cuDNN's,
    so the mask is close to `conv_mask_head_plain`'s, not bit-equal."""
    _check_conv_mask_head(x, w0, b0, w2, b2)
    if x.device.type == "cpu":
        return conv_mask_head_plain(x, w0, b0, w2, b2, slope)
    for t in (x, b0, b2):
        _build.require_cuda_tensor(t, "conv_mask_head")
    n, h, w, c = x.shape
    out = torch.empty((n, h, w), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.kernel("conv_mask_head")
    with torch.cuda.device(x.device):   # launch on the tensor's card
        # masker.0's weight with the output channel last, so that a chunk
        # of input channels is one contiguous piece (a copy of 144 C
        # floats)
        wt = w0.permute(1, 2, 3, 0).contiguous()
        err = lib.cgs_conv_mask_head(
            x.data_ptr(), wt.data_ptr(), b0.data_ptr(), w2.data_ptr(),
            *w2.stride()[1:], b2.data_ptr(), out.data_ptr(), n, h, w, c,
            float(slope), _build.stream_ptr(x.device))
    _build.check(err, "conv_mask_head")
    _build.launches["conv_mask_head"] += 1
    return out
