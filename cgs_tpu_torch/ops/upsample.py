"""Nearest-neighbour upsample into a channel concat, NHWC, and its
gradient: CUDA kernel wrappers, their plain PyTorch versions, and the
autograd `Function`s that join them.

Port of `cgs_tpu/ops/pallas_upsample.py:upsample2x_pallas` (forward:
`_up2_kernel`; backward: `_up2_bwd`, a 2x2 sum-pool) and of the jnp
path `cgs_tpu/models/decoder.py:upsample2x`, together with the concat
that follows every up-step of the decoder (`decoder.py:124-138`), which
XLA fused into the repeat. One kernel (`csrc/upsample2x.cu`:
`cgs_upsample2x`) writes `cat([skip, up_f(x)], channels)` for f = 2 or
4 into one fresh buffer, and its backward (`cgs_upsample2x_bwd`) reads
that buffer's gradient once and writes the skip's gradient and the f x f
sum-pool. The decoder's five skip joins are 5 launches per forward and
5 per backward. With `up_first=True` the same kernels join in the other
order, `cat([up_f(x), skip])`, the order of the model zoo's U-Nets
(`cgs_tpu/models/zoo.py:316-322,348-351,391-398`); the launch counters
keep their names. On a CUDA tensor each wrapper launches its kernel or
raises; on a CPU tensor it runs the plain version. The forward is an
exact copy and the backward sums in one fixed order, so kernel and
plain version are bit-identical.

`up_cat` and `upsample2x` are differentiable through `UpCat`. (A
kernel launched through ctypes into a fresh tensor has no `grad_fn`;
without the `Function` every gradient through the decoder's up-steps
would be dropped on the card.) `upsample2x` is the join with no skip
channels.

The decoder keeps its activations in `torch.channels_last`, so the NHWC
tensors the kernels take are `permute(0, 2, 3, 1)` views of NCHW
activations, with no copy; a tensor that is not channels_last-dense is
refused rather than copied. The gradient that arrives is the concat
buffer's, from cuDNN's dgrad, in either memory format; the backward
kernel reads it in place through its strides.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from cgs_tpu_torch.ops import _build

DTYPES = (torch.float32, torch.bfloat16)
LEVELS = {2: 1, 4: 2}     # upsample factor -> number of x2 steps


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, 1).repeat_interleave(2, 2)


def upsample2x_bwd_plain(g: torch.Tensor) -> torch.Tensor:
    """(B, 2H, 2W, C) -> (B, H, W, C) contiguous: the 2x2 sum
    (g00 + g01) + (g10 + g11), accumulated in f32 and, for bf16,
    rounded once at the end."""
    f = g.float()
    s = (f[:, 0::2, 0::2] + f[:, 0::2, 1::2]) + (f[:, 1::2, 0::2]
                                                 + f[:, 1::2, 1::2])
    return s.to(g.dtype).contiguous()


def upcat_plain(skip: Optional[torch.Tensor], x: torch.Tensor,
                factor: int = 2, up_first: bool = False) -> torch.Tensor:
    """NHWC `cat([skip, up_factor(x)], -1)` (with up_first,
    `cat([up_factor(x), skip], -1)`), the x4 as two x2 steps; skip None
    is the plain upsample."""
    for _ in range(LEVELS[factor]):
        x = upsample2x_plain(x)
    if skip is None:
        return x
    return torch.cat([x, skip] if up_first else [skip, x], -1)


def upcat_bwd_plain(g: torch.Tensor, cs: int, factor: int = 2,
                    need_skip: bool = True, up_first: bool = False
                    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The gradient of `upcat_plain` from the NHWC gradient g of its
    output: (the skip channels of g, contiguous, or None when not
    wanted; the sum-pool of the other channels, the x4 as two chained
    x2 sum-pools, each rounded to g's type). up_first: the skip's cs
    channels are g's last, not its first."""
    cu = g.shape[3] - cs
    skip_ch = slice(cu, None) if up_first else slice(0, cs)
    dskip = g[..., skip_ch].contiguous() if need_skip else None
    dx = g[..., :cu] if up_first else g[..., cs:]
    for _ in range(LEVELS[factor]):
        dx = upsample2x_bwd_plain(dx)
    return dskip, dx


def _check(x: torch.Tensor, name: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not in {DTYPES}")


def _check_factor(factor: int, name: str) -> None:
    if factor not in LEVELS:
        raise ValueError(f"{name}: factor {factor} not in {tuple(LEVELS)}")


def upcat_fwd(skip: Optional[torch.Tensor], x: torch.Tensor,
              factor: int = 2, up_first: bool = False) -> torch.Tensor:
    """The forward kernel's wrapper, not differentiable: skip (B, fH,
    fW, Cs) or None and x (B, H, W, Cu), contiguous NHWC, one dtype (f32
    or bf16), any C and W -> (B, fH, fW, Cs + Cu) contiguous, the skip's
    channels first unless `up_first`, bit-equal to `upcat_plain`."""
    _check_factor(factor, "upsample2x")
    for t in (x,) if skip is None else (skip, x):
        _check(t, "upsample2x")
        if not t.is_contiguous():
            # a strided NHWC view means the NCHW activation was not
            # channels_last: a silent layout copy the decoder must not make
            raise ValueError("upsample2x: expected a contiguous NHWC tensor "
                             "(an NCHW activation stored channels_last), got "
                             f"strides {t.stride()}")
    b, h, w, cu = x.shape
    cs = 0
    if skip is not None:
        cs = skip.shape[3]
        if (skip.shape[:3] != (b, factor * h, factor * w)
                or skip.dtype != x.dtype or skip.device != x.device):
            raise ValueError(
                f"upsample2x: skip {tuple(skip.shape)} {skip.dtype} does "
                f"not match x {tuple(x.shape)} {x.dtype} upsampled "
                f"x{factor}")
    if x.device.type == "cpu":
        return upcat_plain(skip, x, factor, up_first)
    _build.require_cuda_tensor(x, "upsample2x")
    out = torch.empty((b, factor * h, factor * w, cs + cu), dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    lib = _build.kernel("upsample2x")
    with torch.cuda.device(x.device):   # launch on the tensor's card
        err = lib.cgs_upsample2x(None if skip is None else skip.data_ptr(),
                                 x.data_ptr(), out.data_ptr(), b, h, w, cs, cu,
                                 factor, int(up_first), x.element_size(),
                                 _build.stream_ptr(x.device))
    _build.check(err, "upsample2x")
    _build.launches["upsample2x"] += 1
    return out


def upcat_bwd(g: torch.Tensor, cs: int, factor: int = 2,
              need_skip: bool = True, up_first: bool = False
              ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """The backward kernel's wrapper: g (B, fH, fW, Cs + Cu), any
    strides (either memory format of the concat buffer's gradient is
    read in place), the skip's channels first unless `up_first` ->
    (d_skip (B, fH, fW, Cs) contiguous, or None unless `need_skip`; dx
    (B, H, W, Cu) contiguous). Bit-equal to `upcat_bwd_plain`."""
    _check(g, "upsample2x_bwd")
    _check_factor(factor, "upsample2x_bwd")
    if g.shape[1] % factor or g.shape[2] % factor:
        raise ValueError(f"upsample2x_bwd: H and W of {tuple(g.shape)} "
                         f"must be multiples of {factor}")
    if not 0 <= cs <= g.shape[3]:
        raise ValueError(f"upsample2x_bwd: {cs} skip channels of "
                         f"{tuple(g.shape)}")
    if g.device.type == "cpu":
        return upcat_bwd_plain(g, cs, factor, need_skip, up_first)
    if g.device.type != "cuda":
        raise ValueError(f"upsample2x_bwd: expected a CUDA tensor, got "
                         f"{g.device}")
    b, fh, fw, ct = g.shape
    h, w = fh // factor, fw // factor
    dskip = (torch.empty((b, fh, fw, cs), dtype=g.dtype, device=g.device)
             if need_skip else None)
    dx = torch.empty((b, h, w, ct - cs), dtype=g.dtype, device=g.device)
    if g.numel() == 0:
        return dskip, dx
    lib = _build.kernel("upsample2x")
    with torch.cuda.device(g.device):   # launch on the tensor's card
        err = lib.cgs_upsample2x_bwd(
            g.data_ptr(), None if dskip is None else dskip.data_ptr(),
            dx.data_ptr(), b, h, w, cs, ct - cs, factor, int(up_first),
            *g.stride(),
            int(g.dtype == torch.bfloat16), _build.stream_ptr(g.device))
    _build.check(err, "upsample2x_bwd")
    _build.launches["upsample2x_bwd"] += 1
    return dskip, dx


def upsample2x_bwd(g: torch.Tensor) -> torch.Tensor:
    """The backward kernel with no skip: (B, 2H, 2W, C) gradient, any
    strides -> (B, H, W, C) contiguous. Bit-equal to
    `upsample2x_bwd_plain`."""
    return upcat_bwd(g, 0, need_skip=False)[1]


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Differentiable (B, H, W, C) contiguous NHWC -> (B, 2H, 2W, C),
    f32 or bf16: `UpCat` with no skip, the forward kernel and the
    sum-pool kernel as its backward."""
    return UpCat.apply(None, x, 2, False)


class UpCat(torch.autograd.Function):
    """`upcat_fwd` with `upcat_bwd` as its gradient (NHWC); the skip's
    gradient is written only when autograd asks for it. skip None is the
    plain upsample by `factor`."""

    @staticmethod
    def forward(ctx, skip, x, factor, up_first):
        ctx.cs = 0 if skip is None else skip.shape[3]
        ctx.factor, ctx.up_first = factor, up_first
        return upcat_fwd(skip, x, factor, up_first)

    @staticmethod
    def backward(ctx, g):
        dskip, dx = upcat_bwd(g, ctx.cs, ctx.factor,
                              need_skip=ctx.needs_input_grad[0],
                              up_first=ctx.up_first)
        return dskip, dx, None, None


def up_cat(skip: Optional[torch.Tensor], x: torch.Tensor,
           factor: int = 2, up_first: bool = False) -> torch.Tensor:
    """One skip join, differentiable: skip (B, Cs, fH, fW) or None and
    x (B, Cu, H, W), NCHW stored channels_last, one dtype ->
    `cat([skip, upsample_factor(x)], dim=1)`, or with up_first
    `cat([upsample_factor(x), skip], dim=1)` (the zoo U-Nets' order),
    (B, Cs + Cu, fH, fW), NCHW stored channels_last; skip None gives the
    upsample alone. One kernel launch forward, one backward."""
    nhwc = None if skip is None else skip.permute(0, 2, 3, 1)
    return UpCat.apply(nhwc, x.permute(0, 2, 3, 1), factor,
                       up_first).permute(0, 3, 1, 2)
