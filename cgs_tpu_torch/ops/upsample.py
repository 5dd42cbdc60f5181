"""Nearest-neighbour x2 upsample, NHWC, and its gradient: CUDA kernel
wrappers, their plain PyTorch versions, and the autograd `Function`
that joins them.

Port of `cgs_tpu/ops/pallas_upsample.py:upsample2x_pallas` (forward:
`_up2_kernel`; backward: `_up2_bwd`, a 2x2 sum-pool) and of the jnp
path `cgs_tpu/models/decoder.py:upsample2x`. The decoder runs it 6
times per forward, and a masker train step differentiates all 6. On a
CUDA tensor each wrapper launches its kernel (`csrc/upsample2x.cu`:
`cgs_upsample2x`, `cgs_upsample2x_bwd`) or raises; on a CPU tensor it
runs the plain version. The forward is an exact copy and the backward
sums in one fixed order, so kernel and plain version are bit-identical.

`upsample2x` is differentiable: its backward is the sum-pool kernel.
(A kernel launched through ctypes into a fresh tensor has no
`grad_fn`; without the `Function` every gradient through the decoder's
up-steps would be dropped on the card.)

The decoder keeps its activations in `torch.channels_last`, so the
NHWC tensor the forward takes is a `permute(0, 2, 3, 1)` view of an
NCHW activation, with no copy. The gradient that arrives is a channel
slice of the gradient of the decoder's next `torch.cat`, a strided
view; the backward kernel reads it in place through its strides.
"""

from __future__ import annotations

import torch

from cgs_tpu_torch.ops import _build

DTYPES = (torch.float32, torch.bfloat16)


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


def _check(x: torch.Tensor, name: str) -> None:
    if x.dim() != 4:
        raise ValueError(f"{name}: expected (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"{name}: dtype {x.dtype} not in {DTYPES}")


def upsample2x_fwd(x: torch.Tensor) -> torch.Tensor:
    """The forward kernel's wrapper, not differentiable: (B, H, W, C)
    contiguous NHWC -> (B, 2H, 2W, C), f32 or bf16, any C and W."""
    _check(x, "upsample2x")
    if not x.is_contiguous():
        # a strided NHWC view means the NCHW activation was not
        # channels_last: a silent layout copy the decoder must not make
        raise ValueError("upsample2x: expected a contiguous NHWC tensor")
    if x.device.type == "cpu":
        return upsample2x_plain(x)
    _build.require_cuda_tensor(x, "upsample2x")
    b, h, w, c = x.shape
    out = torch.empty((b, 2 * h, 2 * w, c), dtype=x.dtype, device=x.device)
    if x.numel() == 0:
        return out
    lib = _build.kernel("upsample2x")
    err = lib.cgs_upsample2x(x.data_ptr(), out.data_ptr(), b, h, w,
                             c * x.element_size(),
                             _build.stream_ptr(x.device))
    _build.check(err, "upsample2x")
    _build.launches["upsample2x"] += 1
    return out


def upsample2x_bwd(g: torch.Tensor) -> torch.Tensor:
    """The backward kernel's wrapper: (B, 2H, 2W, C) gradient, any
    strides (a channel slice of a concat's gradient is read in place)
    -> (B, H, W, C) contiguous. Bit-equal to `upsample2x_bwd_plain`."""
    _check(g, "upsample2x_bwd")
    if g.shape[1] % 2 or g.shape[2] % 2:
        raise ValueError(f"upsample2x_bwd: H and W of {tuple(g.shape)} "
                         "must be even")
    if g.device.type == "cpu":
        return upsample2x_bwd_plain(g)
    if g.device.type != "cuda":
        raise ValueError(f"upsample2x_bwd: expected a CUDA tensor, got "
                         f"{g.device}")
    b, h2, w2, c = g.shape
    dx = torch.empty((b, h2 // 2, w2 // 2, c), dtype=g.dtype,
                     device=g.device)
    if dx.numel() == 0:
        return dx
    lib = _build.kernel("upsample2x")
    err = lib.cgs_upsample2x_bwd(g.data_ptr(), dx.data_ptr(), b, h2 // 2,
                                 w2 // 2, c, *g.stride(),
                                 int(g.dtype == torch.bfloat16),
                                 _build.stream_ptr(g.device))
    _build.check(err, "upsample2x_bwd")
    _build.launches["upsample2x_bwd"] += 1
    return dx


class Upsample2x(torch.autograd.Function):
    """`upsample2x_fwd` with `upsample2x_bwd` as its gradient."""

    @staticmethod
    def forward(ctx, x):
        return upsample2x_fwd(x)

    @staticmethod
    def backward(ctx, g):
        return upsample2x_bwd(g)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Differentiable (B, H, W, C) contiguous NHWC -> (B, 2H, 2W, C),
    f32 or bf16: the forward kernel, and the sum-pool kernel as its
    backward."""
    return Upsample2x.apply(x)
