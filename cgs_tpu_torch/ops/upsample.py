"""Nearest-neighbour x2 upsample, NHWC: the CUDA kernel wrapper and its
plain PyTorch version.

Port of `cgs_tpu/ops/pallas_upsample.py:upsample2x_pallas` and of the
jnp path `cgs_tpu/models/decoder.py:upsample2x`. The decoder runs it 6
times per forward. On a CUDA tensor the wrapper launches
`csrc/upsample2x.cu` or raises; on a CPU tensor it runs the plain
version. Both are exact copies, so they are bit-identical.

The decoder keeps its activations in `torch.channels_last`, so the
NHWC tensor this takes is a `permute(0, 2, 3, 1)` view of an NCHW
activation, with no copy. The backward (a 2x2 sum-pool, the TPU
version's `_up2_bwd`) waits for the training slice (ROADMAP.md).
"""

from __future__ import annotations

import torch

from cgs_tpu_torch.ops import _build

DTYPES = (torch.float32, torch.bfloat16)


def upsample2x_plain(x: torch.Tensor) -> torch.Tensor:
    return x.repeat_interleave(2, 1).repeat_interleave(2, 2)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """(B, H, W, C) contiguous NHWC -> (B, 2H, 2W, C), f32 or bf16,
    any C and W."""
    if x.dim() != 4:
        raise ValueError(f"upsample2x: expected (B, H, W, C), got "
                         f"{tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise ValueError(f"upsample2x: dtype {x.dtype} not in {DTYPES}")
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
