"""Horizontal circular shift augmentation (PyTorch port of
`cgs_tpu/ops/augment.py:20-30`; reference main.py:584-591).

The reference draws `xshift = int(shift * U[0,1])` and rolls the width
axis left or right with probability 1/2, one draw for the whole batch.
`shift_batch` draws that signed offset from a `torch.Generator` (a CPU
generator, so the draw needs no device sync) and `shift_batch_by`
applies an explicit one; the parity tests use the latter, because
torch cannot replay `jax.random`. `gaussian_blur` is the sandbox
loader's `-blur` (`cgs_tpu/ops/augment.py:gaussian_blur`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def shift_batch_by(x: torch.Tensor, offset: int) -> torch.Tensor:
    """Roll the (B, H, W, C) batch by `offset` pixels along W
    (`jnp.roll(x, offset, axis=2)`)."""
    return torch.roll(x, shifts=int(offset), dims=2)


def draw_shift(max_shift: int, generator: torch.Generator) -> int:
    """One signed offset: floor(max_shift * U) with a random sign."""
    u = torch.rand(2, generator=generator, device=generator.device)
    u1, u2 = (float(v) for v in u)
    xshift = int(math.floor(max_shift * u1))
    return -xshift if u2 > 0.5 else xshift


def shift_batch(x: torch.Tensor, max_shift: int,
                generator: torch.Generator) -> torch.Tensor:
    """Roll the whole batch by one random horizontal offset."""
    return shift_batch_by(x, draw_shift(max_shift, generator))


_BLUR3 = np.asarray([[1, 2, 1], [2, 4, 2], [1, 2, 1]], np.float32) / 16.0
_BLUR5 = np.asarray([[1, 4, 6, 4, 1], [4, 16, 24, 16, 4],
                     [6, 24, 36, 24, 6], [4, 16, 24, 16, 4],
                     [1, 4, 6, 4, 1]], np.float32) / 256.0


def gaussian_blur(x: torch.Tensor, size: int) -> torch.Tensor:
    """The `-blur` preprocessing of the sandbox loader
    (TrainHandler.py:274-282): the binomial 3x3 or 5x5 Gaussian applied
    per channel, a depthwise conv (`groups=C`) with zero padding, as the
    JAX package's XLA conv. x (B, C, H, W) floats, any memory format;
    any other size is the identity (the reference defines `blur` for 3
    and 5 alone)."""
    if size not in (3, 5):
        return x
    c = x.shape[1]
    k = torch.as_tensor(_BLUR3 if size == 3 else _BLUR5, dtype=x.dtype,
                        device=x.device)
    return F.conv2d(x, k.expand(c, 1, size, size), padding=size // 2,
                    groups=c)
