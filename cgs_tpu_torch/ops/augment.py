"""Horizontal circular shift augmentation (PyTorch port of
`cgs_tpu/ops/augment.py:20-30`; reference main.py:584-591).

The reference draws `xshift = int(shift * U[0,1])` and rolls the width
axis left or right with probability 1/2, one draw for the whole batch.
`shift_batch` draws that signed offset from a `torch.Generator` (a CPU
generator, so the draw needs no device sync) and `shift_batch_by`
applies an explicit one; the parity tests use the latter, because
torch cannot replay `jax.random`. `gaussian_blur` (the sandbox
loader's `-blur`) is not ported yet.
"""

from __future__ import annotations

import math

import torch


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
