"""Counterfactual mask-merge ops (PyTorch port of
`cgs_tpu/ops/merge.py`).

The heart of the training algorithm (reference main.py:395,406):

    replaced = A * (1 - Z) + Z * B     # cut the masked content out of A
    injected = B * (1 - Z) + Z * A     # paste A's masked content into B

A, B are NCHW (N, 3, H, W) frames stored channels_last; Z is the
(N, 1, H, W) soft mask, broadcast over RGB. `replace_merge` and
`inject_merge` are plain PyTorch. `merge_both` computes both in one
pass as a `torch.autograd.Function` and returns them as one (2N, 3, H,
W) channels_last batch, replaced || injected, which the critic's fused
pass reads as it is: its forward is the `merge_pair` kernel, writing
the two halves, and its backward the `merge_pair_bwd` kernel, reading
the batch's gradient in place as one buffer, summing dz over RGB (the
JAX VJP does that sum after its kernel, `cgs_tpu/ops/merge.py:64-67`)
and writing only the gradients autograd asks for (the masker step's
frames need none: dz alone). On CPU tensors both run their plain
versions.
"""

from __future__ import annotations

import torch

from cgs_tpu_torch.ops.kernels import blend, merge_pair, merge_pair_bwd


def replace_merge(a: torch.Tensor, b: torch.Tensor,
                  z: torch.Tensor) -> torch.Tensor:
    """A with its masked (reward-relevant) pixels replaced by B's
    (main.py:395)."""
    return blend(a, b, z)


def inject_merge(a: torch.Tensor, b: torch.Tensor,
                 z: torch.Tensor) -> torch.Tensor:
    """B with A's masked pixels injected (main.py:406)."""
    return blend(b, a, z)


class MergeBoth(torch.autograd.Function):
    """replaced || injected with the fused kernel pair as forward and
    backward."""

    @staticmethod
    def forward(ctx, a, b, z):
        ctx.save_for_backward(a, b, z)
        return merge_pair(a, b, z)

    @staticmethod
    def backward(ctx, g):
        a, b, z = ctx.saved_tensors
        return merge_pair_bwd(a, b, z, g, ctx.needs_input_grad)


def merge_both(a: torch.Tensor, b: torch.Tensor, z: torch.Tensor
               ) -> torch.Tensor:
    """cat([replace_merge(a, b, z), inject_merge(a, b, z)]) as one
    (2N, C, H, W) channels_last batch, in one kernel launch forward and
    one backward."""
    return MergeBoth.apply(a, b, z)
