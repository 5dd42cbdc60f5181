"""One optimizer step of each training phase (PyTorch port of
`cgs_tpu/train/steps.py:56-210`).

Each step runs eagerly on the models' device: batch ingest (the
`normalize_u8` kernel on the card), the shift augmentation, the
forward passes and every loss branch (`train/losses.py`), backward,
and the Adam update. The loss stays on the device; the chunk loops
(`train/loops.py`) bring it down once per chunk.

Random draws: the shift offset comes from a CPU `torch.Generator` (no
device sync per step) and dropout from a generator on the device, both
seeded by the caller. They differ from the JAX package's `jax.random`
streams; the parity tests run with shift 0 and dropout 0.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict

import torch

from cgs_tpu_torch.ops.augment import shift_batch
from cgs_tpu_torch.train.losses import (
    build_critic_loss, build_masker_loss, ingest,
)

LR, BETAS, EPS = 1e-3, (0.9, 0.999), 1e-8


@dataclasses.dataclass
class StepRng:
    """The generators a step draws from: `shift` on the CPU, `dropout`
    on the models' device."""
    shift: torch.Generator
    dropout: torch.Generator

    @classmethod
    def seeded(cls, seed: int, device) -> "StepRng":
        return cls(torch.Generator().manual_seed(seed),
                   torch.Generator(device=device).manual_seed(seed))


def make_optimizer(modules: Dict[str, torch.nn.Module],
                   critic_update_scale: float = 1.0
                   ) -> torch.optim.Adam:
    """torch.optim.Adam at the reference's defaults (main.py:178,331
    pass no lr): lr 1e-3, betas (0.9, 0.999), eps 1e-8, one parameter
    group per module in `modules`, named by its key.

    critic_update_scale (`--critic-lr-scale`, masker phase only)
    multiplies the updates of the group named 'critic' by s. The JAX
    package scales Adam's update after the fact (optax.scale); here
    the 'critic' group gets lr * s, which differs from that by at most
    1 ulp of the update (one rounding in another place). The scale
    keys only on 'critic', so a trained 'sepcrit' under -separate is
    not scaled (the JAX package's quirk, steps.py:78; a warning says
    so)."""
    if "sepcrit" in modules and critic_update_scale != 1.0:
        warnings.warn(
            "--critic-lr-scale applies to the 'critic' parameters only; "
            "the separate critic ('sepcrit') trains at the full rate, as "
            "in the JAX package (cgs_tpu/train/steps.py:78)")
    groups = [{"params": list(m.parameters()), "name": name,
               "lr": LR * (critic_update_scale if name == "critic"
                           else 1.0)}
              for name, m in modules.items()]
    return torch.optim.Adam(groups, lr=LR, betas=BETAS, eps=EPS)


def trained_param_keys(cfg) -> list:
    """Which models the masker-phase optimizer trains
    (main.py:330-334)."""
    return ["masker"] + (["critic"] if cfg.live else []) + (
        ["sepcrit"] if cfg.separate else [])


def _apply(optimizer: torch.optim.Optimizer, loss: torch.Tensor) -> None:
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()


def critic_step(cfg, critic: torch.nn.Module,
                optimizer: torch.optim.Optimizer, x_u8: torch.Tensor,
                y: torch.Tensor, rng: StepRng) -> torch.Tensor:
    """One critic step (main.py:182-199) on a (B, 64, 64, 3) uint8
    batch and (B,) labels on the device; returns the detached loss."""
    if cfg.shift:
        x_u8 = shift_batch(x_u8, int(cfg.shift), rng.shift)
    loss = build_critic_loss(cfg)(critic, ingest(x_u8), y, rng.dropout)
    _apply(optimizer, loss)
    return loss.detach()


def masker_step(cfg, models: Dict[str, torch.nn.Module],
                optimizer: torch.optim.Optimizer, a_u8: torch.Tensor,
                y: torch.Tensor, b_u8: torch.Tensor, rng: StepRng
                ) -> torch.Tensor:
    """One masker step (main.py:340-463): a_u8 is [K high || K low]
    frames (main.py:350), b_u8 2K contrast-negatives, y the labels of
    a. Only A is shifted (main.py:355-357). Returns the detached
    (replace, inject, norm, critic) loss terms, shape (4,)."""
    if cfg.shift:
        a_u8 = shift_batch(a_u8, int(cfg.shift), rng.shift)
    loss, aux = build_masker_loss(cfg)(
        models, ingest(a_u8), y, ingest(b_u8), rng.dropout)
    _apply(optimizer, loss)
    return torch.stack([aux["replace"], aux["inject"], aux["norm"],
                        aux["critic"]]).detach()
