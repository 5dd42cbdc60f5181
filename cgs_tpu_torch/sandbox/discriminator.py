"""Binary frame discriminator (PyTorch port of
`cgs_tpu/sandbox/discriminator.py`; reference
`train_water_discriminator`, TrainHandler.py:503-566): classify frames
from two banks (water env vs treechop) with the critic's sigmoid and
BCE; generic over any two frame sources.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from cgs_tpu_torch.train.losses import bce, ingest


def make_discriminator_step(critic, optimizer: torch.optim.Optimizer
                            ) -> Callable:
    """step(x_u8 (B, 64, 64, 3) uint8 on the critic's device, labels
    (B,), generator=None) -> loss; label 1 is the positive class (e.g.
    water frames). The frames are ingested by the `normalize_u8`
    kernel; dropout draws from `generator`."""

    def step(x_u8: torch.Tensor, y: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        loss = bce(critic(ingest(x_u8), generator=generator).squeeze(-1), y)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
