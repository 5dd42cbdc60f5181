"""Mask-area self-supervision experiment (PyTorch port of
`cgs_tpu/sandbox/sum_segm.py`; reference `sum_segm`,
TrainHandler.py:1896-1993): train a U-Net so each frame's soft-mask
pixel sum matches its own hard-mask (> 0.5) pixel count, floored at 10
(TrainHandler.py:1935-1939).

A chunk runs S steps over uint8 frames resident on the device, each
step's batch gathered and normalised by the ingest kernel (one
`normalize_u8` launch) and the U-Net's joins the upsample kernels;
losses come down once per chunk.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from cgs_tpu_torch.core.device import resolve_device
from cgs_tpu_torch.ops.kernels import Segment
from cgs_tpu_torch.train.losses import ingest_segments


def sum_segm_loss(mask: torch.Tensor, floor: float = 10.0) -> torch.Tensor:
    """MSE between each frame's soft-mask sum and its hard-mask count
    clamped at `floor` (TrainHandler.py:1935-1939); the target is a
    constant."""
    flat = mask.reshape(mask.shape[0], -1)
    soft_sum = flat.sum(1)
    target = torch.clamp((flat > 0.5).sum(1).to(mask.dtype), min=floor)
    return torch.mean((soft_sum - target.detach()) ** 2)


def make_sum_segm_chunk(unet, optimizer: torch.optim.Optimizer
                        ) -> Callable:
    """chunk(x_all (N, 64, 64, 3) uint8 on the device, idx (S, B)
    int64 there) -> the (S,) losses on the device, after S optimizer
    steps on `unet` in place."""

    def chunk(x_all: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        losses = []
        for bidx in idx:
            x, _ = ingest_segments([Segment(x_all, bidx)])
            loss = sum_segm_loss(unet(x))
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
            optimizer.step()
            losses.append(loss.detach())
        return torch.stack(losses)

    return chunk


def train_sum_segm(unet, x_u8: np.ndarray, steps: int, batch: int,
                   rng: np.random.Generator, chunk_steps: int = 50,
                   device=None) -> Tuple[torch.nn.Module, List[float]]:
    """`steps` Adam steps (torch's defaults, TrainHandler.py:1902) on
    (N, 64, 64, 3) uint8 frames, their batches drawn from `rng` as the
    JAX function draws them; returns (unet, the losses). The net and the
    frames go to `device` (default cuda)."""
    dev = resolve_device(device)
    unet = unet.to(dev, memory_format=torch.channels_last)
    opt = torch.optim.Adam(unet.parameters(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    chunk = make_sum_segm_chunk(unet, opt)
    x_dev = torch.from_numpy(np.ascontiguousarray(x_u8)).to(dev)
    n = x_u8.shape[0]
    losses: List[float] = []
    done = 0
    while done < steps:
        s = min(chunk_steps, steps - done)
        idx = rng.integers(0, n, (s, batch)).astype("int32")
        out = chunk(x_dev, torch.from_numpy(idx.astype(np.int64)).to(dev))
        losses.extend(out.cpu().tolist())
        done += s
    return unet, losses

