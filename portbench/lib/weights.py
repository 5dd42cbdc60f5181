"""Inputs and weights made from `--seed`.

Each use of the seed draws from a stream of its own
(`substream(seed, tag)`), so a change in how one input is drawn leaves
the others alone. Weights are made on the device in one draw, in
float32 (the type they are served and trained in), under the port's
state-dict keys, from PyTorch's default distribution U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for weight and bias.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.lib.shapes import state_shapes

TAGS = {"weights": 1, "frames": 2, "index": 4, "sample": 5, "arrivals": 6,
        "shift": 7}


def substream(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of `seed`."""
    state = np.random.SeedSequence([int(seed), TAGS[tag]]).generate_state(
        2, dtype=np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def numpy_rng(seed: int, tag: str, *extra: int) -> np.random.Generator:
    return np.random.default_rng([int(seed), TAGS[tag], *map(int, extra)])


def seeded_params(cfg: dict, seed: int, device) -> dict:
    """{'critic': state_dict, 'masker': state_dict} of float32 tensors on
    `device`, drawn by one `torch.rand` from a generator on `device`."""
    shapes = state_shapes(cfg)
    flat = [(model, key, shape) for model, items in shapes.items()
            for key, shape in items]
    sizes = [math.prod(s) for _, _, s in flat]
    bounds = []
    for (_, key, shape), n in zip(flat, sizes):
        # a bias takes its layer's fan-in: the weight that precedes it
        if key.endswith(".weight"):
            fan_in = math.prod(shape[1:])
        bounds.append(1.0 / math.sqrt(fan_in))
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(substream(seed, "weights"))
    u = torch.rand(sum(sizes), generator=gen, device=dev)
    scale = torch.repeat_interleave(
        torch.tensor(bounds, device=dev),
        torch.tensor(sizes, device=dev))
    vals = (u * 2.0 - 1.0) * scale
    out = {"critic": {}, "masker": {}}
    for (model, key, shape), piece in zip(flat, vals.split(sizes)):
        out[model][key] = piece.view(shape)
    return out


def device_frames(n: int, seed: int, device, tag: str = "frames"):
    """(n, 64, 64, 3) uint8 frames on `device` from the seed."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(substream(seed, tag))
    return torch.randint(0, 256, (n, 64, 64, 3), dtype=torch.uint8,
                         device=dev, generator=gen)
