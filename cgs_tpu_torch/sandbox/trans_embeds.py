"""VGG feature cosine-similarity maps (PyTorch port of
`cgs_tpu/sandbox/trans_embeds.py`; reference `trans_embeds`,
TrainHandler.py:1423-1520).

A small frame batch goes through the VGG11 embedder (every post-ReLU
map resized bilinearly to 64x64 and concatenated on the channels,
nets.py:744-751); for sliding channel windows ("scopes") the cosine
similarity of every pixel's embedding with three fixed target pixels'
is rendered under the RGB frames, raw and thresholded, into one strip
PNG `i{interval}-s{step}.png` (TrainHandler.py:1484-1486). The forward
and every scope's maps run on the device; the PNG is composed on the
host. The weights are random (torch's default init from `seed`) unless
a `models/zoo.py:VGG11Features` state_dict is given.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from cgs_tpu_torch.core.device import resolve_device
from cgs_tpu_torch.models.interop import init_torch_default
from cgs_tpu_torch.models.zoo import VGG11Features, imagenet_normalize
from cgs_tpu_torch.utils.colors import hsv_to_rgb

DEFAULT_TARGETS: Tuple[Tuple[int, int, int], ...] = (
    (4, 32, 32), (4, 12, 32), (0, 48, 32))  # TrainHandler.py:1452


def similarity_maps(model: VGG11Features, x: torch.Tensor,
                    scopes: Sequence[Tuple[int, int]],
                    targets: Sequence[Tuple[int, int, int]],
                    thresh: float) -> torch.Tensor:
    """(n_scopes * 2 * len(targets), B, 64, 64): for each scope and
    target (frame, y, x), the cosine similarity of every pixel's
    embedding with the target's, then that map where it exceeds
    `thresh` (0 elsewhere). x (B, 3, H, W) RGB in [0, 1]."""
    with torch.no_grad():
        _, emb = model(imagenet_normalize(x))
        maps = []
        for lo, hi in scopes:
            e = emb[:, lo:hi]
            norm_e = torch.linalg.vector_norm(e, dim=1)
            for fi, ty, tx in targets:
                t = e[fi, :, ty, tx]                        # (c,)
                num = torch.einsum("bchw,c->bhw", e, t)
                den = norm_e * torch.clamp(torch.linalg.vector_norm(t),
                                           min=1e-12)
                sim = num / torch.clamp(den, min=1e-12)
                maps.append(sim)
                maps.append(sim * (sim > thresh))
        return torch.stack(maps)


def trans_embeds(frames_hsv: np.ndarray, out_dir: str,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 interval: int = 128, step: int = 64, thresh: float = 0.5,
                 targets: Sequence[Tuple[int, int, int]] = DEFAULT_TARGETS,
                 max_scopes: Optional[int] = None, hsv: bool = True,
                 seed: int = 0, device=None) -> str:
    """Run the visualisation; returns the PNG path.

    frames_hsv: (B, 64, 64, 3) floats in [0, 1] (HSV when hsv=True, as
    `model.forward(X, hsv=True)`, TrainHandler.py:1438); B must cover the
    target frames. max_scopes truncates the channel sweep (the full
    VGG11 embed has 2752 channels: 43 scopes). device: default cuda."""
    os.makedirs(out_dir, exist_ok=True)
    dev = resolve_device(device)
    x_hsv = np.asarray(frames_hsv, np.float32)
    rgb = hsv_to_rgb(x_hsv) if hsv else x_hsv
    model = VGG11Features(collect_embeds=True)
    if params is None:
        init_torch_default(model, torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(params)
    model = model.to(dev).eval()
    n_ch = sum(m.out_channels for m in model
               if isinstance(m, torch.nn.Conv2d))
    scopes = [(i * step, i * step + interval)
              for i in range(n_ch // step)]  # TrainHandler.py:1446
    if max_scopes is not None:
        scopes = scopes[:max_scopes]
    xt = torch.from_numpy(np.ascontiguousarray(rgb)).to(dev).permute(
        0, 3, 1, 2)
    maps = similarity_maps(model, xt, scopes, targets, thresh).cpu().numpy()

    # host-side strip composition (TrainHandler.py:1458-1486)
    vizs = [np.concatenate(rgb, axis=1)]
    spacer = np.full((10, rgb.shape[0] * 64, 3), 0.5, np.float32)
    per_scope = 2 * len(targets)
    for si in range(len(scopes)):
        for m in maps[si * per_scope:(si + 1) * per_scope]:
            vizs.append(np.concatenate(rgb * m[:, :, :, None], axis=1))
        vizs.append(spacer)
    viz = np.concatenate(vizs, axis=0)

    from PIL import Image
    path = os.path.join(out_dir, f"i{interval}-s{step}.png")
    Image.fromarray(np.uint8(255 * np.clip(viz, 0, 1))).save(path)
    return path
