"""U-Net embedding-space visualisation (PyTorch port of
`cgs_tpu/sandbox/unet_embeddings.py`; reference `vis_unet_embeddings`,
TrainHandler.py:1592-1686) and the U-Net result video (`vis_unet`,
TrainHandler.py:2652-2720).

A frame sample and labelled tree-trunk crops go through the full U-Net
(`models/zoo.py:Unet`, embeds=True: the u0 feature map before the last
join); every embed pixel is projected to 2-D and scatter-plotted,
coloured by the predicted mask, the crops' embeds overlaid as "+"; then a
2-D half-plane selection goes back onto the frames as mask-agreement
panels (:1664-1686).

Projection: `umap.UMAP(random_state=42)` when the optional `umap` package
imports (the reference's choice, :1652), else the top-2 PCA computed on
the U-Net's device (`PCAProjector`, an SVD of the centred embeds), fit
on the frames and applied to the crops. The scatter plot imports
matplotlib only when it is drawn (`plot=True`); the panels need PIL and
the resizes cv2.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np
import torch

from cgs_tpu_torch.core.device import resolve_device
from cgs_tpu_torch.utils.colors import hsv_to_rgb


def resize_bilinear(arr: np.ndarray, hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize to (height, width), cv2's INTER_LINEAR."""
    import cv2
    return cv2.resize(arr.astype(np.float32), (hw[1], hw[0]),
                      interpolation=cv2.INTER_LINEAR)


class PCAProjector:
    """Top-2-component PCA on `device` (None: cuda), with umap's
    fit_transform / transform API."""

    def __init__(self, device=None):
        self.device = resolve_device(device)

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        self.mean = xt.mean(0)
        _, _, vh = torch.linalg.svd(xt - self.mean, full_matrices=False)
        self.components = vh[:2].T                        # (D, 2)
        return ((xt - self.mean) @ self.components).cpu().numpy()

    def transform(self, x: np.ndarray) -> np.ndarray:
        xt = torch.as_tensor(np.asarray(x, np.float32), device=self.device)
        return ((xt - self.mean) @ self.components).cpu().numpy()


def make_projector(device=None):
    try:
        import umap                                      # noqa: F401
        return umap.UMAP(random_state=42)                # :1652
    except ImportError:
        return PCAProjector(device)


def load_tree_crops(tree_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """TrainHandler.py:1606-1625: RGBA crop images whose names contain
    'w' or 'b'; alpha 255 marks the object with label idx + 1, labels
    > 5 zeroed; colours to HSV."""
    import cv2
    names = [n for n in sorted(os.listdir(tree_dir)) if "w" in n or "b" in n]
    xs, ys = [], []
    for idx, name in enumerate(names):
        path = os.path.join(tree_dir, name)
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise ValueError(f"unreadable crop image: {path}")
        if img.ndim != 3 or img.shape[2] != 4:
            raise ValueError(f"{path}: expected RGBA (alpha marks the "
                             f"object), got shape {img.shape}")
        y = img[:, :, -1].astype(np.int64)
        y[y == 255] = idx + 1
        xs.append(cv2.cvtColor(img[:, :, :3],
                               cv2.COLOR_BGR2HSV).astype(np.float32))
        ys.append(y)
    tree_y = np.stack(ys, axis=0)
    tree_y[tree_y > 5] = 0
    return np.stack(xs, axis=0), tree_y


def _device(unet) -> torch.device:
    return next(unet.parameters()).device


def unet_forward(unet, frames_nhwc: np.ndarray, embeds: bool = False):
    """NHWC numpy frames (fed as they are) through the U-Net on its
    device; NHWC numpy mask (and u0 embeds)."""
    x = torch.from_numpy(np.ascontiguousarray(frames_nhwc, np.float32)).to(
        _device(unet)).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = unet(x, embeds=embeds) if embeds else (unet(x),)
    return tuple(t.permute(0, 2, 3, 1).cpu().numpy() for t in out)


def project_embeddings(unet, raw_batch: np.ndarray, tree_x: np.ndarray,
                       tree_y: np.ndarray, projector=None) -> dict:
    """The device part of `vis_unet_embeddings`: masks and u0 embeds of
    the frames and the crops, the embeds projected to 2-D (fit on the
    frames). Returns the flat per-pixel arrays the plot and the panels
    read."""
    mask, embeds = unet_forward(unet, raw_batch, embeds=True)
    _, tembeds = unet_forward(unet, np.asarray(tree_x, np.float32),
                              embeds=True)
    eh, ew = embeds.shape[1:3]
    flat_mask = np.stack([resize_bilinear(m[..., 0], (eh, ew))
                          for m in mask]).reshape(-1)
    flat_treey = np.stack([resize_bilinear(y.astype(np.float32), (eh, ew))
                           for y in tree_y]).reshape(-1).round()
    projector = projector or make_projector(_device(unet))
    standard = projector.fit_transform(embeds.reshape(-1, embeds.shape[-1]))
    tree_pts = projector.transform(tembeds.reshape(-1, tembeds.shape[-1]))
    keep = flat_treey > 0
    return {"mask": mask, "embed_hw": (eh, ew), "standard": standard,
            "flat_mask": flat_mask, "tree_pts": tree_pts[keep],
            "tree_y": flat_treey[keep]}


def vis_unet_embeddings(unet, frames: np.ndarray, tree_x: np.ndarray,
                        tree_y: np.ndarray, out_dir: str,
                        n_samples: int = 10,
                        sel_threshold: float | None = None, seed: int = 42,
                        plot: bool = True) -> dict:
    """Run the visualisation; returns {'plot', 'frames', 'selection'}.

    frames: (N, 64, 64, 3) HSV floats in 0..255, fed to the net unscaled
    as the reference does (TrainHandler.py:1627; the /255 is for the RGB
    panels only). tree_x / tree_y per `load_tree_crops`. sel_threshold:
    the 2-D half-plane cut (the reference hardcodes `x > 15` in its umap
    space, :1666); default the 90th percentile of the projected x.
    plot=False skips the scatter plot ('plot' None), so no matplotlib."""
    os.makedirs(out_dir, exist_ok=True)
    rng = np.random.default_rng(seed)                    # :1598
    sidxs = rng.choice(np.arange(len(frames)), n_samples)
    raw_batch = np.asarray(frames, np.float32)[sidxs]
    proj = project_embeddings(unet, raw_batch, tree_x, tree_y)
    mask, (eh, ew) = proj["mask"], proj["embed_hw"]
    x, y = proj["standard"][:, 0], proj["standard"][:, 1]

    plot_path = None
    if plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.figure()
        plt.scatter(x, y, c=proj["flat_mask"], s=0.1)
        if len(proj["tree_pts"]):
            plt.scatter(proj["tree_pts"][:, 0], proj["tree_pts"][:, 1],
                        marker="+", s=0.1, c=proj["tree_y"], cmap="cool")
        plot_path = os.path.join(out_dir, "umap-plot.png")
        plt.savefig(plot_path, dpi=300)
        plt.close()

    if sel_threshold is None:
        sel_threshold = float(np.quantile(x, 0.9))
    batch_selection = (x > sel_threshold).reshape(n_samples, eh, ew)
    resized_sel = np.stack([
        resize_bilinear(s.astype(np.float32), raw_batch.shape[1:3])
        for s in batch_selection])[..., None]
    batch_mask = np.ones_like(raw_batch) * resized_sel * (mask > 0.5)
    batch_mask_2 = np.ones_like(raw_batch) * resized_sel * (mask < 0.5)
    rgb_batch = hsv_to_rgb(raw_batch / 255)
    masked = batch_mask * rgb_batch
    masked_2 = batch_mask_2 * rgb_batch

    from PIL import Image
    frame_paths = []
    for idx, frame in enumerate(masked):
        img = np.concatenate((rgb_batch[idx], frame, batch_mask[idx],
                              masked_2[idx], batch_mask_2[idx]), axis=1)
        p = os.path.join(out_dir, f"{idx}.png")
        Image.fromarray(np.uint8(255 * np.clip(img, 0, 1))).save(p)
        frame_paths.append(p)
    return {"plot": plot_path, "frames": frame_paths,
            "selection": batch_selection}


def vis_unet(unet, frames: np.ndarray, out_dir: str, online: bool = False,
             batchsize: int = 512, scale: int = 6) -> str:
    """TrainHandler.py:2652-2720: the full U-Net over an HSV frame
    stream, written as the 3-panel video [pov | mask-weighted rgb |
    mask], each panel 1-px padded, the strip NN-upscaled `scale` times
    (:2705-2718). Returns the path (`offline-eval.mp4` /
    `online-eval.mp4`). The net reads the frames in 0..255 HSV
    (:2696), the panels render from frames / 255 (:2701)."""
    from cgs_tpu_torch.utils.video import vidwrite

    os.makedirs(out_dir, exist_ok=True)
    x = np.asarray(frames, np.float32)
    masks = np.concatenate([unet_forward(unet, x[i:i + batchsize])[0]
                            for i in range(0, len(x), batchsize)])
    rgb = hsv_to_rgb(x / 255) * 255

    def pad(a, v):
        return np.pad(a, ((1, 1), (1, 1), (0, 0)), mode="constant",
                      constant_values=v)

    strips = []
    for idx, mask in enumerate(masks):
        m = np.ones(rgb[idx].shape) * mask
        pic = np.concatenate((pad(rgb[idx], 125), pad(rgb[idx] * m, 125),
                              pad(255 * m, 0.5 * 255)), axis=1)
        pic = np.kron(pic, np.ones((scale, scale, 1)))   # NN upscale
        strips.append(np.clip(pic, 0, 255).astype(np.uint8))
    path = os.path.join(out_dir, "online-eval.mp4" if online
                        else "offline-eval.mp4")
    vidwrite(path, np.stack(strips), framerate=20)
    return path
