"""Host-side image artifacts (port of `cgs_tpu/utils/artifacts.py`:
`load_font`, `save_image`, and the training artifacts `annotate_strip`,
`save_loss_plot`, `save_histogram`). PIL and matplotlib are imported
inside the functions, so the compute path runs on a machine without
them."""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def load_font(path: Optional[str] = None, size: int = 10):
    """A TTF at `path` if present, else PIL's default font (the
    reference's hard-coded font file is absent from its own repo)."""
    from PIL import ImageFont
    if path and os.path.exists(path):
        return ImageFont.truetype(path, size)
    try:
        return ImageFont.load_default(size=size)
    except TypeError:  # older PIL without size kwarg
        return ImageFont.load_default()


def save_image(path: str, arr: np.ndarray) -> None:
    from PIL import Image
    arr = np.asarray(arr)
    if arr.dtype != np.uint8:
        arr = (255 * np.clip(arr, 0, 1)).astype(np.uint8)
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = np.repeat(arr, 3, axis=-1)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    Image.fromarray(arr).save(path)


def moving_average(x, n: int = 10) -> np.ndarray:
    """Cumsum moving mean (main.py:26-28)."""
    c = np.cumsum(np.asarray(x, dtype=np.float64))
    return (c[n:] - c[:-n]) / n


def save_loss_plot(path: str, series, labels=None, window: int = 30,
                   ymin_zero: bool = True) -> None:
    """Moving-average loss curves `_loss.png` (main.py:231-235,
    555-562)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plt.clf()
    arr = np.asarray(series, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    labels = labels or [f"loss{i}" for i in range(arr.shape[1])]
    for i in range(arr.shape[1]):
        if len(arr) > window:
            plt.plot(moving_average(arr[:, i], window), label=labels[i])
        else:
            plt.plot(arr[:, i], label=labels[i])
    if ymin_zero:
        plt.ylim(0, plt.ylim()[1])
    plt.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path)
    plt.close()


def save_histogram(path: str, values) -> None:
    """Pred/GT histogram PNGs (main.py:255-264)."""
    import matplotlib
    matplotlib.use("Agg")
    from matplotlib import pyplot as plt

    plt.clf()
    plt.hist(np.asarray(values).ravel())
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path)
    plt.close()


def annotate_strip(rows, value_rows, path: str, font=None,
                   row_offset: int = 12) -> None:
    """Concatenate image rows (each (B, H, W, 3) float [0,1] or uint8)
    horizontally per batch and vertically per row, overlay value
    annotations, save PNG (main.py:466-530 layout).

    value_rows[i] is drawn at vertical offset i*row_offset."""
    from PIL import Image, ImageDraw
    font = font or load_font()
    strips = []
    for row in rows:
        row = np.asarray(row)
        if row.dtype != np.uint8:
            row = (255 * np.clip(row, 0, 1)).astype(np.uint8)
        if row.shape[-1] == 1:
            row = np.repeat(row, 3, axis=-1)
        strips.append(np.concatenate(list(row), axis=1))
    viz = np.concatenate(strips, axis=0)
    img = Image.fromarray(viz)
    draw = ImageDraw.Draw(img)
    n = max((len(v) for v in value_rows), default=1)
    for r, values in enumerate(value_rows):
        for i, value in enumerate(values):
            x = int(i * img.width / max(n, 1))
            draw.text((x, r * row_offset), str(round(float(value), 3)),
                      fill=(255, 255, 255), font=font)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img.save(path)
