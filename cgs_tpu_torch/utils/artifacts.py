"""Host-side image artifacts (port of `cgs_tpu/utils/artifacts.py`:
`load_font`, `save_image`, and the training artifacts `annotate_strip`,
`save_loss_plot`, `save_histogram`). PIL and matplotlib are imported
inside the functions, so the compute path runs on a machine without
them. Where matplotlib is absent, the loss curves and histograms are
drawn with PIL's `ImageDraw` instead (`plot_lines`, `plot_histogram`,
`panel_grid`): the same files, the same moving average, one curve per
series, and one note per process saying matplotlib is absent."""

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


_noted_absent = []      # the one note per process: matplotlib is absent


def pyplot_or_none():
    """matplotlib's pyplot on the Agg backend, or None where matplotlib
    cannot be imported (the first time, a note saying the figures are
    drawn with PIL)."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        from matplotlib import pyplot as plt
    except ImportError:
        if not _noted_absent:
            _noted_absent.append(True)
            print("[cgs-tpu-torch] matplotlib is absent: loss curves and "
                  "histograms are drawn with PIL")
        return None
    return plt


# matplotlib's default colour cycle (tab10), so the PIL curves keep the
# order of colours a reader knows
_CYCLE = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40),
          (148, 103, 189), (140, 86, 75), (227, 119, 194), (127, 127, 127),
          (188, 189, 34), (23, 190, 207)]
_SIZE = (640, 480)                # matplotlib's default figure, 100 dpi
_MARGIN = (60, 30, 20, 40)        # left, top, right, bottom


def _axes(draw, size, xlim, ylim, font, title=None):
    """The plot box of a figure of `size` with its limits written at the
    corners; returns (x, y) -> pixel."""
    w, h = size
    left, top, right, bottom = _MARGIN
    x0, y0, x1, y1 = left, top, w - right, h - bottom
    draw.rectangle((x0, y0, x1, y1), outline=(0, 0, 0))
    fmt = "{:.4g}".format
    draw.text((2, y0), fmt(ylim[1]), fill=(0, 0, 0), font=font)
    draw.text((2, y1 - 10), fmt(ylim[0]), fill=(0, 0, 0), font=font)
    draw.text((x0, y1 + 4), fmt(xlim[0]), fill=(0, 0, 0), font=font)
    draw.text((x1 - 40, y1 + 4), fmt(xlim[1]), fill=(0, 0, 0), font=font)
    if title:
        draw.text((x0, 8), title, fill=(0, 0, 0), font=font)
    xs = (x1 - x0) / ((xlim[1] - xlim[0]) or 1.0)
    ys = (y1 - y0) / ((ylim[1] - ylim[0]) or 1.0)
    return lambda x, y: (x0 + (x - xlim[0]) * xs, y1 - (y - ylim[0]) * ys)


def plot_lines(curves, labels, ymin_zero: bool = True, size=_SIZE):
    """A PIL image of the 1-D `curves`, each its own colour, with a
    legend of `labels`; the y axis from 0 when `ymin_zero`."""
    from PIL import Image, ImageDraw
    img = Image.new("RGB", size, (255, 255, 255))
    draw, font = ImageDraw.Draw(img), load_font()
    finite = [c[np.isfinite(c)] for c in curves]
    lo = min((float(c.min()) for c in finite if c.size), default=0.0)
    hi = max((float(c.max()) for c in finite if c.size), default=1.0)
    lo = 0.0 if ymin_zero else lo
    n = max((len(c) for c in curves), default=1)
    to_px = _axes(draw, size, (0, max(n - 1, 1)), (lo, max(hi, lo + 1e-12)),
                  font)
    for i, c in enumerate(curves):
        colour = _CYCLE[i % len(_CYCLE)]
        pts = [to_px(t, float(v)) for t, v in enumerate(c) if np.isfinite(v)]
        if len(pts) > 1:
            draw.line(pts, fill=colour, width=2)
        elif pts:
            draw.point(pts, fill=colour)
        y = _MARGIN[1] + 6 + 14 * i
        x = size[0] - _MARGIN[2] - 150
        draw.line((x, y + 5, x + 20, y + 5), fill=colour, width=2)
        draw.text((x + 25, y), str(labels[i]), fill=(0, 0, 0), font=font)
    return img


def plot_histogram(values, bins: int = 10, title=None, size=_SIZE):
    """A PIL image of the histogram of `values` in `bins` equal bins
    over their range (matplotlib's `hist` default: 10)."""
    from PIL import Image, ImageDraw
    img = Image.new("RGB", size, (255, 255, 255))
    draw, font = ImageDraw.Draw(img), load_font()
    v = np.asarray(values, dtype=np.float64).ravel()
    v = v[np.isfinite(v)]
    counts, edges = np.histogram(v, bins=bins) if v.size else (
        np.zeros(bins), np.linspace(0.0, 1.0, bins + 1))
    to_px = _axes(draw, size, (edges[0], edges[-1]),
                  (0.0, max(float(counts.max()), 1.0)), font, title)
    for c, a, b in zip(counts, edges[:-1], edges[1:]):
        (xa, ya), (xb, yb) = to_px(a, float(c)), to_px(b, 0.0)
        draw.rectangle((xa, ya, xb, yb), fill=_CYCLE[0],
                       outline=(255, 255, 255))
    return img


def panel_grid(images, cols: int):
    """PIL images of one size tiled row by row, `cols` a row."""
    from PIL import Image
    w, h = images[0].size
    rows = -(-len(images) // cols)
    grid = Image.new("RGB", (w * cols, h * rows), (255, 255, 255))
    for i, im in enumerate(images):
        grid.paste(im, ((i % cols) * w, (i // cols) * h))
    return grid


def save_pil(path: str, img) -> None:
    """Save a PIL image, making its directory."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    img.save(path)


def save_loss_plot(path: str, series, labels=None, window: int = 30,
                   ymin_zero: bool = True) -> None:
    """Moving-average loss curves `_loss.png` (main.py:231-235,
    555-562); with PIL where matplotlib is absent."""
    arr = np.asarray(series, dtype=np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    labels = labels or [f"loss{i}" for i in range(arr.shape[1])]
    curves = [moving_average(arr[:, i], window) if len(arr) > window
              else arr[:, i] for i in range(arr.shape[1])]
    plt = pyplot_or_none()
    if plt is None:
        save_pil(path, plot_lines(curves, labels, ymin_zero))
        return
    plt.clf()
    for curve, label in zip(curves, labels):
        plt.plot(curve, label=label)
    if ymin_zero:
        plt.ylim(0, plt.ylim()[1])
    plt.legend()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    plt.savefig(path)
    plt.close()


def save_histogram(path: str, values) -> None:
    """Pred/GT histogram PNGs (main.py:255-264); with PIL where
    matplotlib is absent."""
    plt = pyplot_or_none()
    if plt is None:
        save_pil(path, plot_histogram(values))
        return
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
