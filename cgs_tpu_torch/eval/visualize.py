"""Diagnostic prediction-curve videos (PyTorch port of
`cgs_tpu/eval/visualize.py:21-135`; reference main.py:702-885
`visualize`, `make_plotbar` main.py:31-41).

Renders the test set as a video with scrolling 1-px plots of GT and
critic prediction underneath (with -vismasker, the masked frames as a
second row), in natural, pred-sorted and GT-sorted orders. The model
pass runs without PIL: PIL is imported only where a video is written.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np


def make_plotbar(ph: int, pw: int, values: np.ndarray) -> np.ndarray:
    """1-px scrolling plot strip (main.py:31-41): values normalised to
    [0,1], drawn as white pixels on a (ph, pw+len-1, 3) canvas."""
    v = np.asarray(values, np.float64)
    v = v - v.min()
    vmax = v.max()
    v = v / (vmax * 1.01 if vmax else 1.0)
    rows = (ph - 1 - np.floor(v * ph)).astype(np.int64)
    bar = np.zeros((ph, pw + len(v) - 1, 3), np.uint8)
    bar[rows, np.arange(len(v)) + pw // 2] = 255
    return bar


def render_curves_video(path: str, frames: np.ndarray,
                        value_rows: np.ndarray,
                        sorting: Optional[np.ndarray] = None,
                        scale: int = 4, ph: int = 32,
                        framerate: int = 4,
                        max_frames: Optional[int] = None) -> None:
    """frames: (R, N, H, W, 3) float [0,1], R stacked rows (e.g. RGB and
    masked RGB); value_rows: (V, N), e.g. [GT, pred]. Every frame is
    rendered (main.py:827,835), streamed to the writer."""
    from PIL import Image, ImageDraw

    from cgs_tpu_torch.utils.artifacts import load_font
    from cgs_tpu_torch.utils.video import VideoSink

    frames = np.asarray(frames)
    values = np.asarray(value_rows, np.float64)
    if sorting is not None:
        frames = frames[:, sorting]
        values = values[:, sorting]
    n = frames.shape[1] if max_frames is None else \
        min(frames.shape[1], max_frames)
    w = frames.shape[3]
    plotbars = [make_plotbar(ph, w, values[i])
                for i in range(len(values))]
    # the label sits above the whole plot stack (main.py:826 reassigns
    # ph = 32 * len(plotbars) before placing it)
    ph_total = ph * len(plotbars)
    font = load_font()

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with VideoSink(path, framerate=framerate) as sink:
        for idx in range(n):
            pic = np.concatenate(frames[:, idx], axis=0)
            pic = (255 * np.clip(pic, 0, 1)).astype(np.uint8)
            plots = []
            for bar in plotbars:
                sl = bar[:, idx:idx + w]
                if sl.shape[1] < w:
                    sl = np.pad(sl,
                                ((0, 0), (0, w - sl.shape[1]), (0, 0)))
                sl = sl.copy()
                sl[:, w // 2] = sl[:, w // 2] * np.array((1, 0, 0),
                                                         np.uint8)
                plots.append(sl)
            pic = np.concatenate([pic] + plots, axis=0)
            pic = pic.repeat(scale, axis=0).repeat(scale, axis=1)
            img = Image.fromarray(pic)
            draw = ImageDraw.Draw(img)
            label = str(int(sorting[idx])) if sorting is not None \
                else str(idx)
            draw.text((w * scale - 26,
                       pic.shape[0] - 13 - ph_total * scale),
                      label, fill=(255, 255, 255), font=font)
            for vi in range(len(values)):
                draw.text((1, 1 + 15 * vi),
                          str(round(float(values[vi, idx]), 3)),
                          fill=(255, 255, 255), font=font)
            sink.append(np.asarray(img))


def visualize(cfg, pipeline, x_test: np.ndarray, y_test_row: np.ndarray,
              out_dir: str, y_matrix: Optional[np.ndarray] = None,
              write: bool = True) -> list:
    """The -viscritic/-vismasker flow (main.py:736-885): batched preds
    (and masks), then the curves, pred-sorted and (with --sortidx)
    GT-sorted videos, named from --visname. Returns their paths;
    write=False runs the model pass and writes no file.

    --purevis "i,j,..." skips the model and plots the selected rows of
    the label matrix (main.py:764-767)."""
    if cfg.purevis and y_matrix is not None:
        idxs = [int(e) for e in cfg.purevis.split(",")]
        values = y_matrix[idxs]
        frames = (x_test.astype(np.float32) / 255.0)[None]
    else:
        out = pipeline.run(x_test)
        values = np.stack([y_test_row, out.preds], axis=0)  # main.py:804
        rows = [x_test.astype(np.float32) / 255.0]
        if cfg.vismasker:                           # main.py:805-811
            rows.append(rows[0] * out.masks)
        frames = np.stack(rows, axis=0)

    name = cfg.visname
    paths = [os.path.join(out_dir, f"{name}.mp4")]
    if write:
        render_curves_video(paths[0], frames, values)
    # -purevis can select fewer rows than sortidx+1: clamp
    si = min(cfg.sortidx, len(values) - 1)
    sorting = np.argsort(values[si])[::-1]           # main.py:880
    paths.append(os.path.join(out_dir, f"{name}-pred-sorted.mp4"))
    if write:
        render_curves_video(paths[1], frames, values, sorting=sorting)
    if cfg.sortidx:                                  # main.py:882-884
        sorting = np.argsort(values[0])[::-1]
        paths.append(os.path.join(out_dir, f"{name}-GT-sorted.mp4"))
        if write:
            render_curves_video(paths[2], frames, values,
                                sorting=sorting)
    return paths
