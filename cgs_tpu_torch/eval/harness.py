"""IoU evaluation harness (PyTorch port of `cgs_tpu/eval/harness.py`;
reference main.py:891-1101).

Load the labeled `red-trees` eval set (or the synthetic fixture), slice
`[100:5000:2]` (main.py:927-928), run the inference pipeline, and
report the IoU of every variant (main.py:1005-1015). The mask IoU is
counted on the pipeline's device by the `threshold_iou` kernel (strict
`>` at --eval-thresh, main.py:964); the masks are uploaded to it once.
The `hard` and saliency variants stay host numpy, as in the JAX
package. A new best IoU renders the TP/FN/FP comparison video
(main.py:1027-1087); PIL, cv2 and ffmpeg are imported only there.

Training never sees these labels: they enter only here.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np
import torch

from cgs_tpu_torch.ops.iou import iou, iou_from_counts
from cgs_tpu_torch.ops.kernels import threshold_iou
from cgs_tpu_torch.ops.saliency import (
    normalize_saliency_global, normalize_saliency_topk,
)


def load_eval_set(cfg, evaldatapath: str = "red-trees/",
                  folder: str = ""):
    """X float (N,64,64,3) in [0,1], gt bool (N,64,64).

    Real data: `red-trees/X.npy` + `Y.npy`, GT binarised via np.all
    over the last axis (main.py:920-925). With `folder`, frames come
    from that directory with an all-zero GT and no subsampling (the
    reference's folder branch, reconstructed as in the JAX package).
    -resimages substitutes ./resimgs.npy for X (main.py:922-925).
    Falls back to the synthetic fixture when the npy files are absent
    or -synthetic_data is set."""
    if folder:
        from cgs_tpu_torch.eval.segment import load_folder
        x, _ = load_folder(folder)
        gt = np.zeros(x.shape[:3], bool)
        return x.astype(np.float32), gt
    if cfg.resimages:
        try:
            x = np.load("resimgs.npy")
        except OSError as e:
            raise RuntimeError(
                "-resimages needs ./resimgs.npy (reference "
                f"main.py:923): {e}") from e
        gt = np.zeros(x.shape[:3], bool)
    else:
        xp = os.path.join(evaldatapath, "X.npy")
        yp = os.path.join(evaldatapath, "Y.npy")
        if not cfg.synthetic_data and os.path.exists(xp) \
                and os.path.exists(yp):
            x = np.load(xp) / 255.0
            gt = np.all(np.load(yp), axis=-1)
        else:
            from cgs_tpu_torch.data.synthetic import synthetic_eval_set
            xu8, gt = synthetic_eval_set(
                n_frames=5000, seed=cfg.seed + 99,
                variant=cfg.synthetic_variant)
            x = xu8 / 255.0
    x = x[100:5000:2]           # main.py:927
    gt = gt[100:5000:2]
    return x.astype(np.float32), gt.astype(bool)


def mask_iou_on_device(masks: np.ndarray, gt: np.ndarray, thresh: float,
                       device) -> float:
    """IoU of (masks > thresh) vs gt, counted by the threshold_iou
    kernel on `device` (plain version on the CPU), rounded to 3
    decimals."""
    n = masks.shape[0]
    m = torch.from_numpy(np.ascontiguousarray(masks, np.float32)
                         .reshape(n, -1)).to(device)
    g = torch.from_numpy(np.ascontiguousarray(gt, bool)
                         .reshape(n, -1)).to(device)
    inter, union = threshold_iou(m, g, thresh)
    return iou_from_counts(int(inter), int(union))


def evaluate(cfg, pipeline, x: np.ndarray, gt: np.ndarray,
             best_iou: float = 0.0,
             out_dir: str = "eval-results", write: bool = True) -> Dict:
    """Returns {'ious': [...], 'preds': ..., 'variants': ...} in the
    reference's variant order: [mask, (saliency)] (main.py:1005-1015).

    write=False skips the file artifacts (resimages PNG dumps, best-IoU
    video). CRF refinement is not ported yet."""
    if cfg.crf:
        raise NotImplementedError(
            "-crf: the denseCRF binding is not ported yet (ROADMAP.md "
            "queue 1 item 9)")
    x_u8 = (x * 255).astype(np.uint8)
    out = pipeline.run(x_u8)
    preds, masks, sal = out.preds, out.masks, out.saliency

    hard = (masks > cfg.eval_thresh).squeeze(-1)          # main.py:964
    ious = [mask_iou_on_device(masks, gt, cfg.eval_thresh,
                               pipeline.device)]
    variants = {"mask": masks.squeeze(-1), "hard": hard}

    if cfg.salience and sal is not None:                  # main.py:976
        norm_fn = normalize_saliency_global if cfg.salglobal \
            else normalize_saliency_topk
        sal_soft, sal_hard = norm_fn(sal, preds, cfg.salience_thresh)
        sal_hard = sal_hard.squeeze(-1).astype(bool)
        ious.append(iou(sal_hard, gt))
        variants["sal"] = sal_soft.squeeze(-1)
        variants["sal_hard"] = sal_hard

    result = {"ious": ious, "preds": preds, "variants": variants}

    if cfg.resimages and write:  # per-frame hard-mask dumps
        from cgs_tpu_torch.utils.artifacts import save_image
        resdir = os.path.join(out_dir, "resimages")
        os.makedirs(resdir, exist_ok=True)
        for i, m in enumerate(hard):
            save_image(os.path.join(resdir, f"{i}.png"),
                       m.astype(np.float32))

    if ious[0] > best_iou and cfg.visbesteval and write:  # main.py:1027
        os.makedirs(out_dir, exist_ok=True)
        video_path = os.path.join(
            cfg.output_video or out_dir, f"iou={ious[0]}.mp4")
        render_eval_video(
            video_path, x, gt, variants, ious,
            max_frames=cfg.eval_video_max_frames or None)
        result["video"] = video_path
    return result


def _color_code(gt: np.ndarray, m: np.ndarray) -> np.ndarray:
    """TP=green, FN=red, FP=gray, TN=black (main.py:1051,1073-1075)."""
    g = gt.astype(np.float32)
    b = m.astype(np.float32)
    tp = g * b
    fn = g * (1 - b)
    fp = (1 - g) * b
    r = fn + 0.5 * fp
    gch = tp + 0.5 * fp
    bch = 0.5 * fp
    return np.stack([r, gch, bch], axis=-1)


def render_eval_video(path: str, x: np.ndarray, gt: np.ndarray,
                      variants: Dict[str, np.ndarray], ious,
                      framerate: int = 10,
                      max_frames: Optional[int] = None) -> None:
    """Comparison video in the REFERENCE layout (main.py:1027-1087):

      columns (allM order [gt, mask, hard, crf?, sal?, sal_hard?,
      sal_crf?], prefixed by the RGB frame) are REORDERED by the
      reference's hard-coded permutation — [0,1,4,3,2,7,6,5] with crf+
      salience, [0,1,4,3,2] without salience, [0,1,3,2,5] without crf
      — top row = the frames/masks, bottom row = TP/FN/FP color coding
      for the BINARY columns (allM indices {0,2,3,5,6}; soft columns
      get the flat 0.1 gray), with a fosi=30 title banner and a legend
      that doubles in height for the short layouts. Titles carry the
      *measured* IoUs instead of the reference's hard-coded paper
      numbers (documented deviation). Every frame renders (the
      reference writes the full array); the RGB-triplication and
      TP/FN/FP color-coding are built per 64-frame chunk inside the
      write loop, so peak memory is bounded by the chunk, not the
      ~2 GB a full-length float32 column set would cost on the
      default 2450-frame eval."""
    from PIL import Image, ImageDraw

    from cgs_tpu_torch.utils.artifacts import load_font
    from cgs_tpu_torch.utils.video import VideoSink

    iou_iter = iter(ious)
    # allM order with titles + binary flags (reference allM indices)
    all_m = [("ground\ntruth", gt, True),
             ("mask", variants["mask"], False),
             (f"thresholded\nmask\nIoU={next(iou_iter)}",
              variants["hard"], True)]
    has_crf = "crf" in variants
    has_sal = "sal" in variants
    if has_crf:
        all_m.append((f"mask\nCRF\nIoU={next(iou_iter)}",
                      variants["crf"], True))
    if has_sal:
        all_m.append(("saliency\nmap", variants["sal"], False))
        all_m.append((f"thresholded\nsaliency\nIoU={next(iou_iter)}",
                      variants["sal_hard"], True))
        if has_crf and "sal_crf" in variants:
            all_m.append((f"salience\nCRF\nIoU={next(iou_iter)}",
                          variants["sal_crf"], True))

    # frames list = [X] + allM; reference reordering (main.py:1028-1032)
    if not has_crf:
        reordering = [0, 1, 3, 2, 5]
    elif not has_sal:
        reordering = [0, 1, 4, 3, 2]
    else:
        reordering = [0, 1, 4, 3, 2, 7, 6, 5]
    reordering = [i for i in reordering if i <= len(all_m)]
    short = len(reordering) != 8

    n = len(x) if max_frames is None else min(len(x), max_frames)
    scale = 3
    fosi = 30
    font = load_font(size=fosi * 2 // 3)

    # (kind, frames) per column; expansion to RGB/color-code happens
    # per chunk in the write loop. Color-coding is keyed on the column
    # KIND like the reference's fixed index set (main.py:1051) — a
    # saturated soft mask must not flip the panel style.
    cols, titles = [], []
    for i in reordering:
        if i == 0:
            titles.append("RGB\nimage")
            cols.append(("rgb", x[:n]))
            continue
        title, m, binary = all_m[i - 1]
        titles.append(title)
        cols.append(("bin" if binary else "soft", m[:n]))

    # static banner + legend rows (composited once)
    ncols = len(reordering)
    width = ncols * 64 * scale
    banner = Image.new("RGB", (width, fosi * 4))
    draw = ImageDraw.Draw(banner)
    for i, t in enumerate(titles):
        draw.text((fosi // 5 + 64 * scale * i, fosi // 5), t, font=font)
    banner = np.asarray(banner)

    legend_text = [("GREEN = True Positive", (0, 255, 0)),
                   ("RED = False Negative", (255, 0, 0)),
                   ("GRAY = False Positive", (125, 125, 125)),
                   ("BLACK = True Negative", (255, 255, 255))]
    # short layouts double the legend height and wrap the last two
    # entries (main.py:1074-1080)
    legend = Image.new("RGB", (width, fosi * (4 if short else 2)))
    draw = ImageDraw.Draw(legend)
    spacing = max(1, (width - 2) // len(legend_text))
    for i, (text, color) in enumerate(legend_text):
        draw.text((fosi // 5 + i * spacing, fosi // 5), text,
                  font=font, fill=color)
    legend = np.asarray(legend)

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with VideoSink(path, framerate=framerate) as sink:
        chunk = 64
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            tops, bots = [], []
            for kind, arr in cols:
                if kind == "rgb":
                    tops.append(arr[lo:hi])
                    bots.append(arr[lo:hi])
                    continue
                mm = arr[lo:hi].astype(np.float32)
                t = np.repeat(mm[..., None], 3, axis=-1)
                tops.append(t)
                bots.append(_color_code(gt[lo:hi], mm) if kind == "bin"
                            else 0.1 * np.ones_like(t))
            top = np.concatenate(tops, axis=2)
            bot = np.concatenate(bots, axis=2)
            fr = np.concatenate([top, bot], axis=1)
            fr = (255 * np.clip(fr, 0, 1)).astype(np.uint8)
            fr = fr.repeat(scale, axis=1).repeat(scale, axis=2)
            for f in fr:
                sink.append(np.concatenate([banner, f, legend],
                                           axis=0))
