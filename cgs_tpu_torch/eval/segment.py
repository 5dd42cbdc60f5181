"""Batch folder inference, the `-process` mode (PyTorch port of
`cgs_tpu/eval/segment.py:30-180`; reference main.py:1103-1223).

Reads every image in --source-imgs, runs the inference pipeline,
optionally binarises (--binarymaskthreshold, `>=`) and computes
saliency (-process_salience), then writes PNGs to --mask-output-imgs
with the reference's naming: `{name}_with_mask.png` strips under
-concatenated, else per-variant suffixes (main.py:1210-1223). Under
-crf the f32 masks are refined on the host (`eval/crf.py`). A video
file as --source-imgs goes to `segment_video` (port of
`cgs_tpu/eval/segment.py:186-242`, a JAX-package extension): frames
decoded and resized to 64x64 by cv2, masks written as videos with the
folder driver's names. PIL and cv2 are imported only where files are
read or written.
"""

from __future__ import annotations

import os
from typing import Dict, List

import numpy as np

from cgs_tpu_torch.ops.saliency import (
    normalize_saliency_global, normalize_saliency_topk,
)

VARIANT_COLUMNS = ["raw-mask", "thresholded-mask", "crf-mask",
                   "saliency-map", "thresholded-saliency",
                   "crf-saliency"]


def _io_threads() -> int:
    """Host-IO threads for folder decode / PNG encode (PIL releases the
    GIL in its codecs). CGS_IO_THREADS overrides; <=1 means serial."""
    env = os.environ.get("CGS_IO_THREADS", "")
    if env:
        try:
            return max(1, int(env))
        except ValueError:
            print(f"[cgs-tpu-torch] ignoring non-integer CGS_IO_THREADS="
                  f"{env!r}")
    return min(16, os.cpu_count() or 1)


def _ordered_map(fn, items):
    """map() preserving order, threaded when _io_threads() > 1."""
    n = _io_threads()
    if n <= 1 or len(items) <= 1:
        return [fn(it) for it in items]
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=n) as pool:
        return list(pool.map(fn, items))


def load_folder(folder: str):
    """(X float (N,H,W,3) in [0,1], stem names): every readable image
    of the folder, in sorted order (main.py:1126-1128)."""
    from PIL import Image
    names = [n for n in sorted(os.listdir(folder)) if "." in n]

    def decode(name):
        try:
            img = np.asarray(Image.open(os.path.join(folder, name)))
        except Exception:
            return None
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img[..., :3]

    decoded = _ordered_map(decode, names)
    frames = [d for d in decoded if d is not None]
    stems = [name[: name.rindex(".")]
             for name, d in zip(names, decoded) if d is not None]
    if not frames:
        raise RuntimeError(f"no readable images in {folder}")
    shapes = {f.shape for f in frames}
    if len(shapes) > 1 or frames[0].shape[:2] != (64, 64):
        raise ValueError(
            f"the critic/masker operate on 64x64 RGB frames; folder "
            f"{folder} contains shapes {sorted(shapes)} — resize "
            "inputs first (the reference has the same fixed-size "
            "contract, nets.py:161)")
    return np.stack(frames) / 255.0, stems


def _png8(m: np.ndarray) -> np.ndarray:
    """Float mask -> PNG-space uint8, as the reference writes it
    (`(m*255).astype(uint8)`, main.py:1216-1223)."""
    return (255 * np.clip(m, 0, 1)).astype(np.uint8)


def _mask_variants(cfg, pipeline, x: np.ndarray, crf_fn=None):
    """(preds, ordered float variant list, PNG-space uint8 list) for
    float frames x in [0,1] — the allM construction (main.py:1160-1203),
    shared by the folder and video drivers.

    With a wire='u8' pipeline the soft mask arrives quantised and the
    binarisation arrives as the device-side uint8 plane; the float
    variants are then q/255 and exact 0/1 masks. The CRF needs the f32
    wire: a u8-wire pipeline under -crf raises."""
    x_u8 = (x * 255).astype(np.uint8)
    out = pipeline.run(x_u8)
    preds, sal = out.preds, out.saliency
    with_crf = cfg.crf and crf_fn is not None

    all_m: List[np.ndarray] = []
    all_png: List[np.ndarray] = []
    if out.masks_u8 is not None:       # reduced wire
        if with_crf:
            raise ValueError(
                "CRF refinement needs f32 soft masks: build the pipeline "
                "with wire='f32' under -crf (Handler.segment does)")
        q = out.masks_u8.squeeze(-1)
        all_m.append(q.astype(np.float32) / 255.0)
        all_png.append(q)
        if cfg.binarymaskthreshold:              # main.py:1163-1167
            hard = out.hard.squeeze(-1)
            all_m.append(hard.astype(np.float32))
            all_png.append(hard * np.uint8(255))
    else:
        masks = out.masks
        all_m.append(masks.squeeze(-1))
        if cfg.binarymaskthreshold:              # main.py:1163-1167
            if out.hard is not None:   # device-side binarisation
                all_m.append(out.hard.squeeze(-1).astype(np.float32))
            else:
                all_m.append((masks >= cfg.binarymaskthreshold)
                             .squeeze(-1).astype(np.float32))
        if with_crf:                             # main.py:1169-1172
            all_m.append(crf_fn(x_u8, masks.squeeze(-1))
                         .astype(np.float32))
        all_png.extend(_png8(m) for m in all_m)
    if cfg.process_salience and sal is not None:  # main.py:1176-1203
        norm_fn = normalize_saliency_global if cfg.salglobal \
            else normalize_saliency_topk
        sal_soft, sal_hard = norm_fn(sal, preds, cfg.salience_thresh)
        sal_entries = [sal_soft.squeeze(-1),
                       sal_hard.squeeze(-1).astype(np.float32)]
        if with_crf:
            sal_entries.append(crf_fn(x_u8, sal_soft.squeeze(-1))
                               .astype(np.float32))
        all_m.extend(sal_entries)
        all_png.extend(_png8(m) for m in sal_entries)
    return preds, all_m, all_png


def segment_folder(cfg, pipeline, folder: str, crf_fn=None,
                   out_dir: str = None, write: bool = True) -> Dict:
    """Run inference over a folder and write the result PNGs. Returns
    the variant arrays; write=False skips the files."""
    x, stems = load_folder(folder)
    preds, all_m, all_png = _mask_variants(cfg, pipeline, x, crf_fn)

    out_dir = out_dir or cfg.mask_output_imgs
    if not write:
        return {"preds": preds, "variants": all_m, "stems": stems}
    from PIL import Image
    os.makedirs(out_dir, exist_ok=True)

    def write_frame(args):                # PNG encode threads too
        fidx, stem = args
        rgb = (255 * x[fidx]).astype(np.uint8)
        mask_rgb = [np.repeat(m[fidx][..., None], 3, axis=-1)
                    for m in all_png]
        if cfg.concatenated:                      # main.py:1216-1219
            strip = np.concatenate([rgb] + mask_rgb, axis=1)
            Image.fromarray(strip).save(
                os.path.join(out_dir, f"{stem}_with_mask.png"))
        else:                                     # main.py:1220-1223
            for midx, m in enumerate(mask_rgb):
                Image.fromarray(m).save(os.path.join(
                    out_dir, f"{stem}-{VARIANT_COLUMNS[midx]}.png"))

    _ordered_map(write_frame, list(enumerate(stems)))
    return {"preds": preds, "variants": all_m, "stems": stems}


VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def load_video(path: str):
    """Decode a video into (N, 64, 64, 3) float frames in [0,1] and its
    fps. Frames that are not 64x64 are resized (INTER_AREA)."""
    import cv2
    cap = cv2.VideoCapture(path)
    fps = cap.get(cv2.CAP_PROP_FPS) or 32.0
    frames = []
    while True:
        ok, bgr = cap.read()
        if not ok:
            break
        rgb = cv2.cvtColor(bgr, cv2.COLOR_BGR2RGB)
        if rgb.shape[:2] != (64, 64):
            rgb = cv2.resize(rgb, (64, 64),
                             interpolation=cv2.INTER_AREA)
        frames.append(rgb)
    cap.release()
    if not frames:
        raise RuntimeError(f"no decodable frames in {path}")
    return np.stack(frames) / 255.0, float(fps)


def segment_video(cfg, pipeline, path: str, crf_fn=None,
                  out_dir: str = None, write: bool = True) -> Dict:
    """-process on a video file: decode, run the pipeline, write mask
    videos. -concatenated writes one `{stem}_with_mask.mp4` strip (the
    input and every variant side by side); without it, one
    `{stem}-{variant}.mp4` per variant, as the folder driver names its
    PNGs."""
    from cgs_tpu_torch.utils.video import vidwrite

    x, fps = load_video(path)
    preds, all_m, all_png = _mask_variants(cfg, pipeline, x, crf_fn)

    stem = os.path.splitext(os.path.basename(path))[0]
    out_dir = out_dir or cfg.mask_output_imgs
    result = {"preds": preds, "variants": all_m, "stems": [stem],
              "fps": fps}
    if not write:
        return result
    os.makedirs(out_dir, exist_ok=True)
    rate = max(int(round(fps)), 1)
    rgb = (255 * x).astype(np.uint8)
    mask_rgb = [np.repeat(m[..., None], 3, axis=-1) for m in all_png]
    if cfg.concatenated:
        strip = np.concatenate([rgb] + mask_rgb, axis=2)
        vidwrite(os.path.join(out_dir, f"{stem}_with_mask.mp4"), strip,
                 framerate=rate)
    else:
        for midx, m in enumerate(mask_rgb):
            vidwrite(os.path.join(
                out_dir, f"{stem}-{VARIANT_COLUMNS[midx]}.mp4"), m,
                framerate=rate)
    return result
