"""Dense-CRF mask refinement (PyTorch port of `cgs_tpu/eval/crf.py:23-188`;
reference main.py:1226-1263).

The solver is the repo's host C++ mean-field CRF in `native/densecrf/`
(permutohedral-lattice bilateral + spatial Gaussian pairwise terms),
bound here with ctypes of the port's own. At first use it is compiled
with `g++` and the flags of its Makefile into
`build/native/libcgs_densecrf.so` at the root of the checkout (a
directory `.gitignore` lists), through a temporary file and an atomic
rename; a library newer than its sources is reused. Nothing is written
under `native/`, and `make` is not needed. It runs on the host, as in
the JAX package: it is not a device kernel.

Fixed parameters as the reference's grid-collapsed choice
(main.py:1230-1235): w1=22 (bilateral weight), alpha=12 (spatial std),
beta=3.1 (rgb std), w2=8 (spatial weight), gamma=1.8 (std), 10 iters.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE_DIR = ROOT / "native" / "densecrf"
SOURCES = ("densecrf.cpp", "permutohedral.cpp")
HEADERS = ("permutohedral.h",)
LIB_PATH = ROOT / "build" / "native" / "libcgs_densecrf.so"
CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native",
            "-pthread", "-shared")

DEFAULT_PARAMS = dict(w1=22.0, alpha=12.0, beta=3.1, w2=8.0,
                      gamma=1.8, iters=10)

_libs: Dict[str, ctypes.CDLL] = {}


def _stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any((SOURCE_DIR / f).stat().st_mtime > built
               for f in SOURCES + HEADERS)


def build_library() -> Path:
    """Compile the CRF library if it is missing or older than its
    sources; return its path. Per-process temp name + os.replace, so a
    concurrent loader never opens a half-written library."""
    if not _stale():
        return LIB_PATH
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the densecrf library cannot "
                           "be built")
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIB_PATH.with_name(f"{LIB_PATH.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [cxx, *CXXFLAGS, "-o", str(tmp),
         *(str(SOURCE_DIR / f) for f in SOURCES)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"densecrf build failed (rc={proc.returncode}):\n"
            f"{proc.stderr[-2000:]}")
    os.replace(tmp, LIB_PATH)
    return LIB_PATH


def _load_lib() -> ctypes.CDLL:
    lib = _libs.get("densecrf")
    if lib is not None:
        return lib
    lib = ctypes.CDLL(str(build_library()))
    lib.cgs_densecrf_batch.restype = ctypes.c_int
    lib.cgs_densecrf_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8),   # imgs
        ctypes.POINTER(ctypes.c_float),   # probs
        ctypes.c_int,                     # n_frames
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H, W, C
        ctypes.c_float, ctypes.c_float, ctypes.c_float,
        ctypes.c_float, ctypes.c_float,
        ctypes.c_int,                     # iters
        ctypes.POINTER(ctypes.c_uint8),   # out
        ctypes.c_int,                     # n_threads
    ]
    _libs["densecrf"] = lib
    return lib


class DenseCRF:
    """Batched 2-class CRF refinement callable:
    (imgs uint8 (N,H,W,3), masks float (N,H,W)) -> bool (N,H,W).

    `skip` strides the refinement as the reference's crf() does
    (main.py:1239): only every skip-th frame is refined, the others keep
    their input mask, thresholded by the final `>= 1`. `rescale`
    (-crf_rescale) lifts each frame's peak toward 0.9 first, leaving
    confident masks as they are. `debug_dir` dumps every 50th refined
    frame (main.py:1245)."""

    def __init__(self, params: Optional[dict] = None, skip: int = 1,
                 debug_dir: Optional[str] = None, n_threads: int = 0,
                 rescale: bool = False):
        self.lib = _load_lib()
        self.params = dict(DEFAULT_PARAMS, **(params or {}))
        self.skip = skip
        self.debug_dir = debug_dir
        self.n_threads = n_threads  # 0 = hardware concurrency
        self.rescale = rescale

    def __call__(self, imgs: np.ndarray,
                 masks: np.ndarray) -> np.ndarray:
        masks = np.asarray(masks, np.float32)
        if masks.ndim == 4:  # (N,1,H,W) or (N,H,W,1)
            masks = masks.squeeze(1) if masks.shape[1] == 1 \
                else masks.squeeze(-1)
        if self.rescale:
            peak = masks.max(axis=(1, 2), keepdims=True)
            factor = np.where(peak > 1e-6,
                              np.maximum(0.9 / np.maximum(peak, 1e-6),
                                         1.0), 1.0)
            masks = np.clip(masks * factor, 0.0, 1.0)
        if len(masks) == 0:
            # the native entry refuses n_frames <= 0
            return np.zeros(masks.shape, bool)
        refined = masks.copy()
        sel = np.arange(0, len(masks), self.skip)
        sub = masks[sel]
        n, h, w = sub.shape
        probs = np.ascontiguousarray(
            np.stack([1.0 - sub, sub], axis=-1), np.float32)
        sub_imgs = np.ascontiguousarray(imgs[sel], np.uint8)
        out = np.empty((n, h, w), np.uint8)
        p = self.params
        rc = self.lib.cgs_densecrf_batch(
            sub_imgs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            probs.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n, h, w, 2,
            ctypes.c_float(p["w1"]), ctypes.c_float(p["alpha"]),
            ctypes.c_float(p["beta"]), ctypes.c_float(p["w2"]),
            ctypes.c_float(p["gamma"]), int(p["iters"]),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.n_threads)
        if rc != 0:
            raise RuntimeError(f"cgs_densecrf_batch failed rc={rc}")
        refined[sel] = out
        if self.debug_dir:
            self._dump_debug(imgs, masks, out, sel)
        return refined >= 1  # main.py:1263

    def _dump_debug(self, imgs, masks, out, sel):
        from cgs_tpu_torch.utils.artifacts import save_image
        for j, i in enumerate(sel[::50]):
            save_image(os.path.join(self.debug_dir,
                                    f"{i}_mask.png"), masks[i])
            save_image(os.path.join(self.debug_dir, f"{i}_img.png"),
                       imgs[i].astype(np.float32) / 255.0)
            save_image(os.path.join(self.debug_dir, f"{i}_crf.png"),
                       out[j * 50].astype(np.float32))


def grid_search(imgs: np.ndarray, masks: np.ndarray, gt: np.ndarray,
                w1=(22.0,), alpha=(12.0,), beta=(3.1,), w2=(8.0,),
                gamma=(1.8,), iters=(10,), skip: int = 1,
                n_threads: int = 0):
    """CRF hyperparameter grid search (the reference crf()'s scaffolding,
    main.py:1230-1262): refine per combination, IoU against gt on the
    refined frames. Returns ([(params, iou)] sorted ascending by IoU,
    the best combination's refined masks)."""
    results = []
    best = None
    for a in w1:
        for b in alpha:
            for c in beta:
                for d in w2:
                    for e in gamma:
                        for it in iters:
                            params = dict(w1=a, alpha=b, beta=c, w2=d,
                                          gamma=e, iters=it)
                            crf = DenseCRF(params, skip=skip,
                                           n_threads=n_threads)
                            refined = crf(imgs, masks)
                            s = skip
                            inter = np.sum(gt[::s] & refined[::s])
                            union = np.sum(gt[::s] | refined[::s])
                            r = inter / max(union, 1)
                            results.append((params, float(r)))
                            if best is None or r >= best[1]:
                                best = (refined, r)
    results.sort(key=lambda pr: pr[1])
    return results, best[0]
