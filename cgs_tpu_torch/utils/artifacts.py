"""Host-side image artifacts (port of the parts of
`cgs_tpu/utils/artifacts.py` that eval needs: `load_font`,
`save_image`). PIL is imported inside the functions, so the compute
path runs on a machine without it."""

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
