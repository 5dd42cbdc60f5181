"""HSV -> RGB in numpy, the counterpart of `matplotlib.colors.hsv_to_rgb`
that `cgs_tpu/sandbox/unet_embeddings.py:27` and `trans_embeds.py:28`
import (the port does not need matplotlib: the card's machine has none).
"""

from __future__ import annotations

import numpy as np


def hsv_to_rgb(hsv) -> np.ndarray:
    """(..., 3) HSV values in [0, 1] -> (..., 3) RGB, as matplotlib
    computes it: sector i = floor(6h) picks the (v, t, p) arrangement,
    s == 0 gives grey. Floats keep their type (float32 at least);
    values outside [0, 1] raise."""
    hsv = np.asarray(hsv)
    if hsv.shape[-1] != 3:
        raise ValueError("last dimension of input array must be 3; "
                         f"shape {hsv.shape} was found")
    hsv = np.array(hsv, dtype=np.promote_types(hsv.dtype, np.float32))
    if np.any(hsv > 1) or np.any(hsv < 0):
        raise ValueError("hsv values must be in the range [0, 1]")
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    i = (h * 6.0).astype(int)
    f = (h * 6.0) - i
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    r, g, b = np.empty_like(h), np.empty_like(h), np.empty_like(h)
    for sector, (rr, gg, bb) in enumerate(((v, t, p), (q, v, p), (p, v, t),
                                           (p, q, v), (t, p, v),
                                           (v, p, q))):
        idx = i % 6 == sector
        r[idx], g[idx], b[idx] = rr[idx], gg[idx], bb[idx]
    grey = s == 0
    r[grey], g[grey], b[grey] = v[grey], v[grey], v[grey]
    return np.stack([r, g, b], axis=-1)
