"""Intersection-over-union (port of `cgs_tpu/ops/iou.py`; reference
main.py:1265-1270). Host numpy: the eval harness's mask IoU counts run
on the card through `ops.kernels.threshold_iou` and are rounded here."""

from __future__ import annotations

import numpy as np


def iou_counts(a: np.ndarray, b: np.ndarray):
    """(intersection, union) of two boolean (or {0,1}) arrays."""
    a = np.asarray(a).astype(bool)
    b = np.asarray(b).astype(bool)
    return np.sum(a & b), np.sum(a | b)


def iou_from_counts(inter, union) -> float:
    """IoU rounded to 3 decimals; 0.0 when the union is 0 (both masks
    empty), where the reference raises ZeroDivisionError."""
    return round(float(inter) / float(max(int(union), 1)), 3)


def iou(a: np.ndarray, b: np.ndarray) -> float:
    return iou_from_counts(*iou_counts(a, b))
