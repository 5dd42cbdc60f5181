"""The numbers the correctness checks compare, each a widest gap between
what the program produced and what the reference computes."""

from __future__ import annotations

import math
from typing import Dict

import torch


def max_abs(got: torch.Tensor, want: torch.Tensor) -> float:
    if got.numel() == 0:
        return 0.0
    return float((got.float() - want.float()).abs().max())


def level_gap(levels: torch.Tensor, mask: torch.Tensor) -> float:
    """Served uint8 levels against the reference's soft mask: a level L
    stands for 255 m in [L, L + 1) (floor(255 clip(m, 0, 1)), the PNG
    writers' and the u8 wire's encoding). The gap is how far, in levels,
    255 m_ref lies outside its level's interval: 0 where it lies inside."""
    want = mask.float().clamp(0.0, 1.0) * 255.0
    lv = levels.float()
    below = (lv - want).clamp(min=0.0)
    above = (want - (lv + 1.0)).clamp(min=0.0)
    return float(torch.maximum(below, above).max()) if lv.numel() else 0.0


def hard_gap(hard: torch.Tensor, mask: torch.Tensor, thresh: float) -> float:
    """The served binary plane (mask >= thresh) against the reference's
    soft mask: the largest |m_ref - thresh| among the pixels where the
    two disagree, 0 where none does."""
    disagree = (hard.bool()) != (mask >= thresh)
    if not bool(disagree.any()):
        return 0.0
    return float((mask[disagree] - thresh).abs().max())


def relative_gap(got: float, want: float) -> float:
    return abs(got - want) / max(abs(want), 1e-12)


def leaf_norm_gaps(got: Dict[str, torch.Tensor],
                   want: Dict[str, torch.Tensor], keep=None) -> list:
    """Each leaf's gap between the program's norm and the reference's,
    | |g| - |r| |, against the larger of the reference leaf's norm and
    the median reference leaf's norm; one that is not a number reads
    infinite."""
    norms = {k: float(v.float().norm()) for k, v in want.items()}
    ordered = sorted(norms.values())
    median = ordered[len(ordered) // 2] if ordered else 0.0
    gaps = []
    for k, ref in norms.items():
        if keep is not None and k not in keep:
            continue
        gap = abs(float(got[k].float().norm()) - ref) / max(ref, median,
                                                             1e-30)
        gaps.append(gap if math.isfinite(gap) else math.inf)
    return gaps


def leaf_norm_gap(got, want, keep=None) -> float:
    """The worst leaf's gap (`leaf_norm_gaps`)."""
    return max(leaf_norm_gaps(got, want, keep), default=0.0)


def median_leaf_norm_gap(got, want, keep=None) -> float:
    """The median leaf's gap (`leaf_norm_gaps`): steady from seed to
    seed where the worst leaf's is not."""
    gaps = sorted(leaf_norm_gaps(got, want, keep))
    return gaps[len(gaps) // 2] if gaps else 0.0


def loss_terms_gap(got, want) -> float:
    """The worst gap of a step's loss terms, rows of (term, ...) per
    step: each term against the larger of its own size and a thousandth
    of the step's loss. A term under that is nought to rounding in the
    loss the optimizer sees (the L1 term once the mask has emptied: the
    sigmoid's tail, where a rounding of the logits is a relative change
    of the term), and its own size would judge the rounding alone. A gap
    that is not a number reads infinite."""
    worst = 0.0
    for g_row, w_row in zip(got, want):
        w_row = [float(w) for w in w_row]
        floor = 1e-3 * abs(sum(w_row))
        for g, w in zip(g_row, w_row):
            gap = abs(float(g) - w) / max(abs(w), floor, 1e-30)
            worst = max(worst, gap if math.isfinite(gap) else math.inf)
    return worst


def moving_leaves(grad_ref: Dict[str, torch.Tensor],
                  share: float = 1e-3) -> set:
    """The leaves whose reference gradient is not nought to rounding:
    norm at least `share` of the median leaf's."""
    norms = {k: float(v.float().norm()) for k, v in grad_ref.items()}
    ordered = sorted(norms.values())
    median = ordered[len(ordered) // 2]
    return {k for k, n in norms.items() if n >= share * median}
