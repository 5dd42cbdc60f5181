"""Research-sandbox dataset collectors (a copy of
`cgs_tpu/data/collect_variants.py`, which the port may not import;
SURVEY.md §2.4 "dataset collectors", reference
TrainHandler.py:2853-3602) as pure numpy functions over episode arrays
— MineRL-independent (feed them episodes from the MineRL reader or the
synthetic generator alike).

Implemented: split (pre/post-chop chunk pairs), 6-variant discounted
reward tuples, sarsa pairs (in cgs_tpu_torch/sandbox/td_critic.py),
water/navigation negatives (a frame-bank selector), chop dedup shared
with clean_data. Their outputs equal the JAX package's.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def dedupe_chops(reward: np.ndarray, min_delta: int = 50) -> np.ndarray:
    """Indices of reward events spaced > min_delta frames apart
    (TrainHandler.py:3020-3023; clean_data uses 100, main.py:1395-1399)."""
    chops = np.nonzero(reward)[0]
    if chops.size == 0:
        return chops
    deltas = chops[1:] - chops[:-1]
    return np.concatenate((chops[:1], chops[1:][deltas > min_delta]))


def split_chunks(pov: np.ndarray, reward: np.ndarray,
                 chunklen: int = 100,
                 ) -> Tuple[np.ndarray, np.ndarray]:
    """Pre/post-chop chunk pairs (`collect_split_dataset`,
    TrainHandler.py:2853-2926): for each deduped chop, the chunklen
    frames ending at the chop (approach) and the chunklen frames
    after it (aftermath). Returns (pre (K, L, ...), post (K, L, ...))."""
    chops = dedupe_chops(reward, min_delta=chunklen)
    pre, post = [], []
    for c in chops:
        if c + 1 >= chunklen and c + 1 + chunklen <= len(pov):
            pre.append(pov[c + 1 - chunklen: c + 1])
            post.append(pov[c + 1: c + 1 + chunklen])
    if not pre:
        shape = (0, chunklen) + pov.shape[1:]
        return np.zeros(shape, pov.dtype), np.zeros(shape, pov.dtype)
    return np.stack(pre), np.stack(post)


def discounted_variants(reward: np.ndarray, gamma: float = 0.98,
                        revgamma: float = 1.1, delay: int = 0,
                        trajsize: int = 10 ** 9,
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """The 6-variant reward tuple sweep (`collect_discounted_dataset`,
    TrainHandler.py:3040-3086): walking each episode backwards from
    the last chop, emit per selected frame
        (relchopidx, fak, addfak, revfak, revaddfak, sub)
    where fak decays exponentially and resets at chops, addfak
    accumulates +1 per chop then decays, rev* decay linearly with an
    accelerating step, sub counts down. Returns (selected frame
    indices ascending, tuples (K, 6)).

    Documented deviation: the reference guards its relchopidx reset
    with `len(reward) + i == chops[chopidx]` (TrainHandler.py:3054),
    which can never hold (LHS > len(reward) > any chop index), so
    upstream relchopidx decrements monotonically and — once past
    -trajsize-delay — skips every remaining frame, emitting only the
    episode's TAIL trajectory regardless of earlier chops. We reset
    relchopidx at each chop (the evident intent: per-chop relative
    indices and one trajectory per chop), same defensible-reading
    policy as the uninitialized-`add` quirk in data/collect.py."""
    chops = np.nonzero(reward)[0]
    if chops.size == 0:
        return np.zeros(0, np.int64), np.zeros((0, 6), np.float64)
    end = chops.max()
    r = reward[: end + 1]
    n = len(r)

    sel: List[int] = []
    rows: List[Tuple] = []
    fak = sub = addfak = revfak = revaddfak = 0.0
    revhelper = 0.01
    relchopidx = 0
    delaycount = delay
    for i in range(1, n + 1):
        delaycount -= 1
        relchopidx -= 1
        if r[-i] > 0:
            relchopidx = 0
            fak = 1.0
            sub = 0.0
            addfak += 1.0
            revfak = 1.0
            revaddfak += 1.0
            revhelper = 0.01
            delaycount = delay
        if delaycount > 0 or relchopidx <= -trajsize - delay:
            continue
        sel.append(n - i)
        rows.append((relchopidx, fak, addfak, revfak, revaddfak, sub))
        fak *= gamma
        sub -= 1.0
        addfak *= gamma
        revfak = max(revfak - revhelper, 0.0)
        revaddfak = max(revaddfak - revhelper, 0.0)
        revhelper *= revgamma

    return (np.asarray(sel[::-1], np.int64),
            np.asarray(rows[::-1], np.float64))


def reward_window_frames(pov: np.ndarray, reward: np.ndarray,
                         window: int = 20,
                         min_reward: float = 0.0) -> np.ndarray:
    """Frames within `window` steps of a reward event — the
    `collect_water` pattern (TrainHandler.py:3551-3602: NavigateDense
    frames near reward spikes become the water/negative bank)."""
    hits = np.nonzero(reward > min_reward)[0]
    keep = np.zeros(len(pov), bool)
    for h in hits:
        keep[max(0, h - window): h + window + 1] = True
    return pov[keep]


def merge_negative_bank(x: np.ndarray, y: np.ndarray,
                        neg_x: np.ndarray,
                        label: float = 0.0,
                        rows: Optional[int] = None):
    """Fuse an external negatives bank (navigation/water frames) into
    a labeled dataset (`collect_navigation_dataset` usage,
    TrainHandler.py:2928-2984 + load_data_old nav fusion)."""
    rows = rows if rows is not None else y.shape[0]
    neg_y = np.full((rows, len(neg_x)), label, y.dtype)
    return (np.concatenate([x, neg_x], axis=0),
            np.concatenate([y, neg_y], axis=1))
