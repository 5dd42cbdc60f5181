"""Synthetic reward-segmentation fixture (numpy copy of
`cgs_tpu/data/synthetic.py`: the episode renderers,
`synthetic_dataset` and `synthetic_eval_set`; the same seed gives
equal arrays, and labels within float32 rounding).

The reference trains on the 60 GB MineRL Treechop imitation dataset
(main.py:1287-1290), which is neither shippable nor downloadable here.
This module generates a procedurally equivalent task so the full
two-phase pipeline runs end-to-end in seconds and IoU has a known
oracle (SURVEY.md §4 item 3):

  * 64x64 RGB frames: textured green/brown noise background;
  * the "rewarding object" is a vertical red-brown trunk whose width
    grows as the agent approaches; reward fires when the trunk is
    chopped (trunk present for a few frames, then disappears with
    reward=1 on the final contact frame);
  * ground-truth masks are the trunk footprint — training never sees
    them (the invariant of the reference, SURVEY.md §3.5).

Same (X, Y, I) contract as the MineRL collector: X uint8 (N,64,64,3),
Y float32 (7,N) with row 0 = binary reward and rows 1-4 discounted at
gammas, I uint16 frame-in-episode indices.

Two variants (--synthetic-variant):

  * "easy" (default, the r1-r3 fixture): the trunk's red signature is
    kept linearly separable from the background by COLOR alone — fast
    to learn, ideal for e2e tests, but too easy to exercise the
    method's mechanism: the frozen/separate ablations invert vs the
    paper on it (RESULTS.md r3 ablation table; VERDICT r3 #2).
  * "hard": reward correlates with trunk TEXTURE, not color —
    (a) the trunk is vertical-grained red-brown; (b) color-matched
    DISTRACTOR blobs share the exact palette but carry horizontal
    grain and appear independently of the reward phase — they never
    carry reward, and their color/area is uninformative about it
    (a color-only critic is stuck at chance); (c) the background
    palette is
    NONSTATIONARY — per-episode anchors drifting within the episode,
    overlapping the object palette across episodes (background
    color subtraction is unreliable). Ground truth stays trunk-only,
    so masking distractors costs IoU. This is the fixture the
    paper's ablation ordering is measured on.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from cgs_tpu_torch.ops.discount import build_label_matrix


def _trunk_mask(width: int, center: int, trunk_w: int) -> np.ndarray:
    m = np.zeros((width, width), bool)
    lo = max(0, center - trunk_w // 2)
    hi = min(width, center + (trunk_w + 1) // 2)
    m[8:, lo:hi] = True  # trunk spans most of the frame height
    return m


def _render(rng: np.random.Generator, mask: np.ndarray) -> np.ndarray:
    w = mask.shape[0]
    frame = np.empty((w, w, 3), np.uint8)
    # grass/sky-ish noisy background (red channel kept low so the
    # trunk's red signature is linearly separable — the fixture must be
    # learnable within a few hundred critic steps)
    base = np.stack([rng.integers(30, 70, (w, w)),
                     rng.integers(90, 160, (w, w)),
                     rng.integers(40, 90, (w, w))], axis=-1)
    frame[:] = base
    # trunk: saturated red-brown, clearly separated from background
    trunk = np.stack([rng.integers(190, 220, (w, w)),
                      rng.integers(50, 70, (w, w)),
                      rng.integers(30, 50, (w, w))], axis=-1)
    frame[mask] = trunk[mask].astype(np.uint8)
    return frame


# -- hard variant ------------------------------------------------------

def _object_palette(rng, shape):
    """Shared red-brown palette for trunk AND distractors — color
    cannot separate reward from distractor pixels."""
    return np.stack([rng.integers(160, 210, shape),
                     rng.integers(60, 95, shape),
                     rng.integers(40, 70, shape)], axis=-1).astype(
        np.int32)


def _grain(width: int, vertical: bool) -> np.ndarray:
    """2-px brightness grain: the one cue that separates trunk
    (vertical) from distractor (horizontal). A 3x3 conv resolves the
    orientation — learnable by the tiny critic, invisible to any
    color histogram."""
    idx = np.arange(width)
    stripe = ((idx // 2) % 2).astype(np.float32) * 0.45 + 0.55
    return (stripe[None, :].repeat(width, 0) if vertical
            else stripe[:, None].repeat(width, 1))


def _episode_background(rng):
    """Per-episode nonstationary palette: two random anchor colors
    (overlapping the object palette's range across episodes) that the
    frame background lerps between as the episode progresses."""
    return (rng.integers(30, 190, 3).astype(np.float32),
            rng.integers(30, 190, 3).astype(np.float32))


def _distractor_mask(rng, width: int, target_area: int,
                     avoid: np.ndarray = None) -> np.ndarray:
    """Color-matched horizontal-grain blobs totalling ~target_area
    pixels (skipping `avoid` = the trunk footprint). The per-frame
    AREA BUDGET is the anti-shortcut: every frame carries the same
    palette-pixel-count distribution whether or not a trunk is
    present, so even a full color-HISTOGRAM probe (not just channel
    means) sits near chance — object-area counting, the residual
    color strategy after palette matching, is uninformative too."""
    m = np.zeros((width, width), bool)
    for _ in range(32):                     # safety cap
        if m.sum() >= target_area:
            break
        h = int(rng.integers(8, 20))
        w = int(rng.integers(8, 20))
        y0 = int(rng.integers(0, width - h))
        x0 = int(rng.integers(0, width - w))
        m[y0:y0 + h, x0:x0 + w] = True
        if avoid is not None:
            m &= ~avoid
    return m


def _render_hard(rng, mask: np.ndarray, distr: np.ndarray,
                 bg_anchors, phase: float) -> np.ndarray:
    w = mask.shape[0]
    c0, c1 = bg_anchors
    base_mean = c0 + (c1 - c0) * phase          # within-episode drift
    # low-amplitude noise (+-8, not +-25): blend seams from a partial
    # mask must stay VISIBLE against the background — the inject
    # loss's whole job is to forbid the critic/masker co-adaptation
    # that scores 30%-blended trunks as "removed" (the noinject
    # cheat); heavy background noise hides those seams and the cheat
    # stops costing anything (measured: noinject BEAT full at +-25)
    base = base_mean[None, None, :] + rng.integers(
        -8, 9, (w, w, 3)).astype(np.float32)
    frame = np.clip(base, 0, 255).astype(np.int32)
    if distr.any():
        pal = _object_palette(rng, (w, w))
        tex = _grain(w, vertical=False)[..., None]
        frame[distr] = (pal * tex)[distr].astype(np.int32)
    if mask.any():
        pal = _object_palette(rng, (w, w))
        tex = _grain(w, vertical=True)[..., None]
        frame[mask] = (pal * tex)[mask].astype(np.int32)
    return np.clip(frame, 0, 255).astype(np.uint8)


def synthetic_episode(rng: np.random.Generator, length: int = 600,
                      width: int = 64):
    """One episode: wander (no trunk) -> approach (growing trunk) ->
    chop (reward) -> wander. Returns (frames, rewards, gt_masks).

    Reward spacing is tuned so the gamma=0.98 discounted labels span
    the full [0, 1] range like trunk-filtered Treechop data: trunkless
    wander frames average value ~0.2 < --low-rew-thresh (0.3), visible
    trunk frames approach 1.0 > --high-rew-thresh (0.7) — so the
    critic's appearance->value mapping induces a clean pos/neg split
    (main.py:266-281)."""
    frames = np.empty((length, width, width, 3), np.uint8)
    rewards = np.zeros(length, np.float32)
    masks = np.zeros((length, width, width), bool)
    t = 0
    while t < length:
        wander = int(rng.integers(120, 180))
        for _ in range(min(wander, length - t)):
            frames[t] = _render(rng, np.zeros((width, width), bool))
            t += 1
        if t >= length:
            break
        approach = int(rng.integers(20, 30))
        center = int(rng.integers(16, width - 16))
        n = min(approach, length - t)  # fixed BEFORE t advances: the
        # reward must land on the final emitted approach frame even
        # when the episode truncates the approach
        for i in range(n):
            trunk_w = 3 + int(12 * i / approach)
            m = _trunk_mask(width, center, trunk_w)
            frames[t] = _render(rng, m)
            masks[t] = m
            rewards[t] = 1.0 if i == n - 1 else 0.0
            t += 1
    return frames, rewards, masks


def synthetic_episode_hard(rng: np.random.Generator,
                           length: int = 600, width: int = 64):
    """Hard-variant episode (module docstring): texture-defined
    reward, color-matched horizontal-grain distractors, nonstationary
    background. Distractors appear INDEPENDENTLY of the
    wander/approach phase (p=0.6 per frame) so their color/area
    carries ZERO information about reward — a color-histogram probe
    sits at chance (test_synthetic_hard.py pins this) and only the
    trunk's vertical grain predicts value; but they never carry
    reward themselves and GT stays trunk-only, so a masker that
    cannot tell the textures apart pays for every masked distractor
    pixel. Same phase structure and reward timing as the easy episode
    so the discounted-label geometry — and the pos/neg contrastive
    split thresholds (main.py:266-281) — carry over unchanged."""
    frames = np.empty((length, width, width, 3), np.uint8)
    rewards = np.zeros(length, np.float32)
    masks = np.zeros((length, width, width), bool)
    bg = _episode_background(rng)
    none = np.zeros((width, width), bool)

    def area_budget():
        # >= the max trunk footprint (15 px x 56 rows = 840), so the
        # budget is always fillable and palette-area is trunk-
        # independent
        return int(rng.integers(850, 1500))

    t = 0
    while t < length:
        wander = int(rng.integers(120, 180))
        for _ in range(min(wander, length - t)):
            d = _distractor_mask(rng, width, area_budget())
            frames[t] = _render_hard(rng, none, d, bg, t / length)
            t += 1
        if t >= length:
            break
        approach = int(rng.integers(20, 30))
        center = int(rng.integers(16, width - 16))
        n = min(approach, length - t)
        for i in range(n):
            trunk_w = 3 + int(12 * i / approach)
            m = _trunk_mask(width, center, trunk_w)
            d = _distractor_mask(
                rng, width, area_budget() - int(m.sum()), avoid=m)
            frames[t] = _render_hard(rng, m, d, bg, t / length)
            masks[t] = m
            rewards[t] = 1.0 if i == n - 1 else 0.0
            t += 1
    return frames, rewards, masks


_EPISODE_FNS = {"easy": synthetic_episode,
                "hard": synthetic_episode_hard}


def synthetic_dataset(n_frames: int = 4000, seed: int = 0,
                      width: int = 64,
                      gammas=(0.98, 0.97, 0.96, 0.95),
                      variant: str = "easy",
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(X, Y, I) in the collect_data contract (main.py:1295-1297).
    gammas: discount factors for label rows 1-4 — collect_data passes
    the parsed --gammas like the MineRL collector does.
    variant: 'easy' | 'hard' (module docstring)."""
    episode = _EPISODE_FNS[variant]
    rng = np.random.default_rng(seed)
    X = np.zeros((n_frames, width, width, 3), np.uint8)
    Y = np.zeros((7, n_frames), np.float32)
    I = np.zeros(n_frames, np.uint16)
    t = 0
    while t < n_frames:
        frames, rewards, _ = episode(rng, width=width)
        add = min(len(frames), n_frames - t)
        X[t:t + add] = frames[:add]
        Y[:, t:t + add] = build_label_matrix(rewards[:add], gammas)
        I[t:t + add] = np.arange(add)
        t += add
    return X, Y, I


def synthetic_eval_set(n_frames: int = 600, seed: int = 99,
                       width: int = 64, variant: str = "easy"):
    """Held-out labeled frames mirroring the red-trees eval contract
    (main.py:920-928): X uint8 (N,w,w,3), gt bool (N,w,w). Hard
    variant: gt stays trunk-only — masked distractors cost IoU."""
    episode = _EPISODE_FNS[variant]
    rng = np.random.default_rng(seed)
    X = np.zeros((n_frames, width, width, 3), np.uint8)
    gt = np.zeros((n_frames, width, width), bool)
    t = 0
    while t < n_frames:
        frames, _, masks = episode(rng, width=width)
        add = min(len(frames), n_frames - t)
        X[t:t + add] = frames[:add]
        gt[t:t + add] = masks[:add]
        t += add
    return X, gt
