"""Reward-discount exploration (PyTorch port of `cgs_tpu/sandbox/dev.py`;
reference `dev`, TrainHandler.py:3693-3785): build six discount-variant
label rows over the pre-first-reward prefix of each episode — three
plain backward discounts (gamma 0.99/0.98/0.97) and three "nonrew"
variants that give every non-reward frame a -1 penalty accumulated
backward with gamma 0.99/0.95/0.90 (reward frames pinned at 0) — then
pickle the (7, N) matrix and plot a 2x2 histogram figure.

Each backward recursion is a float32 loop on the host. It is
sequential over at most N frames, one multiply-add a frame, with no
width to spread over a card: a device would spend its time on one
launch a frame. The float32 arithmetic is the JAX package's `lax.scan`
carry's. The figure is matplotlib's where it is installed, else four
PIL panels with the same titles (`utils/artifacts.py`).
"""

from __future__ import annotations

import gzip
import pickle
from typing import Sequence, Tuple

import numpy as np

from cgs_tpu_torch.utils.artifacts import (
    panel_grid, plot_histogram, pyplot_or_none, save_pil,
)

# (gamma, nonrew) pairs, TrainHandler.py:3745-3746
DEV_SPECS: Tuple[Tuple[float, int], ...] = (
    (0.99, 0), (0.98, 0), (0.97, 0),
    (0.99, -1), (0.95, -1), (0.90, -1),
)
# the figure's panels: (row of Y, title), TrainHandler.py:3771-3783
PANELS = ((0, "raw reward"), (1, "discount 0.99"), (2, "discount 0.98"),
          (3, "discount 0.97"))


def dev_discount_row(reward: np.ndarray, gamma: float,
                     nonrew: int = 0) -> np.ndarray:
    """One variant row. nonrew=0: plain backward discount
    r[t] += gamma * r[t+1] (uncapped, unlike the production
    collector's min(.,1) — TrainHandler.py:3757-3762 has no cap).
    nonrew=-1: non-reward frames start at -1 and accumulate
    gamma-discounted penalty backward; reward frames stay 0
    (TrainHandler.py:3749-3755)."""
    reward = (np.asarray(reward) > 0).astype(np.float32)
    base = (reward <= 0).astype(np.float32) * np.float32(nonrew) \
        if nonrew else reward
    g = np.float32(gamma)
    out = np.empty_like(base)
    nxt = np.float32(0.0)
    for t in range(len(base) - 1, -1, -1):
        if nonrew and base[t] == 0:
            nxt = np.float32(0.0)
        else:
            nxt = np.float32(base[t] + g * nxt)
        out[t] = nxt
    return out


def dev_label_matrix(rewards: Sequence[np.ndarray],
                     size: int) -> np.ndarray:
    """(7, size) matrix: row 0 stays zero like the reference (its X/Y
    row-0 writes are commented out, TrainHandler.py:3735-3737); rows
    1-6 carry the DEV_SPECS variants over begin-prefix episodes,
    concatenated until `size` frames."""
    y = np.zeros((7, size), np.float32)
    runidx = 0
    for reward in rewards:
        reward = np.asarray(reward)
        add = min(size - runidx, len(reward))
        reward = reward[:add]
        # begin-prefix: frames until (and including) the first reward
        if (reward > 0).any():
            add = int(np.argmax(reward > 0)) + 1
            reward = reward[:add]
        for row, (gamma, nonrew) in enumerate(DEV_SPECS):
            y[row + 1, runidx:runidx + add] = dev_discount_row(
                reward, gamma, nonrew)
        runidx += add
        if runidx >= size:
            break
    return y


def dev(rewards: Sequence[np.ndarray], size: int, out_pickle: str,
        out_png: str = "") -> np.ndarray:
    """Full dev() artifact pass: gzip-pickle Y and the 2x2 histogram
    figure (raw / 0.99 / 0.98 / 0.97 — TrainHandler.py:3771-3783;
    plt.show() becomes a saved PNG)."""
    y = dev_label_matrix(rewards, size)
    with gzip.GzipFile(out_pickle, "wb") as fp:
        pickle.dump(y, fp)
    if out_png:
        plt = pyplot_or_none()
        if plt is None:
            save_pil(out_png, panel_grid(
                [plot_histogram(y[row], title=title, size=(320, 240))
                 for row, title in PANELS], cols=2))
            return y
        fig, axs = plt.subplots(2, 2, sharex=True, sharey=True)
        for ax, (row, title) in zip(axs.flat, PANELS):
            ax.hist(y[row])
            ax.set_title(title)
        fig.savefig(out_png)
        plt.close(fig)
    return y
