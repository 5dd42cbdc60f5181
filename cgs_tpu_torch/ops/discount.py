"""Reward discounting (port of `cgs_tpu/ops/discount.py`).

The reference computes, per trajectory and per gamma, a backward
recursion over binarized rewards (main.py:1336-1346):

    r[t] = min(r[t] + gamma * r[t+1], 1)        (t from T-2 down to 0)

Here it is a reverse loop in float32 over all gammas at once; gamma is
cast to float32 first, as JAX's weak typing does inside its
`lax.scan`. Labelling runs once per dataset on the host.
"""

from __future__ import annotations

import numpy as np


def discount_rewards(reward: np.ndarray, gamma) -> np.ndarray:
    """Backward min-capped discounted return(s) of a binary reward
    sequence. reward: (T,); gamma: a float or a (G,) array. Returns
    (T,) or (G, T) float32."""
    r = np.asarray(reward, np.float32)
    g = np.asarray(gamma, np.float32)
    out = np.empty(g.shape + r.shape, np.float32)
    carry = np.zeros(g.shape, np.float32)
    one = np.float32(1.0)
    for t in range(r.shape[0] - 1, -1, -1):
        carry = np.minimum(r[t] + g * carry, one)
        out[..., t] = carry
    return out


def build_label_matrix(reward: np.ndarray,
                       gammas=(0.98, 0.97, 0.96, 0.95),
                       rows: int = 7) -> np.ndarray:
    """7-row label matrix of a trajectory (main.py:1296,1333-1346):
    row 0 = binarized raw reward, rows 1..len(gammas) = discounted
    variants, remaining rows zero (the reference allocates 7 and fills
    5)."""
    reward = (np.asarray(reward) > 0).astype(np.float32)
    out = np.zeros((rows, reward.shape[0]), np.float32)
    out[0] = reward
    if len(gammas):
        out[1:1 + len(gammas)] = discount_rewards(
            reward, np.asarray([float(g) for g in gammas]))
    return out
