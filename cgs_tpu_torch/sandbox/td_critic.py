"""TD(0)-bootstrapped critic training (PyTorch port of
`cgs_tpu/sandbox/td_critic.py`; reference `contrastive_critic_pipe`,
TrainHandler.py:568-747).

The critic bootstraps its own target from the frame `fskip` steps later:

    V_target = r_t + etha * stop_grad(V(s_{t+fskip}))
    loss     = MSE(V(s_t), V_target)            (TrainHandler.py:660-661)

One step: the two frame batches, each rolled by its own shift, ingested
by one `normalize_u8` launch into one joined batch, one critic pass over
it (dropout drawn once over the joined batch, as the masker step's fused
passes draw it), the loss, and one optimizer step.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from cgs_tpu_torch.ops.augment import draw_shift
from cgs_tpu_torch.ops.kernels import Segment
from cgs_tpu_torch.train.losses import ingest_segments, mse
from cgs_tpu_torch.train.steps import StepRng


def sarsa_pairs(x: np.ndarray, y_raw: np.ndarray, i: np.ndarray,
                fskip: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(idx_t, idx_tp, r_t) index pairs within episodes, the
    `collect_sarsa_dataset` contract (TrainHandler.py:3121-3427) over the
    (X, Y, I) arrays; an episode ends where the frame counter I
    resets."""
    n = len(x)
    ok = np.arange(n - fskip)
    same_ep = i[ok + fskip].astype(np.int64) - i[ok].astype(np.int64) \
        == fskip
    t = ok[same_ep]
    return t.astype(np.int32), (t + fskip).astype(np.int32), \
        y_raw[t].astype(np.float32)


def make_td_critic_step(cfg, critic, optimizer: torch.optim.Optimizer,
                        etha: float = 0.98) -> Callable:
    """step(xt_u8, xtp_u8, r (B,), rng: StepRng, shifts=None) -> loss:
    uint8 (B, 64, 64, 3) frame batches on the critic's device. With
    --shift, both batches roll (TrainHandler.py:642-644), by `shifts`
    (two ints) when given, else by two draws from `rng.shift`; dropout
    draws from `rng.dropout`."""
    max_shift = int(cfg.shift)

    def step(xt_u8: torch.Tensor, xtp_u8: torch.Tensor, r: torch.Tensor,
             rng: Optional[StepRng] = None,
             shifts: Optional[Sequence[int]] = None) -> torch.Tensor:
        if not max_shift:
            shifts = (0, 0)
        elif shifts is None:
            shifts = [draw_shift(max_shift, rng.shift) for _ in range(2)]
        x, _ = ingest_segments([Segment(xt_u8, None, int(shifts[0])),
                                Segment(xtp_u8, None, int(shifts[1]))])
        pred = critic(x, generator=None if rng is None
                      else rng.dropout).squeeze(-1)
        n = xt_u8.shape[0]
        loss = mse(pred[:n], r + etha * pred[n:].detach())
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
