"""Gradient-ascent input optimisation against the critic (PyTorch port
of `cgs_tpu/sandbox/dream.py`; reference `dream`,
TrainHandler.py:1522-1590): nudge frames toward a higher predicted value,
a what-does-the-critic-want visualisation.
"""

from __future__ import annotations

import torch


def dream(critic, x0: torch.Tensor, steps: int = 64, lr: float = 0.05,
          clip: bool = True, collect_every: int = 8):
    """x0 (B, 3, H, W) floats in [0, 1] on the critic's device. Each step
    moves x by lr * g / (max |g| + 1e-12), g the gradient of the batch's
    mean prediction, then clips to [0, 1]. Returns (the final frames,
    the trajectory (steps // collect_every, B, 3, H, W): the frames after
    each full collect_every-step chunk, the preds (steps, B) before each
    step). The critic runs in eval mode (no dropout), as the JAX
    function applies it."""
    was_training = critic.training
    critic.eval()
    x = x0.detach().clone()
    traj, preds = [], []
    try:
        for s in range(steps):
            x.requires_grad_(True)
            p = critic(x).squeeze(-1)
            g, = torch.autograd.grad(p.mean(), x)
            preds.append(p.detach())
            with torch.no_grad():
                x = x + lr * g / (g.abs().max() + 1e-12)
                if clip:
                    x = x.clamp(0.0, 1.0)
            if (s + 1) % collect_every == 0:
                traj.append(x)
    finally:
        critic.train(was_training)
    traj = torch.stack(traj) if traj else x0.new_zeros((0,) + x0.shape)
    return x.detach(), traj, torch.stack(preds)
