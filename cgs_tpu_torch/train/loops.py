"""Chunks of training steps over device-resident uint8 banks (PyTorch
port of `cgs_tpu/train/loops.py:68-271`).

The frame banks stay on the card for the whole phase; a chunk uploads
only its (S, B) index stack, gathers each batch on the card with
`index_select`, and runs its S steps as a Python loop. The losses stay
on the device and come down once per chunk (the caller's `.cpu()`).
A chunk runs only its real steps, so the JAX package's padded tail
steps (`_masked_merge`) have no counterpart. Chunk sizes follow the
viz cadence: the reference's hard-coded 100 batches in the critic
phase (main.py:204) and --visevery in the masker phase (main.py:466).

The viz functions recompute the annotated-strip inputs at a chunk
boundary from the current weights, with fresh shift and dropout
draws, as the JAX package does.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cgs_tpu_torch.ops.augment import shift_batch
from cgs_tpu_torch.ops.merge import inject_merge
from cgs_tpu_torch.train.losses import build_masker_loss, ingest
from cgs_tpu_torch.train.steps import StepRng, critic_step, masker_step


def _upload(idx, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(idx, np.int64)).to(device)


def critic_chunk(cfg, critic, optimizer, x_bank: torch.Tensor,
                 y_bank: torch.Tensor, idx: np.ndarray,
                 rng: StepRng) -> torch.Tensor:
    """S critic steps over the banks with idx (S, B); returns the (S,)
    losses on the device."""
    idx_dev = _upload(idx, x_bank.device)
    losses = torch.empty(idx_dev.shape[0], device=x_bank.device)
    for s in range(idx_dev.shape[0]):
        bidx = idx_dev[s]
        losses[s] = critic_step(cfg, critic, optimizer,
                                x_bank.index_select(0, bidx),
                                y_bank.index_select(0, bidx), rng)
    return losses


def critic_viz(cfg, critic, x_bank, y_bank, bidx: np.ndarray,
               rng: StepRng):
    """(x_u8 shifted, y, pred) of one batch, the annotated-strip inputs
    (main.py:204-226); dropout as in training."""
    bidx = _upload(bidx, x_bank.device)
    xb = x_bank.index_select(0, bidx)
    if cfg.shift:
        xb = shift_batch(xb, int(cfg.shift), rng.shift)
    with torch.no_grad():
        pred = critic(ingest(xb), generator=rng.dropout).squeeze(-1)
    return xb, y_bank.index_select(0, bidx), pred


def _masker_batch(xpos, ypos, xneg, yneg, h, l, c):
    """A = [pos[h] || neg[l]], Y likewise, B = neg[c] (main.py:344-361)."""
    a_u8 = torch.cat([xpos.index_select(0, h), xneg.index_select(0, l)])
    y = torch.cat([ypos.index_select(0, h), yneg.index_select(0, l)])
    return a_u8, y, xneg.index_select(0, c)


def masker_chunk(cfg, models: Dict[str, torch.nn.Module], optimizer,
                 xpos, ypos, xneg, yneg, hidx: np.ndarray,
                 lidx: np.ndarray, cidx: np.ndarray, rng: StepRng
                 ) -> torch.Tensor:
    """S masker steps with index stacks hidx (S, K), lidx (S, K), cidx
    (S, 2K); returns the (S, 4) loss terms (replace, inject, norm,
    critic) on the device."""
    dev = xpos.device
    h, l, c = (_upload(i, dev) for i in (hidx, lidx, cidx))
    losses = torch.empty((h.shape[0], 4), device=dev)
    for s in range(h.shape[0]):
        a_u8, y, b_u8 = _masker_batch(xpos, ypos, xneg, yneg, h[s], l[s],
                                      c[s])
        losses[s] = masker_step(cfg, models, optimizer, a_u8, y, b_u8,
                                rng)
    return losses


def masker_viz(cfg, models, xpos, ypos, xneg, yneg, h: np.ndarray,
               l: np.ndarray, c: np.ndarray, rng: StepRng) -> dict:
    """The 7-row merge-viz tensors (main.py:466-530), NHWC: a, b, z,
    replaced, injected, and the annotation vectors y, pred, negpred,
    replacevalue, injectvalue."""
    dev = xpos.device
    a_u8, y, b_u8 = _masker_batch(xpos, ypos, xneg, yneg,
                                  *(_upload(i, dev) for i in (h, l, c)))
    if cfg.shift:
        a_u8 = shift_batch(a_u8, int(cfg.shift), rng.shift)
    a, b = ingest(a_u8), ingest(b_u8)
    with torch.no_grad():
        _, aux = build_masker_loss(cfg)(models, a, y, b, rng.dropout)
    z = aux["z"]
    # without -inject the loss makes no injected frame; the strip shows
    # one all the same, as in the JAX package
    injected = aux["injected"] if cfg.inject else inject_merge(a, b, z)

    def nhwc(t):
        return t.permute(0, 2, 3, 1)

    return {"a": nhwc(a), "b": nhwc(b), "z": nhwc(z),
            "replaced": nhwc(aux["replaced"]), "injected": nhwc(injected),
            "y": y, "pred": aux["pred"], "negpred": aux["negpred"],
            "replacevalue": aux["replacevalue"],
            "injectvalue": aux["injectvalue"]}
