"""Chunks of training steps over device-resident uint8 banks (PyTorch
port of `cgs_tpu/train/loops.py:68-271`).

The frame banks stay on the card for the whole phase; a chunk checks
its (S, B) index stacks on the host (a gather in a kernel does not
check its indices) and uploads them, and runs its S steps as a Python
loop; each step's ingest kernel gathers its batch from the banks by
index. The losses stay on the device, are stacked once per chunk and
come down once per chunk (the caller's `.cpu()`).
A chunk runs only its real steps, so the JAX package's padded tail
steps (`_masked_merge`) have no counterpart. Chunk sizes follow the
viz cadence: the reference's hard-coded 100 batches in the critic
phase (main.py:204) and --visevery in the masker phase (main.py:466).

Over a mesh (`parallel/mesh.py`; port of `cgs_tpu/train/loops.py:
41-56,121-126,225-233`), every rank holds the whole banks and the whole
index stacks, drawn alike on every rank, and takes its rows of each
index row: its 1/N of the critic's (B,) rows; of the masker's, its 1/N
of the K high, of the K low and of each half of the 2K contrast rows,
so that row i of A and row i of B, a pair in the merges and the loss,
stay on one rank. A batch that does not divide runs whole on every rank
(`Mesh.rows`). The chunk's losses are averaged over the ranks with one
`all_reduce` (rank 0's when every rank ran the whole batch).

The viz functions recompute the annotated-strip inputs at a chunk
boundary from the current weights, with fresh shift and dropout
draws, as the JAX package does.

On one card `masker_chunk` replays one captured CUDA graph a step
(`train/graph.py`); over a mesh or on the CPU it runs its steps
eagerly. The counters `train.graph_steps`
and `train.eager_steps` (`utils/profiling.counts`) count its steps by
path.

Under a profiler a chunk names its host work (`utils/profiling.py:
span`): `cgs.train.critic_chunk` / `cgs.train.masker_chunk` around the
chunk, `cgs.train.upload_indices` around the index check and upload,
each step's own spans (`train/steps.py`, `train/graph.py`), and
`cgs.train.stack_losses` around the losses' stack.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from cgs_tpu_torch.ops.augment import shift_batch
from cgs_tpu_torch.ops.kernels import Segment
from cgs_tpu_torch.ops.merge import inject_merge
from cgs_tpu_torch.train import graph
from cgs_tpu_torch.train.losses import build_masker_loss, ingest
from cgs_tpu_torch.train.steps import (
    StepRng, critic_step, masker_batch, masker_step,
)
from cgs_tpu_torch.utils.profiling import counts, span


def _upload(idx, bound: int, device) -> torch.Tensor:
    """An index stack on the device, after checking on the host that
    every index lies in [0, bound)."""
    idx = np.ascontiguousarray(idx, np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= bound):
        raise IndexError(f"index stack out of range [0, {bound}): "
                         f"min {idx.min()}, max {idx.max()}")
    return torch.from_numpy(idx).to(device)


def _chunk_losses(losses: list, mesh, whole: bool) -> torch.Tensor:
    """A chunk's 0-dim losses stacked: over a mesh the ranks' mean, or
    rank 0's when every rank ran the whole batch."""
    with span("cgs.train.stack_losses"):
        losses = torch.stack(losses)
        if mesh is None:
            return losses
        return mesh.broadcast_(losses) if whole else mesh.mean_(losses)


def critic_chunk(cfg, critic, optimizer, x_bank: torch.Tensor,
                 y_bank: torch.Tensor, idx: np.ndarray,
                 rng: StepRng, mesh=None) -> torch.Tensor:
    """S critic steps over the banks with idx (S, B); returns the (S,)
    losses on the device. Over a mesh each rank runs its rows of idx."""
    with span("cgs.train.critic_chunk"):
        whole = mesh is not None and not mesh.divides(idx.shape[1])
        if mesh is not None:
            idx = idx[:, mesh.rows(idx.shape[1])]
        with span("cgs.train.upload_indices"):
            idx_dev = _upload(idx, x_bank.shape[0], x_bank.device)
        losses = [critic_step(cfg, critic, optimizer,
                              Segment(x_bank, bidx, labels=y_bank), rng,
                              mesh, whole)
                  for bidx in idx_dev]
        return _chunk_losses(losses, mesh, whole)


def critic_viz(cfg, critic, x_bank, y_bank, bidx: np.ndarray,
               rng: StepRng):
    """(x_u8 shifted, y, pred) of one batch, the annotated-strip inputs
    (main.py:204-226); dropout as in training."""
    bidx = _upload(bidx, x_bank.shape[0], x_bank.device)
    xb = x_bank.index_select(0, bidx)
    if cfg.shift:
        xb = shift_batch(xb, int(cfg.shift), rng.shift)
    with torch.no_grad():
        pred = critic(ingest(xb), generator=rng.dropout).squeeze(-1)
    return xb, y_bank.index_select(0, bidx), pred


def _masker_segments(xpos, ypos, xneg, yneg, h, l, c):
    """A = [pos[h] || neg[l]] with its labels, B = neg[c]
    (main.py:344-361)."""
    return ([Segment(xpos, h, labels=ypos), Segment(xneg, l, labels=yneg)],
            Segment(xneg, c))


def _upload_masker(xpos, xneg, hidx, lidx, cidx):
    n_pos, n_neg, dev = xpos.shape[0], xneg.shape[0], xpos.device
    return (_upload(hidx, n_pos, dev), _upload(lidx, n_neg, dev),
            _upload(cidx, n_neg, dev))


def masker_rows(mesh, hidx: np.ndarray, lidx: np.ndarray,
                cidx: np.ndarray):
    """(hidx, lidx, cidx, whole): this rank's rows of a masker chunk's
    index stacks, keeping A's row i and B's row i together: its share of
    the K high, of the K low, and of each half of the 2K contrast
    rows."""
    k = hidx.shape[1]
    if not mesh.divides(k):
        return hidx, lidx, cidx, True
    rows = mesh.rows(k)
    return (hidx[:, rows], lidx[:, rows],
            np.concatenate([cidx[:, :k][:, rows], cidx[:, k:][:, rows]],
                           axis=1), False)


def masker_chunk(cfg, models: Dict[str, torch.nn.Module], optimizer,
                 xpos, ypos, xneg, yneg, hidx: np.ndarray,
                 lidx: np.ndarray, cidx: np.ndarray, rng: StepRng,
                 mesh=None, fuse: str = "both") -> torch.Tensor:
    """S masker steps with index stacks hidx (S, K), lidx (S, K), cidx
    (S, 2K); returns the (S, 4) loss terms (replace, inject, norm,
    critic) on the device. Over a mesh each rank runs its rows
    (`masker_rows`). fuse: as `masker_step`'s. Where `graph.engages`,
    each step replays the captured step (`graph.masker_steps`)."""
    with span("cgs.train.masker_chunk"):
        whole = False
        if mesh is not None:
            hidx, lidx, cidx, whole = masker_rows(mesh, hidx, lidx, cidx)
        with span("cgs.train.upload_indices"):
            h, l, c = _upload_masker(xpos, xneg, hidx, lidx, cidx)
        steps = [_masker_segments(xpos, ypos, xneg, yneg, h[s], l[s], c[s])
                 for s in range(h.shape[0])]
        if steps and graph.engages(mesh, xpos.device):
            return graph.masker_steps(cfg, models, optimizer, steps, rng,
                                      fuse, (xpos, ypos, xneg, yneg))
        terms = []
        for a, b in steps:
            terms.extend(masker_step(cfg, models, optimizer, a, b, rng,
                                     mesh, whole, fuse))
        counts["train.eager_steps"] += len(steps)
        return _chunk_losses(terms, mesh, whole).view(-1, 4)


def masker_viz(cfg, models, xpos, ypos, xneg, yneg, h: np.ndarray,
               l: np.ndarray, c: np.ndarray, rng: StepRng) -> dict:
    """The 7-row merge-viz tensors (main.py:466-530), NHWC: a, b, z,
    replaced, injected, and the annotation vectors y, pred, negpred,
    replacevalue, injectvalue."""
    a, b = _masker_segments(xpos, ypos, xneg, yneg,
                            *_upload_masker(xpos, xneg, h, l, c))
    ab, y, n = masker_batch(cfg, a, b, rng)
    a, b = ab[:n], ab[n:]
    with torch.no_grad():
        _, aux = build_masker_loss(cfg)(models, a, y, b, rng.dropout,
                                        ab=ab)
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
