"""Host -> device data staging (port of `cgs_tpu/data/loader.py`).

The uint8 dataset goes to the card once (100k x 64x64x3 = 1.2 GB), and
each epoch draws only shuffled index stacks; the trainers' ingest
kernel gathers each batch from the bank by those indices as it
normalises it (`ops/kernels.py:gather_normalize_u8`, through
`train/losses.py:ingest_segments`). `EpochLoader` is the JAX package's numpy code as it is, so one numpy
seed gives both packages the same batch order.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass
class DataBundle:
    """Train/test split per the reference contract (main.py:113-123):
    last `testsize` frames are held out; optional reward binarization
    at threshrew."""
    x_train: np.ndarray      # (N, 64, 64, 3) uint8 (host)
    y_train: np.ndarray      # (7, N) float32 (host)
    i_train: np.ndarray
    x_test: np.ndarray
    y_test: np.ndarray
    i_test: np.ndarray
    x_train_dev: Optional[torch.Tensor] = None   # device-resident u8
    y_train_dev: Optional[torch.Tensor] = None   # (N,) row rewidx

    @classmethod
    def from_arrays(cls, x, y, i, cfg) -> "DataBundle":
        ts = cfg.testsize
        xtr, ytr, itr = x[:-ts], y[:, :-ts], i[:-ts]
        xte, yte, ite = x[-ts:], y[:, -ts:], i[-ts:]
        if cfg.threshrew:  # main.py:120-122
            ytr = (ytr > cfg.threshrew).astype(np.float32)
            yte = (yte > cfg.threshrew).astype(np.float32)
        return cls(xtr, ytr, itr, xte, yte, ite)

    def to_device(self, cfg, device) -> "DataBundle":
        """The uint8 train frames and the label row `rewidx` onto
        `device`."""
        self.x_train_dev = torch.from_numpy(
            np.ascontiguousarray(self.x_train)).to(device)
        self.y_train_dev = torch.from_numpy(np.ascontiguousarray(
            self.y_train[cfg.rewidx], np.float32)).to(device)
        return self

    @property
    def n_train(self) -> int:
        return int(self.x_train.shape[0])


class EpochLoader:
    """Shuffled batch-index stacks, chunked at the viz cadence."""

    def __init__(self, n: int, batch: int, rng: np.random.Generator,
                 drop_last: bool = False):
        self.n = n
        self.batch = batch
        self.rng = rng
        self.drop_last = drop_last

    def epoch_steps(self) -> int:
        return self.n // self.batch if self.drop_last else \
            -(-self.n // self.batch)

    def epoch_indices(self) -> np.ndarray:
        """(steps, batch) int32; the ragged tail wraps around (the
        reference's DataLoader keeps partial batches — static shapes
        need the wrap; one epoch still touches every frame)."""
        perm = self.rng.permutation(self.n).astype(np.int32)
        steps = self.epoch_steps()
        total = steps * self.batch
        if total > self.n:
            # cyclic repeat handles n < batch too (a 30-frame dataset
            # with batch 64 wraps the permutation twice-plus)
            perm = np.resize(perm, total)
        return perm[:total].reshape(steps, self.batch)

    def chunks(self, chunk_steps: int) -> Iterator[np.ndarray]:
        idx = self.epoch_indices()
        for lo in range(0, idx.shape[0], chunk_steps):
            yield idx[lo:lo + chunk_steps]
