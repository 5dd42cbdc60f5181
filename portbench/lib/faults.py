"""Faults planted under the timed path, and the lower-precision controls,
that a cell's correctness check must catch (`tools/control.py`, and the
CPU tests at a small size). Each is a context manager around a whole
run; `before_build(driver)` runs once the driver has set the program's
switches and before it builds anything.

    tf32            the program with TF32 on in cuDNN and cuBLAS
    bf16            (with the configuration's dtype set to bfloat16 by
                    the caller) the program's --bf16 path, TF32 left as a
                    fresh process has it
    state_unchanged an optimizer step that leaves the parameters alone
    half_batch      training: the loss terms' mean over half of the rows;
                    inference: the second half of each batch left out
                    (zeros in its outputs)
    answer_altered  inference: the first frame of each batch altered
                    where the pipeline writes it
"""

from __future__ import annotations

import contextlib
from unittest import mock

import torch

CONTROLS = ("tf32", "bf16")
FAULTS = ("state_unchanged", "half_batch", "answer_altered")


class Fault(contextlib.ExitStack):
    def __init__(self, name: str, driver_kind: str):
        super().__init__()
        if name not in CONTROLS + FAULTS:
            raise ValueError(f"unknown fault {name!r}")
        self.name, self.kind = name, driver_kind

    def before_build(self, driver) -> None:
        if self.name == "tf32":
            torch.backends.cudnn.allow_tf32 = True
            torch.backends.cuda.matmul.allow_tf32 = True
        elif self.name == "bf16":
            torch.backends.cudnn.allow_tf32 = True

    def __enter__(self):
        super().__enter__()
        patch = getattr(self, f"_{self.name}_{self.kind}", None)
        if patch is None:
            patch = getattr(self, f"_{self.name}", None)
        if patch is not None:
            patch()
        return self

    def _patch(self, target, name, new):
        self.enter_context(mock.patch.object(target, name, new))

    # -- training ----------------------------------------------------

    def _state_unchanged(self) -> None:
        self._patch(torch.optim.Adam, "step", lambda self, closure=None: None)

    def _half_batch_train_masker(self) -> None:
        from cgs_tpu_torch.train import losses

        def mse_rows(pred, target):
            half = max(1, pred.shape[1] // 2)
            return ((pred[:, :half] - target[:, :half]) ** 2).mean(1)

        self._patch(losses, "mse_rows", mse_rows)

    # -- inference ---------------------------------------------------

    def _half_batch_process(self) -> None:
        from cgs_tpu_torch.pipeline import MaskPipeline
        orig = MaskPipeline._forward_rows

        def forward_rows(pipe, u8):
            n = u8.shape[0]
            out = orig(pipe, u8[:max(1, n // 2)])
            return tuple(None if t is None else torch.cat(
                [t, torch.zeros((n - t.shape[0],) + t.shape[1:],
                                dtype=t.dtype, device=t.device)])
                for t in out)

        self._patch(MaskPipeline, "_forward_rows", forward_rows)

    def _answer_altered_process(self) -> None:
        from cgs_tpu_torch.pipeline import MaskPipeline
        orig = MaskPipeline._forward_rows

        def forward_rows(pipe, u8):
            out = list(orig(pipe, u8))
            out[0] = out[0].clone()
            out[0][0] += 0.25
            out[1] = out[1].clone()
            out[1][0] = (255 - out[1][0]) if out[1].dtype == torch.uint8 \
                else 1.0 - out[1][0]
            if len(out) > 3 and out[3] is not None:
                out[3] = out[3].clone()
                out[3][0] = 1 - out[3][0]
            return tuple(out)

        self._patch(MaskPipeline, "_forward_rows", forward_rows)


def applicable(kind: str):
    """The controls and faults a driver kind can have."""
    return {"process": ("tf32", "bf16", "half_batch", "answer_altered"),
            "train_masker": ("tf32", "bf16", "state_unchanged",
                             "half_batch")}[kind]
