"""Offline `-process` throughput of the `swin_v2_t` pair: the Swin
Transformer V2-T critic with the paper's U-Net masker on its four
stages, built by the program's own `models/build.py:build_pair`
(`--critic swin_v2_t`), through `MaskPipeline.run` as
`handler.py:Handler.segment` builds it (wire u8, the hard plane, eval
mode: drop-path off).

`drivers/process_convnext_t.py` whole, taken by import: the pair is
built from the configuration's `critic`, and the window, the check and
the result are `drivers/process.py`'s. Only the yardstick that driver
reads from its module differs, swapped in around each of its steps: the
weights (`lib/shapes_swin_v2_t.py:seeded_params`), the FLOPs a frame
behind `mfu.process` (`lib/shapes_swin_v2_t.py`, the window attention
counted with the linears), and the reference the outputs are checked
against (`reference/swin_v2_t.py:forward_masks`). The critic's score
has no sigmoid, so `pred_gap` is the absolute gap of a raw score.
"""

from __future__ import annotations

import contextlib
from unittest import mock

from portbench.drivers import process_convnext_t as base
from portbench.lib import shapes_swin_v2_t
from portbench.reference import swin_v2_t as ref


@contextlib.contextmanager
def _yardstick():
    with mock.patch.object(base, "shapes_convnext_t", shapes_swin_v2_t), \
            mock.patch.object(base, "ref", ref):
        yield


class ProcessSwinV2T(base.ProcessConvNeXtT):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 faults=None):
        with _yardstick():
            super().__init__(cfg, traffic, seed, device, faults)

    def window(self, seconds: float, traced: bool) -> dict:
        with _yardstick():
            return super().window(seconds, traced)

    def verify(self) -> dict:
        with _yardstick():
            return super().verify()


def build(cfg, traffic, seed, device, faults=None):
    return ProcessSwinV2T(cfg, traffic, seed, device, faults)
