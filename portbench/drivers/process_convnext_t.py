"""Offline `-process` throughput of the `convnext_t` pair: the ConvNeXt-T
critic with the paper's U-Net masker on its four stages, built by the
program's own `models/build.py:build_pair` (`--critic convnext_t`),
through `MaskPipeline.run` as `handler.py:Handler.segment` builds it
(wire u8, the hard plane, eval mode: drop-path off).

The window, the check and the result are `drivers/process.py`'s, taken
by import: the pool of seeded frames handed whole to each call, the
calls counted into `frames_per_s`, the last call checked in full and a
sample of each earlier one. Only the yardstick differs: the weights
(`lib/shapes_convnext_t.py:seeded_params`), the FLOPs a frame behind
`mfu.process` (`lib/shapes_convnext_t.py`), and the reference the
outputs are checked against (`reference/convnext_t.py:forward_masks`).
The critic's score has no sigmoid, so `pred_gap` is the absolute gap of
a raw score.
"""

from __future__ import annotations

import contextlib
import types
from unittest import mock

import torch

from portbench.drivers import process
from portbench.lib import shapes_convnext_t
from portbench.lib.weights import device_frames
from portbench.reference import convnext_t as ref


@contextlib.contextmanager
def _yardstick(cfg: dict):
    """`drivers/process.py`'s window and check with this configuration's
    FLOPs and reference in place of the chfak ones."""
    fpf = shapes_convnext_t.process_flops_per_frame(cfg)
    flops = types.SimpleNamespace(process_flops_per_frame=lambda _: fpf)
    with mock.patch.object(process, "flops", flops), \
            mock.patch.object(process, "ref", ref):
        yield


class ProcessConvNeXtT(process.Process):
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 faults=None):
        from cgs_tpu_torch.core.config import Config
        from cgs_tpu_torch.core.device import train_switches
        from cgs_tpu_torch.models.build import build_pair
        from cgs_tpu_torch.pipeline import MaskPipeline

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        if self.device.type == "cuda":
            train_switches(bf16=cfg["dtype"] == "bfloat16", train=False)
        if faults is not None:
            faults.before_build(self)
        dt = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32
        critic, masker = build_pair(Config(critic_arch=cfg["critic"]), dt)
        self.params = shapes_convnext_t.seeded_params(cfg, seed, self.device)
        self.hard = float(traffic["hard_threshold"])
        self.pipe = MaskPipeline(critic, masker, self.params,
                                 batch_size=traffic["batch"],
                                 wire=traffic["wire"],
                                 hard_threshold=self.hard, eval_mode=True,
                                 device=self.device)
        pool_dev = device_frames(traffic["pool_frames"], seed, self.device)
        self.pool = pool_dev.cpu().numpy()
        del pool_dev
        self.n_call = self.pool.shape[0]
        # warm the cell's one batch shape and the in-flight read-back
        self.pipe.run(self.pool[:2 * traffic["batch"]])
        self.kept = []
        self.last = None

    def window(self, seconds: float, traced: bool) -> dict:
        with _yardstick(self.cfg):
            return super().window(seconds, traced)

    def verify(self) -> dict:
        with _yardstick(self.cfg):
            return super().verify()


def build(cfg, traffic, seed, device, faults=None):
    return ProcessConvNeXtT(cfg, traffic, seed, device, faults)
