"""Offline `-process` throughput: host frames through `MaskPipeline.run`
as `handler.py:Handler.segment` builds it (wire u8, the hard plane at
`--binarymaskthreshold`, eval mode), each call the whole host pool of
`pool_frames` frames made from the seed, over and over for the window. `frames_per_s` counts every frame whose outputs reached the
host in the window, over the window.

Check: after the window, the reference's eval-mode forward over the
whole pool, against the outputs of the last call in full and of a
sample of `sample_per_call` frames, drawn from the seed, of every
earlier call: the critic score (`pred_gap`), the u8 mask
(`level_gap`, in levels) and the hard plane (`hard_gap`).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.lib import compare, flops, trace
from portbench.lib.weights import device_frames, numpy_rng, seeded_params
from portbench.reference import model as ref


class Process:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 faults=None):
        from cgs_tpu_torch.core.device import train_switches
        from cgs_tpu_torch.models.critic import Critic
        from cgs_tpu_torch.models.decoder import UnetDecoder
        from cgs_tpu_torch.pipeline import MaskPipeline

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        if self.device.type == "cuda":
            train_switches(bf16=cfg["dtype"] == "bfloat16", train=False)
        if faults is not None:
            faults.before_build(self)
        self.params = seeded_params(cfg, seed, self.device)
        dt = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32
        critic = Critic(dims=cfg["dims"], bottleneck=cfg["neck"],
                        chfak=cfg["chfak"], dropout=cfg["dropout"],
                        compute_dtype=dt)
        masker = UnetDecoder(edims=cfg["dims"], ddims=cfg["dims"],
                             bottleneck=cfg["neck"],
                             masker_channels=cfg["masker_channels"],
                             chfak=cfg["chfak"], compute_dtype=dt)
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
        self.kept = []          # (rows, preds, levels, hard) of each call
        self.last = None        # the last call's outputs

    def _call(self):
        with trace.span("run"):
            return self.pipe.run(self.pool)

    def _keep(self, c: int, out) -> None:
        rows = numpy_rng(self.seed, "sample", c).choice(
            self.n_call, size=min(self.traffic["sample_per_call"],
                                  self.n_call), replace=False)
        self.kept.append((rows, out.preds[rows].copy(),
                          out.masks_u8[rows].copy(), out.hard[rows].copy()))
        self.last = out

    def window(self, seconds: float, traced: bool) -> dict:
        sync = (torch.cuda.synchronize if self.device.type == "cuda"
                else (lambda: None))
        calls, frames, t0 = 0, 0, time.perf_counter()
        timed_s = 0.0          # the calls that ran without the profiler
        timed_frames = 0
        summary, durations = None, []
        while True:
            elapsed = time.perf_counter() - t0
            if elapsed >= seconds and (summary is not None or not traced):
                break
            if traced and summary is None and calls >= 1:
                sink: dict = {}
                with trace.profiled(sink):
                    self._keep(calls, self._call())
                    sink["step"]()
                    with torch.profiler.record_function(trace.WINDOW):
                        out = self._call()
                        sync()
                    self._keep(calls + 1, out)
                summary = sink["summary"]
                calls += 2
                frames += 2 * self.n_call
                continue
            c0 = time.perf_counter()
            out = self._call()
            durations.append(time.perf_counter() - c0)
            timed_s += durations[-1]
            timed_frames += self.n_call
            self._keep(calls, out)
            calls += 1
            frames += self.n_call
        wall = time.perf_counter() - t0
        trace.print_durations("call", durations)
        fpf = flops.process_flops_per_frame(self.cfg)
        return {"attempted": frames, "failed": 0,
                "units": ("batch", frames // self.traffic["batch"]),
                "e2e": {"frames_per_s": frames / wall},
                "summary": summary,
                "layer": {"frames_traced": self.n_call,
                          "batch": self.traffic["batch"],
                          "flops_per_s": (fpf * timed_frames / timed_s
                                          if timed_s else None)}}

    def free(self) -> None:
        del self.pipe

    def verify(self) -> dict:
        pool = torch.from_numpy(self.pool).to(self.device)
        pred_ref, mask_ref = ref.forward_masks(self.params, pool)
        out = self.last
        sets = self.kept[:-1] + [(np.arange(self.n_call), out.preds,
                                  out.masks_u8, out.hard)]
        gaps = {"pred_gap": 0.0, "level_gap": 0.0, "hard_gap": 0.0}
        dev = self.device
        for r, preds, levels, hard in sets:
            r = torch.from_numpy(np.asarray(r)).to(dev)
            m = mask_ref.index_select(0, r)
            gaps["pred_gap"] = max(gaps["pred_gap"], compare.max_abs(
                torch.from_numpy(preds).to(dev), pred_ref.index_select(0, r)))
            gaps["level_gap"] = max(gaps["level_gap"], compare.level_gap(
                torch.from_numpy(levels).to(dev)[..., 0], m))
            gaps["hard_gap"] = max(gaps["hard_gap"], compare.hard_gap(
                torch.from_numpy(hard).to(dev)[..., 0], m, self.hard))
        return gaps


def build(cfg, traffic, seed, device, faults=None):
    return Process(cfg, traffic, seed, device, faults)
