"""Tracing and the debug-mode NaN/Inf guard (PyTorch port of
`cgs_tpu/utils/profiling.py:19-64`).

`Profiler` is `--profile DIR`: one `torch.profiler` trace over every
phase the CLI dispatches, written as one Chrome trace JSON into DIR
(viewable in Perfetto or chrome://tracing). It records CPU activity,
plus the card's kernels when the run is on `cuda`. torch.profiler holds
every event in host memory until the trace stops: a trace of a whole
`-train` run (millions of kernel launches) takes gigabytes, so trace a
short run.

`span(name)` names a region of the port's own host work (`cgs.pipeline.*`
in `pipeline.py`: `run`, `lead`, `pad`, `upload`, `forward`,
`read_back`, `tail` and `wait`; `cgs.train.*` in `train/loops.py` and
`train/steps.py`, `cgs.model.critic` and `cgs.model.masker` around each
critic and decoder forward of the pipeline and the training passes,
`models/build.py`, inside a ConvNeXt critic's `cgs.model.convnext.stem`,
`.stage1` ... `.stage4` and `.head`, `models/convnext.py`, and inside a
Swin critic's `cgs.model.swin.patch_embed`, `.stage1` ... `.stage4` and
`.head`, `models/swin.py`). While a torch.profiler
records on the calling thread, it is a `record_function` event, in the
same trace and on the same clock as the kernels and copies, under
`--profile` or any other profiler, and on exit it adds its duration on
the host's `time.perf_counter_ns`, read around the event, to
`span_ns[name]` and one to `span_calls[name]`: every span's totals, in
memory, kept only while a profiler records and never reset, so that a
reader takes ratios of totals recorded alike. Otherwise it is one
shared no-op context, which reads no clock and updates nothing.
`counts` holds the port's counters (`pipeline.rows`,
`pipeline.h2d_bytes`, `pipeline.d2h_bytes`, `pipeline.staged_batches`;
`model.critic_frames`, `model.masker_frames`, `model.bn_running` /
`model.bn_batch`, the BatchNorm layers applied on running and on batch
statistics, `model.layer_norms` and `model.dw_convs`, a ConvNeXt or
Swin critic's LayerNorm and depthwise layers, `model.window_attns`, a
Swin critic's window attention layers, `model.epilogue_fused` /
`model.epilogue_eager`, the convolutions of `Critic` and `UnetDecoder`
forwards whose bias, activation and pool ran as one `bias_act_pool`
launch or as PyTorch's own ops, `model.mask_heads`, the decoder
forwards whose mask head ran as one `mask_head` or `conv_mask_head`
launch, and `model.mask_head_convs`, those of them whose first
convolution ran inside `conv_mask_head`, `models/epilogue.py`), bumped
where the work is issued and never reset.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import Counter
from typing import Optional

import numpy as np
import torch

counts: Counter = Counter()
span_ns: Counter = Counter()      # span name -> nanoseconds inside it
span_calls: Counter = Counter()   # span name -> exits
_NO_SPAN = contextlib.nullcontext()


class _Span:
    """A `record_function` event that adds its duration to `span_ns`
    and its exit to `span_calls`."""

    __slots__ = ("name", "_event", "_t0")

    def __init__(self, name: str):
        self.name = name
        self._event = torch.profiler.record_function(name)

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self._event.__enter__()

    def __exit__(self, *exc):
        try:
            return self._event.__exit__(*exc)
        finally:
            span_ns[self.name] += time.perf_counter_ns() - self._t0
            span_calls[self.name] += 1


def span(name: str):
    """A named host region, timed into `span_ns` and `span_calls`, while
    a profiler records on this thread; otherwise the shared no-op
    context (one C call)."""
    if torch.autograd._profiler_enabled():
        return _Span(name)
    return _NO_SPAN


class Profiler:
    """start/stop a trace into `trace_dir` (None: every call is a
    no-op)."""

    def __init__(self, trace_dir: Optional[str] = None, device=None):
        self.trace_dir = trace_dir
        self.device = torch.device(device or "cpu")
        self.path: Optional[str] = None    # the last trace written
        self._prof = None

    def start(self) -> None:
        if not self.trace_dir or self._prof is not None:
            return
        from torch.profiler import ProfilerActivity, profile
        os.makedirs(self.trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=activities)
        self._prof.start()

    def stop(self) -> None:
        if self._prof is None:
            return
        prof, self._prof = self._prof, None
        prof.stop()
        self.path = os.path.join(
            self.trace_dir, f"trace-{os.getpid()}-{time.time_ns()}.json")
        prof.export_chrome_trace(self.path)

    @contextlib.contextmanager
    def trace(self):
        """start(), and stop() however the body ends."""
        self.start()
        try:
            yield self
        finally:
            self.stop()


def _leaves(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def nan_guard(tree, where: str = "") -> None:
    """Raise FloatingPointError on the first non-finite floating leaf
    of a nested dict/list of tensors or arrays (`-debug_nan`)."""
    for name, leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            bad = leaf.is_floating_point() and not bool(
                torch.isfinite(leaf).all())
        elif isinstance(leaf, np.ndarray):
            bad = np.issubdtype(leaf.dtype, np.floating) and not bool(
                np.isfinite(leaf).all())
        else:
            continue
        if bad:
            raise FloatingPointError(f"non-finite values in {where}{name}")
