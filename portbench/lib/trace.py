"""The traced part of a `--trace 1` run, read from torch.profiler.

A driver profiles one steady stretch of its window: `profiled(...)`
runs a warm-up call whose events are dropped, then the active call
inside the span `portbench.window`, which is the traced window. The
benchmark's own spans (`record_function('portbench.<call>')`) and the
program's ATen operations are the host side of the trace; kernels,
copies and fills are the device side.

`Summary` reduces it: the device's busy time as the union of its
intervals inside the window (kernels that overlap count once), the
device operations by name, and the idle gaps between busy intervals,
each named by the innermost host span or operation that was open at
its midpoint.
"""

from __future__ import annotations

import contextlib
import heapq
import sys
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch

WINDOW = "portbench.window"
NO_HOST_OP = "host: no traced operation"
_SKIP = ("Context Sync",)


def print_durations(unit: str, durations: List[float]) -> None:
    """The spread of the window's untraced calls, on standard error: a
    run whose calls vary widely was disturbed inside the window, one
    whose calls agree but whose rate differs from another run's was
    slowed as a whole."""
    if durations:
        d = sorted(durations)
        print(f"[{unit}s] {len(d)}: min {d[0]:.4f} median "
              f"{d[len(d) // 2]:.4f} max {d[-1]:.4f} s", file=sys.stderr)


def span(name: str):
    """A host span of the benchmark's own, visible in a trace."""
    return torch.profiler.record_function("portbench." + name)


@contextlib.contextmanager
def profiled(sink: dict, host: bool = True):
    """Profile a warm-up step and an active step: the caller runs its
    warm-up call, calls `sink['step']()`, then its traced call inside
    `record_function(WINDOW)`; on exit `sink['summary']` holds the
    `Summary`. host=False traces the device alone, for work launched
    from threads of the program's own (with the host's operations
    traced, the device's events from other threads go missing); the
    window is then the device's events' span inside the trace's
    active step, and the gaps go unnamed."""
    from torch.profiler import ProfilerActivity, profile, schedule

    acts = [ProfilerActivity.CPU] if host else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    acts = acts or [ProfilerActivity.CPU]      # a CPU-only test run
    prof = profile(activities=acts,
                   schedule=schedule(wait=0, warmup=1, active=1, repeat=1))
    warnings.filterwarnings("ignore", message="Profiler clears events")
    prof.start()
    sink["step"] = prof.step
    try:
        yield sink
        prof.step()
    finally:
        prof.stop()
    sink["summary"] = Summary.from_events(prof.events(),
                                          sink.get("window_s"))


def _merge(intervals: List[Tuple[float, float]]):
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@dataclass
class Summary:
    window_s: float
    busy_s: float
    device: List[Tuple[float, float, str]]        # us, inside the window
    gaps: List[Tuple[float, str]] = field(default_factory=list)  # (s, name)

    @classmethod
    def from_events(cls, events, window_s=None) -> "Summary":
        """window_s: without a host trace, the window's length on the
        host clock; it is laid over the device events' span, centred."""
        cuda = torch.autograd.DeviceType.CUDA
        win = [(e.time_range.start, e.time_range.end) for e in events
               if e.name == WINDOW and e.device_type != cuda]
        if win:
            w0, w1 = win[-1]
        elif window_s is not None:
            dev_t = [t for e in events if e.device_type == cuda
                     for t in (e.time_range.start, e.time_range.end)]
            mid = 0.5 * (min(dev_t) + max(dev_t)) if dev_t else 0.0
            w0, w1 = mid - 5e5 * window_s, mid + 5e5 * window_s
        else:
            raise RuntimeError("the trace holds no portbench.window span")
        dev, host = [], []
        for e in events:
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                if (getattr(e, "is_user_annotation", False)
                        or e.name in _SKIP or e.name.startswith(
                            ("portbench.", "ProfilerStep"))):
                    continue
                if b > w0 and a < w1:
                    dev.append((a, b, e.name))
            elif (e.name != WINDOW and not e.name.startswith("ProfilerStep")
                  and b > w0 and a < w1):
                host.append((a, b, e.name))
        busy = _merge([(max(a, w0), min(b, w1)) for a, b, _ in dev])
        busy_us = sum(b - a for a, b in busy)
        holes, t = [], w0
        for a, b in busy:
            if a > t:
                holes.append((t, a))
            t = max(t, b)
        if t < w1:
            holes.append((t, w1))
        return cls(window_s=(w1 - w0) / 1e6, busy_s=busy_us / 1e6,
                   device=dev, gaps=_name_gaps(holes, host))

    @property
    def idle_share(self) -> float:
        return max(0.0, 1.0 - self.busy_s / self.window_s)

    def device_time_s(self, match: Callable[[str], bool]) -> float:
        return sum(b - a for a, b, n in self.device if match(n)) / 1e6

    def device_count(self, match: Callable[[str], bool] = lambda n: True
                     ) -> int:
        return sum(1 for _, _, n in self.device if match(n))

    def breakdown(self, top: int = 10) -> dict:
        ops: Dict[str, float] = defaultdict(float)
        for a, b, n in self.device:
            ops[n[:120]] += (b - a) / 1e6
        gaps: Dict[str, float] = defaultdict(float)
        for s, n in self.gaps:
            gaps[n[:120]] += s
        return {"device_ops": sorted(([k, v] for k, v in ops.items()),
                                     key=lambda kv: -kv[1])[:top],
                "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                    key=lambda kv: -kv[1])[:top]}


def _name_gaps(holes, host) -> List[Tuple[float, str]]:
    """Each idle interval (us) as (seconds, the innermost host event
    open at its midpoint): of the events that cover it, the one that
    started last."""
    host = sorted(host)
    heap: list = []
    out, i = [], 0
    for a, b in sorted(holes):
        t = 0.5 * (a + b)
        while i < len(host) and host[i][0] <= t:
            heapq.heappush(heap, (-host[i][0], host[i][1], host[i][2]))
            i += 1
        while heap and heap[0][1] < t:
            heapq.heappop(heap)
        out.append(((b - a) / 1e6, heap[0][2] if heap else NO_HOST_OP))
    return out


def is_kernel(names: Tuple[str, ...]) -> Callable[[str], bool]:
    low = tuple(s.lower() for s in names)
    return lambda n: any(s in n.lower() for s in low)


def is_copy(n: str) -> bool:
    return n.startswith("Memcpy")
