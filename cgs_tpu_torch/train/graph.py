"""The masker step as one captured CUDA graph: `train/loops.py:
masker_chunk`'s path on one card.

On a CUDA device and without a mesh (the gradient collectives stay
eager; `engages`), a chunk replays one graph a step in place of the
step's ~330 eager launches, in float32 and under bfloat16 autocast
alike (the autocast regions open and close inside the captured
forwards, so no cast outlives the capture). The graph holds the
step from the ingest's output to the last gradient: the critic passes,
the decoder, the merges, the loss terms and the whole backward, with
the port's hand-written kernels (`cgs_upsample2x(_bwd)`,
`cgs_merge_pair(_bwd)`) among its nodes. Around each replay the host
launches, as the eager step does:
- the ingest (`gather_normalize_u8`, one `normalize_u8` launch), with
  the step's index rows and its shift draw as launch arguments, into
  the graph's static frames and labels buffers;
- after the replay, the optimizer's own step, unchanged (Adam foreach,
  its step count on the host), reading the gradients the graph writes
  into its static buffers; and a copy of the step's four loss terms
  into its row of the chunk's (S, 4) output.

Dropout draws from the step's generator (`StepRng.dropout`), registered
with the graph: each replay draws what the eager step would draw from
the generator's state at that point and advances it alike, so eager
draws between replays (`masker_viz`, a restored state) keep their place
in the stream.

A graph belongs to its optimizer (a `WeakKeyDictionary`) and to the
generator it was captured with, and is keyed on what it captured
(`_key`): the data of the models' parameters and buffers, of the
optimizer's state and of the banks, the row counts, `fuse`, the loss
flags, the models' modes and compute dtypes. When the key changes (as
`optimizer.load_state_dict` replaces the state tensors) the next step
recaptures. An optimizer that has not stepped here in this process
first runs one eager step on the capture stream: it makes the
optimizer's state and primes cuDNN, cuBLAS and autograd on that stream,
so the capture makes no first-use call.

Counters (`utils/profiling.counts`): `train.graph_captures`,
`train.graph_steps` (steps that replayed the graph) and
`train.eager_steps` (steps run eagerly, by `masker_chunk`'s other path
too). A capture issues no work, so it leaves `ops/_build.launches` and
`counts` as they were; each replay adds what the capture would have
issued (the kernels' launches, the model counters). Under a profiler
each step is the span `cgs.train.masker_step`, with `cgs.train.batch`
around the ingest and `cgs.train.replay` around the replay.
"""

from __future__ import annotations

import itertools
import weakref
from collections import Counter
from typing import Dict, List, Sequence, Tuple

import torch

from cgs_tpu_torch.ops import _build
from cgs_tpu_torch.ops.kernels import Segment
from cgs_tpu_torch.train.steps import (
    TERMS, StepRng, masker_batch, masker_loss, masker_step,
)
from cgs_tpu_torch.utils.profiling import counts, span

# the loss flags a captured step depends on (`train/losses.py`)
FLAGS = ("inject", "live", "separate", "staticnorm", "threshrew", "L1",
         "L2", "lfak")

_graphs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_warmed: "weakref.WeakSet" = weakref.WeakSet()
_streams: Dict[int, "torch.cuda.Stream"] = {}


def engages(mesh, device) -> bool:
    """Whether `masker_chunk` replays a graph: on a CUDA device, with no
    mesh."""
    return device.type == "cuda" and mesh is None


def _key(cfg, models, optimizer, banks, rows, fuse) -> tuple:
    tensors = [t for m in models.values()
               for t in itertools.chain(m.parameters(), m.buffers())]
    state = [t for st in optimizer.state.values() for t in st.values()
             if isinstance(t, torch.Tensor)]
    return (tuple(models), rows, fuse,
            tuple(getattr(cfg, f) for f in FLAGS),
            tuple(t.data_ptr() for t in tensors),
            tuple(p.requires_grad for m in models.values()
                  for p in m.parameters()),
            tuple(t.data_ptr() for t in state),
            tuple(b.data_ptr() for b in banks),
            tuple(sub.training for m in models.values()
                  for sub in m.modules()),
            tuple(getattr(m, "compute_dtype", None) for m in models.values()))


def _stream(device) -> "torch.cuda.Stream":
    """The device's capture stream, where warm-up steps run too."""
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    stream = _streams.get(index)
    if stream is None:
        stream = _streams[index] = torch.cuda.Stream(device=index)
    return stream


class MaskerGraph:
    """One captured masker step: its static frames and labels (the
    ingest's output), its static loss terms (4,) and gradients, and
    what the capture would have issued."""

    def __init__(self, cfg, models, optimizer, a: Sequence[Segment],
                 b: Segment, rng: StepRng, fuse: str, key: tuple):
        self.key, self.gen = key, rng.dropout
        dev = b.bank.device
        n_a = sum(seg.rows for seg in a)
        self.frames = torch.empty((n_a + b.rows, *b.bank.shape[1:]),
                                  dtype=torch.float32, device=dev)
        self.labels = torch.empty(
            sum(seg.rows for seg in (*a, b) if seg.labels is not None),
            dtype=torch.float32, device=dev)
        optimizer.zero_grad(set_to_none=True)
        self.graph = torch.cuda.CUDAGraph()
        self.graph.register_generator_state(rng.dropout)
        launches, issued = Counter(_build.launches), Counter(counts)
        with torch.cuda.graph(self.graph, stream=_stream(dev)):
            loss, aux = masker_loss(cfg, models,
                                    self.frames.permute(0, 3, 1, 2),
                                    self.labels, n_a, rng, fuse)
            with span("cgs.train.backward"):
                loss.backward()
            self.terms = torch.stack([aux[t] for t in TERMS]).detach()
        del loss, aux
        self.launches = Counter(_build.launches) - launches
        self.issued = Counter(counts) - issued
        _restore(_build.launches, launches)
        _restore(counts, issued)
        self.grads: List[Tuple[torch.nn.Parameter, torch.Tensor]] = [
            (p, p.grad) for m in models.values() for p in m.parameters()
            if p.grad is not None]
        counts["train.graph_captures"] += 1

    def attach(self) -> None:
        """Point each trained parameter's .grad at the graph's gradient
        (an eager step in between sets fresh ones)."""
        for p, g in self.grads:
            if p.grad is not g:
                p.grad = g

    def step(self, cfg, optimizer, a: Sequence[Segment], b: Segment,
             rng: StepRng, row: torch.Tensor) -> None:
        with span("cgs.train.masker_step"):
            with span("cgs.train.batch"):
                masker_batch(cfg, a, b, rng, out=(self.frames, self.labels))
            with span("cgs.train.replay"):
                self.graph.replay()
            _build.launches.update(self.launches)
            counts.update(self.issued)
            optimizer.step()
            row.copy_(self.terms)
        counts["train.graph_steps"] += 1


def _restore(counter: Counter, saved: Counter) -> None:
    counter.clear()
    counter.update(saved)


def _warm_up(cfg, models, optimizer, a, b, rng, fuse, row) -> None:
    """One eager step on the capture stream."""
    dev = b.bank.device
    stream, current = _stream(dev), torch.cuda.current_stream(dev)
    stream.wait_stream(current)
    with torch.cuda.stream(stream):
        row.copy_(torch.stack(masker_step(cfg, models, optimizer, a, b, rng,
                                          fuse=fuse)))
    current.wait_stream(stream)
    _warmed.add(optimizer)
    counts["train.eager_steps"] += 1


def masker_steps(cfg, models: Dict[str, torch.nn.Module], optimizer,
                 steps: Sequence[Tuple[Sequence[Segment], Segment]],
                 rng: StepRng, fuse: str, banks: Sequence[torch.Tensor]
                 ) -> torch.Tensor:
    """The (S, 4) loss terms of the masker steps `steps`, each (A's
    segments, B's segment) over `banks`, one graph replay a step."""
    dev = banks[0].device
    out = torch.empty((len(steps), len(TERMS)), device=dev)
    a0, b0 = steps[0]
    rows = (tuple(seg.rows for seg in a0), b0.rows)
    graph = _graphs.get(optimizer)
    if graph is not None and (
            graph.gen is not rng.dropout
            or graph.key != _key(cfg, models, optimizer, banks, rows, fuse)):
        torch.cuda.synchronize(dev)     # its replays end before it goes
        del _graphs[optimizer]
        graph = None
    if graph is not None:
        graph.attach()
    for s, (a, b) in enumerate(steps):
        if graph is None and optimizer not in _warmed:
            _warm_up(cfg, models, optimizer, a, b, rng, fuse, out[s])
            continue
        if graph is None:
            graph = _graphs[optimizer] = MaskerGraph(
                cfg, models, optimizer, a, b, rng, fuse,
                _key(cfg, models, optimizer, banks, rows, fuse))
        graph.step(cfg, optimizer, a, b, rng, out[s])
    return out
