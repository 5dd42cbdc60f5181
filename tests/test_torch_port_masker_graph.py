"""PyTorch port: the masker step as one captured CUDA graph
(`train/graph.py`) and the ingest into its static buffers
(`ops/kernels.py:gather_normalize_u8(..., out=)`).

On the CPU: the `out=` ingest writes what a fresh call returns and
refuses buffers it cannot write; `masker_chunk` on the CPU and over a
mesh runs its eager loop, counted in `train.eager_steps`; the rule of
`graph.engages`. Marked `cuda` (skipped without a card): the graphed
`masker_chunk` against the eager loop from the same seeds, shift 12 and
dropout 0.5, over chunks of 1, 5 and 3 steps with a `masker_viz` on the
training generators between chunks, bit-equal in the loss terms, every
trained leaf, Adam's moments and step and both generators' states, in
every `fuse` mode, frozen and live, float32 and bfloat16, for the
paper, ResNet-18 and ConvNeXt-T critics, and across a
recapture forced by `optimizer.load_state_dict`. This file imports neither JAX nor the JAX
package.
"""

import copy
from unittest import mock

import numpy as np
import pytest
import torch

from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.models.build import build_pair
from cgs_tpu_torch.ops import _build
from cgs_tpu_torch.ops.kernels import Segment, gather_normalize_u8
from cgs_tpu_torch.parallel import mesh as mesh_mod
from cgs_tpu_torch.parallel.mesh import Mesh
from cgs_tpu_torch.train import graph as graph_mod
from cgs_tpu_torch.train.loops import masker_chunk, masker_viz
from cgs_tpu_torch.train.steps import (
    StepRng, make_optimizer, set_masker_modes, trained_param_keys,
)
from cgs_tpu_torch.utils.profiling import counts

CPU = torch.device("cpu")
COUNTERS = ("train.graph_captures", "train.graph_steps",
            "train.eager_steps")


def _ingest_segments(dev=CPU, seed=0):
    g = torch.Generator().manual_seed(seed)
    banks = [torch.randint(0, 256, (9, 5, 64, 3), dtype=torch.uint8,
                           generator=g).to(dev) for _ in range(3)]
    labels = [torch.rand(9, generator=g).to(dev) for _ in range(2)]
    idx = [torch.tensor(i, device=dev) for i in ([3, 0, 8, 3], [1, 7],
                                                 [2, 2, 5])]
    return [Segment(banks[0], idx[0], 11, labels[0]),
            Segment(banks[1], idx[1], -5, labels[1]),
            Segment(banks[2], idx[2], 0)]


def _counted():
    return {k: counts[k] for k in COUNTERS}


def _delta(before):
    return {k: counts[k] - before[k] for k in COUNTERS}


@pytest.mark.parametrize("labelled", [True, False])
def test_out_ingest_writes_what_a_fresh_call_returns(labelled):
    segs = _ingest_segments()
    if not labelled:
        segs = [s._replace(labels=None) for s in segs]
    x, y = gather_normalize_u8(segs)
    frames = torch.full((9, 5, 64, 3), float("nan"))
    lab = torch.full((6,), float("nan")) if labelled else None
    got = gather_normalize_u8(segs, out=(frames, lab))
    assert got[0] is frames and got[1] is lab
    assert torch.equal(frames, x)
    if labelled:
        assert torch.equal(lab, y)
    else:
        assert y is None


@pytest.mark.parametrize("bad", ["shape", "dtype", "strides", "labels_size",
                                 "labels_dtype", "labels_missing",
                                 "labels_extra"])
def test_out_ingest_refuses_buffers_it_cannot_write(bad):
    segs = _ingest_segments()
    frames, lab = torch.empty(9, 5, 64, 3), torch.empty(6)
    if bad == "shape":
        frames = torch.empty(8, 5, 64, 3)
    elif bad == "dtype":
        frames = torch.empty(9, 5, 64, 3, dtype=torch.bfloat16)
    elif bad == "strides":
        frames = torch.empty(9, 3, 5, 64).permute(0, 2, 3, 1)
    elif bad == "labels_size":
        lab = torch.empty(9)
    elif bad == "labels_dtype":
        lab = torch.empty(6, dtype=torch.float64)
    elif bad == "labels_missing":
        lab = None
    else:
        segs = [s._replace(labels=None) for s in segs]
    with pytest.raises(ValueError, match="gather_normalize_u8: out"):
        gather_normalize_u8(segs, out=(frames, lab))


def _models(dev, cfg, compute_dtype=torch.float32, seed=0):
    torch.manual_seed(seed)
    models = dict(zip(("critic", "masker"), build_pair(cfg, compute_dtype)))
    for m in models.values():
        m.to(dev, memory_format=torch.channels_last)
    set_masker_modes(cfg, models)
    return models


def _banks(dev, n=24, seed=1):
    g = torch.Generator().manual_seed(seed)
    xpos, xneg = (torch.randint(0, 256, (n, 64, 64, 3), dtype=torch.uint8,
                                generator=g).to(dev) for _ in range(2))
    ypos = (0.7 + 0.3 * torch.rand(n, generator=g)).to(dev)
    yneg = (0.3 * torch.rand(n, generator=g)).to(dev)
    return xpos, ypos, xneg, yneg


def _stacks(steps, k, n=24, seed=2):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, (steps, k)), rng.integers(0, n, (steps, k)),
            rng.integers(0, n, (steps, 2 * k)))


def test_engages_on_one_card_without_a_mesh():
    cuda = torch.device("cuda")
    assert graph_mod.engages(None, cuda)
    assert not graph_mod.engages(None, CPU)
    assert not graph_mod.engages(Mesh(rank=0, world=1, device=cuda), cuda)


@pytest.mark.parametrize("meshed", [False, True])
def test_masker_chunk_on_the_cpu_runs_eagerly(meshed, monkeypatch):
    """On the CPU, with or without a mesh (world 1: its collectives are
    the identity), every step is eager and none replays a graph; the
    meshed chunk's terms equal the unmeshed ones."""
    monkeypatch.setattr(mesh_mod.dist, "all_reduce", lambda t, op=None: t)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg = Config(dropout=0.5, shift=12, frozen=True).derive()
        banks = _banks(CPU)
        h, l, c = _stacks(2, 4)
        out = []
        for mesh in (None, Mesh(rank=0, world=1, device=CPU)
                     if meshed else None):
            models = _models(CPU, cfg)
            opt = make_optimizer({k: models[k]
                                  for k in trained_param_keys(cfg)})
            before = _counted()
            out.append(masker_chunk(cfg, models, opt, *banks, h, l, c,
                                    StepRng.seeded(3, CPU), mesh))
            assert _delta(before) == {"train.graph_captures": 0,
                                      "train.graph_steps": 0,
                                      "train.eager_steps": 2}
        assert out[0].shape == (2, 4)
        assert torch.equal(out[0], out[1])
    finally:
        torch.set_num_threads(n)


# ---------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------

@pytest.fixture
def dev(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _train(dev, cfg, fuse, graphed, reload_before=None,
           dtype=torch.float32):
    """Chunks of 1, 5 and 3 masker steps from one seed, a `masker_viz`
    on the training generators after each; with `reload_before` = i the
    optimizer reloads a copy of its state before chunk i. Returns the
    terms, the trained leaves, Adam's state, both generators' states,
    the counters' and the kernels' launches' changes."""
    k = 8
    models = _models(dev, cfg, dtype)
    opt = make_optimizer({n: models[n] for n in trained_param_keys(cfg)})
    rng = StepRng.seeded(5, dev)
    banks = _banks(dev)
    before, launches = _counted(), dict(_build.launches)
    terms, masks = [], []
    with mock.patch.object(graph_mod, "engages",
                           graph_mod.engages if graphed
                           else (lambda *a: False)):
        for i, steps in enumerate((1, 5, 3)):
            if i == reload_before:
                opt.load_state_dict(copy.deepcopy(opt.state_dict()))
            h, l, c = _stacks(steps, k, seed=10 + i)
            terms.append(masker_chunk(cfg, models, opt, *banks, h, l, c,
                                      rng, fuse=fuse))
            masks.append(masker_viz(cfg, models, *banks, h[0], l[0], c[0],
                                    rng)["z"])
    torch.cuda.synchronize(dev)
    trained = [p for n in trained_param_keys(cfg)
               for p in models[n].parameters()]
    state = [opt.state[p][key] for p in trained
             for key in ("exp_avg", "exp_avg_sq", "step")]
    gens = [rng.shift.get_state(), rng.dropout.get_state()]
    return {"terms": [t.cpu() for t in terms],
            "masks": [z.cpu() for z in masks],
            "leaves": [p.detach().cpu() for p in trained],
            "buffers": [t.cpu() for m in models.values()
                        for t in m.buffers()],
            "adam": [t.cpu() for t in state], "rng": gens,
            "counters": _delta(before),
            "launches": {n: v - launches.get(n, 0)
                         for n, v in _build.launches.items()
                         if v != launches.get(n, 0)}}


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 and t.dim() \
        else t


def _assert_bit_equal(got, want):
    for key in ("terms", "masks", "leaves", "buffers", "adam", "rng"):
        assert len(got[key]) == len(want[key]), key
        for i, (g, w) in enumerate(zip(got[key], want[key])):
            assert g.dtype == w.dtype and g.shape == w.shape, (key, i)
            assert torch.equal(_bits(g), _bits(w)), (key, i)
    assert got["launches"] == want["launches"]


@pytest.mark.cuda
def test_out_ingest_on_the_card(dev):
    segs = _ingest_segments(dev)
    x, y = gather_normalize_u8(segs)
    frames = torch.full((9, 5, 64, 3), float("nan"), device=dev)
    lab = torch.full((6,), float("nan"), device=dev)
    _build.launches.clear()
    assert gather_normalize_u8(segs, out=(frames, lab)) == (frames, lab)
    assert dict(_build.launches) == {"normalize_u8": 1}
    assert torch.equal(frames, x) and torch.equal(lab, y)


ARCHS = [("paper", 5, frozen, dtype) for frozen in (True, False)
         for dtype in (torch.float32, torch.bfloat16)] + [
    (arch, 1, frozen, torch.float32) for arch in ("resnet18", "convnext_t")
    for frozen in (True, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch,chfak,frozen,dtype", ARCHS)
@pytest.mark.parametrize("fuse", ["none", "merges", "both"])
def test_graphed_chunks_equal_the_eager_loop(dev, fuse, arch, chfak,
                                             frozen, dtype):
    """The paper critic at chfak 5 in float32 and under bfloat16
    autocast, ResNet-18 (a live one moves its BatchNorm statistics
    inside the graph) and ConvNeXt-T (a live one draws its drop-path
    inside the graph; a frozen one runs it in eval mode), each frozen and
    live."""
    cfg = Config(chfak=chfak, dropout=0.5, shift=12, frozen=frozen,
                 critic_arch=arch, device="cuda").derive()
    eager = _train(dev, cfg, fuse, graphed=False, dtype=dtype)
    graphed = _train(dev, cfg, fuse, graphed=True, dtype=dtype)
    assert eager["counters"] == {"train.graph_captures": 0,
                                 "train.graph_steps": 0,
                                 "train.eager_steps": 9}
    assert graphed["counters"] == {"train.graph_captures": 1,
                                   "train.graph_steps": 8,
                                   "train.eager_steps": 1}
    _assert_bit_equal(graphed, eager)
    assert float(graphed["terms"][0].abs().sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", ["none", "both"])
def test_reloading_the_optimizer_recaptures(dev, fuse):
    cfg = Config(chfak=5, dropout=0.5, shift=12, frozen=True,
                 device="cuda").derive()
    eager = _train(dev, cfg, fuse, graphed=False, reload_before=2)
    graphed = _train(dev, cfg, fuse, graphed=True, reload_before=2)
    assert graphed["counters"] == {"train.graph_captures": 2,
                                   "train.graph_steps": 8,
                                   "train.eager_steps": 1}
    _assert_bit_equal(graphed, eager)
