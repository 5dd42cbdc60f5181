"""PyTorch port: `--profile` (`utils/profiling.py:Profiler` on
`torch.profiler`, `cgs_tpu/utils/profiling.py:19-48`): one Chrome trace
JSON per trace, stopped however the traced body ends; the port's spans
(`utils/profiling.py:span`), recorded under any profiler and nothing
without one, nested as `pipeline.py` and `train/` open them, and their
in-memory totals (`span_ns`, `span_calls`) against the trace; the
pipeline's counters."""

import json
import os

import numpy as np
import pytest
import torch

from cgs_tpu_torch import cli
from cgs_tpu_torch.core.config import parse_args
from cgs_tpu_torch.data.synthetic import synthetic_eval_set
from cgs_tpu_torch.handler import Handler
from cgs_tpu_torch.utils import profiling
from cgs_tpu_torch.utils.profiling import Profiler, span
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)


def _names(path):
    with open(path) as fp:
        return {e.get("name") for e in json.load(fp)["traceEvents"]}


def test_profiler_writes_one_trace_with_annotations(tmp_path):
    prof = Profiler(str(tmp_path / "tr"), device="cpu")
    with span("before_any_trace"):             # a no-op
        torch.ones(3).sum()
    with prof.trace() as p:
        assert p is prof
        with span("cgs.train.critic_chunk"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert os.listdir(tmp_path / "tr") == [os.path.basename(prof.path)]
    names = _names(prof.path)
    assert "cgs.train.critic_chunk" in names and "aten::matmul" in names
    assert "before_any_trace" not in names
    prof.stop()                                # stopping twice is fine
    assert len(os.listdir(tmp_path / "tr")) == 1


def test_profiler_off_without_a_directory(tmp_path):
    prof = Profiler(None)
    with prof.trace():
        with span("x") as inner:
            assert span("y") is span("x")      # the shared no-op
        assert inner is None
    assert prof.path is None


def test_exception_inside_trace_still_stops_it(tmp_path):
    prof = Profiler(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="boom"):
        with prof.trace():
            with span("cgs.train.masker_chunk"):
                torch.ones(2).add(1)
                raise ValueError("boom")
    assert prof._prof is None
    assert "cgs.train.masker_chunk" in _names(prof.path)
    with prof.trace():       # a new trace can start after it
        pass
    assert len(os.listdir(tmp_path)) == 2


def test_span_is_the_shared_no_op_without_a_profiler(monkeypatch):
    """With no profiler recording, `span` touches no record_function:
    it returns the one no-op context made at import."""
    def boom(name):
        raise AssertionError(f"record_function({name!r}) called")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    assert span("cgs.pipeline.run") is profiling._NO_SPAN
    with span("cgs.pipeline.run"):
        torch.ones(2).add(1)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        with pytest.raises(AssertionError, match="cgs.pipeline.run"):
            span("cgs.pipeline.run")


def _tiny_pipeline(batch, **kw):
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.pipeline import MaskPipeline

    c, m = Critic(chfak=1, dropout=0.0), UnetDecoder(chfak=1)
    return MaskPipeline(c, m, {"critic": c.state_dict(),
                               "masker": m.state_dict()},
                        batch_size=batch, device="cpu", **kw)


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                dtype=np.uint8)


def _profiled(fn):
    """(fn's result, the events of a CPU profile around it)."""
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _children(events, parent):
    """{name: count} of the events whose cpu_parent is named `parent`."""
    out = {}
    for e in events:
        if e.cpu_parent is not None and e.cpu_parent.name == parent:
            out[e.name] = out.get(e.name, 0) + 1
    return out


def test_pipeline_run_spans_nest_under_run(one_torch_thread):
    """A ragged call (20 frames at batch 8: 3 batches, the last padded)
    names each piece of `run`'s host work under `cgs.pipeline.run`, once
    a first call has made the pipeline's staging ring: the first batch's
    upload inside `lead`, the last batch's writes as `tail` inside the
    last `read_back`."""
    pipe = _tiny_pipeline(8, wire="u8", hard_threshold=0.5)
    pipe.run(_frames(20, seed=1))
    out, events = _profiled(lambda: pipe.run(_frames(20)))
    assert out.masks_u8.shape == (20, 64, 64, 1)
    assert [e.name for e in events].count("cgs.pipeline.run") == 1
    kids = _children(events, "cgs.pipeline.run")
    assert kids == {"cgs.pipeline.lead": 1, "cgs.pipeline.pad": 1,
                    "cgs.pipeline.upload": 2, "cgs.pipeline.forward": 3,
                    "cgs.pipeline.read_back": 3}
    assert _children(events, "cgs.pipeline.lead") == {
        "cgs.pipeline.upload": 1}
    (tail,) = [e for e in events if e.name == "cgs.pipeline.tail"]
    last = max((e for e in events if e.name == "cgs.pipeline.read_back"),
               key=lambda e: e.time_range.start)
    assert tail.cpu_parent is not None and tail.cpu_parent.id == last.id
    # the forward's operations sit inside its span, the models' in
    # theirs (`models/build.py`)
    assert _children(events, "cgs.pipeline.forward").keys() >= {
        "cgs.model.critic", "cgs.model.masker"}
    assert any(n.startswith("aten::conv")
               for n in _children(events, "cgs.model.critic"))


def test_span_totals_still_without_a_profiler(one_torch_thread):
    """With no profiler recording, a whole ragged call moves no span
    total."""
    pipe = _tiny_pipeline(8, wire="u8", hard_threshold=0.5)
    before = (dict(profiling.span_ns), dict(profiling.span_calls))
    pipe.run(_frames(20))
    assert (dict(profiling.span_ns), dict(profiling.span_calls)) == before


@pytest.mark.parametrize("name,calls", [
    ("run", 1), ("lead", 1), ("pad", 1), ("upload", 3), ("forward", 3),
    ("read_back", 3), ("tail", 1), ("wait", 0)])
def test_span_totals_match_the_trace(name, calls, one_torch_thread):
    """Under a CPU profile of a ragged call (20 frames at batch 8), the
    call's increase in `span_calls` of each `cgs.pipeline.*` span is its
    count of events in the trace, and its increase in `span_ns` the sum
    of their durations within 10% or 50 us. Off the card no span
    waits: there is no event to wait on. The host clock around a span
    also holds the profiler's own work at the span's entry and exit
    (~10-15 us a span on a CPU), and whatever preempts the process there
    when the cores are oversubscribed: the counts must agree on every
    call, the durations on one of three."""
    pipe = _tiny_pipeline(8, wire="u8", hard_threshold=0.5)
    pipe.run(_frames(20, seed=1))
    name = "cgs.pipeline." + name
    gaps = []
    for _ in range(3):
        ns0 = profiling.span_ns[name]
        calls0 = profiling.span_calls[name]
        _, events = _profiled(lambda: pipe.run(_frames(20)))
        mine = [e for e in events if e.name == name]
        assert profiling.span_calls[name] - calls0 == len(mine) == calls
        traced_us = sum(e.time_range.elapsed_us() for e in mine)
        kept_us = (profiling.span_ns[name] - ns0) / 1e3
        gaps.append((kept_us, traced_us))
        if abs(kept_us - traced_us) <= max(0.1 * traced_us, 50.0):
            return
    pytest.fail(f"{name}: kept and traced us {gaps}")


@pytest.mark.parametrize("n,batch,kw", [
    (20, 8, {"wire": "u8", "hard_threshold": 0.5}),
    (16, 8, {}),
    (5, 16, {"salience": True}),
])
def test_pipeline_counters_are_exact(n, batch, kw, one_torch_thread):
    """rows = ceil(N / b) * b (the padding included), h2d = rows * 12288
    bytes, d2h = every row read back of every output."""
    pipe = _tiny_pipeline(batch, **kw)
    before = dict(profiling.counts)
    out = pipe.run(_frames(n))
    got = {k: profiling.counts[k] - before.get(k, 0)
           for k in ("pipeline.rows", "pipeline.h2d_bytes",
                     "pipeline.d2h_bytes")}
    b = min(batch, n)
    rows = -(-n // b) * b
    outs = [a for a in (out.preds, out.masks, out.saliency, out.masks_u8,
                        out.hard) if a is not None]
    assert got == {"pipeline.rows": rows,
                   "pipeline.h2d_bytes": rows * 64 * 64 * 3,
                   "pipeline.d2h_bytes": sum(a.nbytes for a in outs)
                   // n * rows}


def test_pipeline_counters_count_run_alone(one_torch_thread):
    """The server's path (`place_input` then `run_device`, its own
    read-back) moves no `pipeline.*` counter: they count the same calls
    of `run`, so their ratios hold whatever else drives the pipeline.
    The `model.*` counters count every forward, the server's too."""
    pipe = _tiny_pipeline(8, wire="u8", hard_threshold=0.5)
    before = dict(profiling.counts)
    out = pipe.run_device(pipe.place_input(_frames(8)))
    assert out[1].cpu().numpy().shape == (8, 64, 64, 1)
    after = dict(profiling.counts)
    assert {k: v for k, v in after.items() if k.startswith("pipeline.")} \
        == {k: v for k, v in before.items() if k.startswith("pipeline.")}
    for k in ("model.critic_frames", "model.masker_frames"):
        assert after[k] - before.get(k, 0) == 8


def test_masker_chunk_spans(one_torch_thread):
    """A 3-step masker chunk: the chunk's span holds the upload, three
    steps each with batch, loss and backward, and the losses' stack."""
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.train.loops import masker_chunk
    from cgs_tpu_torch.train.steps import StepRng, make_optimizer

    cfg = Config(dropout=0.0, shift=12).derive()
    models = {"critic": Critic(chfak=1, dropout=0.0).to(
                  memory_format=torch.channels_last),
              "masker": UnetDecoder(chfak=1).to(
                  memory_format=torch.channels_last)}
    opt = make_optimizer(models)
    bank = torch.from_numpy(_frames(12))
    y = torch.linspace(0, 1, 12)
    rng = np.random.default_rng(3)
    h, l = (rng.integers(0, 12, (3, 2)) for _ in range(2))
    c = rng.integers(0, 12, (3, 4))
    terms, events = _profiled(lambda: masker_chunk(
        cfg, models, opt, bank, y, bank, y, h, l, c,
        StepRng.seeded(0, "cpu")))
    assert terms.shape == (3, 4)
    assert [e.name for e in events].count("cgs.train.masker_chunk") == 1
    kids = _children(events, "cgs.train.masker_chunk")
    assert {k: v for k, v in kids.items() if k.startswith("cgs.")} == {
        "cgs.train.upload_indices": 1, "cgs.train.masker_step": 3,
        "cgs.train.stack_losses": 1}
    steps = [e for e in events if e.name == "cgs.train.masker_step"]
    for step in steps:
        kids = [k.name for k in step.cpu_children]
        assert [k for k in kids if k.startswith("cgs.")] == [
            "cgs.train.batch", "cgs.train.loss", "cgs.train.backward"]
        assert any(k.startswith("Optimizer.step") for k in kids)


def test_eval_profile_writes_a_trace(tmp_path, monkeypatch,
                                    one_torch_thread):
    """A tiny -eval (the 5 frames of a small ./resimgs.npy) traced."""
    monkeypatch.chdir(tmp_path)
    frames, _ = synthetic_eval_set(n_frames=110, seed=2)
    np.save("resimgs.npy", frames / 255.0)
    handler = cli.main(["-eval", "-resimages", "--profile", "trace",
                        "--device", "cpu"], primary=False)
    (name,) = os.listdir(tmp_path / "trace")
    assert handler.profiler.path == os.path.join("trace", name)
    names = _names(tmp_path / "trace" / name)
    # the eval's forward ran inside the trace
    assert any(n and n.startswith("aten::conv") for n in names)
    # the Handler's profiler records CPU activity alone on the CPU
    assert Handler(parse_args(["--device", "cpu"])).profiler.device.type \
        == "cpu"


def test_train_profile_names_the_chunks(tmp_path, monkeypatch,
                                        one_torch_thread):
    """A tiny `-train --profile`: the trace names each chunk
    `cgs.train.*`, where it said `critic_chunk` / `masker_chunk`."""
    monkeypatch.chdir(tmp_path)
    cli.main(["--device", "cpu", "-train", "--model", "tiny", "--profile",
              "trace", "-synthetic_data", "--datasize", "1100",
              "--testsize", "100", "--cepochs", "6", "--batch-size", "32",
              "--dropout", "0", "--high-rew-thresh", "0.55",
              "--low-rew-thresh", "0.45", "--contrastive-min", "5",
              "--mepochs", "1"], primary=False)
    (name,) = os.listdir(tmp_path / "trace")
    names = _names(tmp_path / "trace" / name)
    assert {"cgs.train.critic_chunk", "cgs.train.critic_step",
            "cgs.train.masker_chunk", "cgs.train.masker_step"} <= names
    assert not {"critic_chunk", "masker_chunk"} & names
