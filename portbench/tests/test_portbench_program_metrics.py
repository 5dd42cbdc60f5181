"""The readers of the program's own spans and counters
(`host_idle_ms_per_batch.process`, `host_idle_ms_per_step.train`,
`copy_gb_per_s.process`) on hand-built trace summaries and counter
states, and on a program without them; then traced CPU runs of each
cell."""

from collections import Counter

import pytest
from _small import run_small

from portbench.lib import manifest as mf
from portbench.lib.trace import Summary

from cgs_tpu_torch.utils import profiling

COPY_UP = "Memcpy HtoD (Pageable -> Device)"
COPY_DOWN = "Memcpy DtoH (Device -> Pageable)"


def _summary(gaps, device=()):
    return Summary(window_s=1.0, busy_s=0.5, device=list(device),
                   gaps=list(gaps))


def _read(name, summary, layer):
    return mf.metric_reader(name).read(
        {"summary": summary, "layer": layer, "config": {}, "traffic": {},
         "flops": None})


GAPS = [(0.020, "cgs.pipeline.assemble"), (0.004, "cgs.pipeline.read_back"),
        (0.100, "portbench.run"), (0.003, "aten::empty_strided"),
        (0.006, "cgs.train.masker_step"), (0.002, "cgs.train.backward"),
        (0.050, "portbench.masker_chunk"), (0.001, "cgs.serve.dispatch")]


def test_host_idle_per_batch_reads_the_pipeline_spans():
    # 64 frames at batch 8: 8 batches; 24 ms under cgs.pipeline.*
    got = _read("host_idle_ms_per_batch.process", _summary(GAPS),
                {"frames_traced": 64, "batch": 8})
    assert got == pytest.approx(3.0)


def test_host_idle_per_step_reads_the_train_spans():
    got = _read("host_idle_ms_per_step.train", _summary(GAPS),
                {"steps_traced": 4})
    assert got == pytest.approx(2.0)


@pytest.mark.parametrize("name,layer", [
    ("host_idle_ms_per_batch.process", {"frames_traced": 64, "batch": 8}),
    ("host_idle_ms_per_step.train", {"steps_traced": 4})])
def test_host_idle_zero_when_no_gap_is_the_programs(name, layer):
    other = [g for g in GAPS if not g[1].startswith("cgs.")]
    assert _read(name, _summary(other), layer) == 0.0


@pytest.mark.parametrize("name,layer", [
    ("host_idle_ms_per_batch.process", {"frames_traced": 64, "batch": 8}),
    ("host_idle_ms_per_step.train", {"steps_traced": 4})])
def test_host_idle_none_without_the_programs_spans(name, layer,
                                                   monkeypatch):
    """A program with no `span` (the tree before the spans) names no
    gap after itself: nothing to read, and no error."""
    monkeypatch.delattr(profiling, "span")
    assert _read(name, _summary(GAPS), layer) is None
    assert _read(name, None, layer) is None


def test_copy_rate_from_counters_and_copy_time(monkeypatch):
    # 16 rows, 12288 B up and 8196 B down a row; batch 8; the traced
    # call's 2 batches copied for 2 x (600 + 400) us
    monkeypatch.setattr(profiling, "counts", Counter({
        "pipeline.rows": 16, "pipeline.h2d_bytes": 16 * 12288,
        "pipeline.d2h_bytes": 16 * 8196}))
    dev = [(0.0, 600.0, COPY_UP), (600.0, 1000.0, COPY_DOWN),
           (1000.0, 1600.0, COPY_UP), (1600.0, 2000.0, COPY_DOWN),
           (2000.0, 9000.0, "void cudnn::conv")]
    got = _read("copy_gb_per_s.process", _summary(GAPS, dev),
                {"frames_traced": 16, "batch": 8})
    assert got == pytest.approx(8 * (12288 + 8196) / 1e-3 / 1e9)


@pytest.mark.parametrize("case", ["no_copies", "no_rows", "no_counts",
                                  "no_summary"])
def test_copy_rate_none_when_nothing_to_read(case, monkeypatch):
    counts = Counter({"pipeline.rows": 16, "pipeline.h2d_bytes": 1,
                      "pipeline.d2h_bytes": 1})
    dev = [(0.0, 600.0, COPY_UP)]
    if case == "no_copies":
        dev = [(0.0, 600.0, "void cudnn::conv")]
    elif case == "no_rows":
        counts = Counter()
    if case == "no_counts":
        monkeypatch.delattr(profiling, "counts")
    else:
        monkeypatch.setattr(profiling, "counts", counts)
    summary = None if case == "no_summary" else _summary(GAPS, dev)
    assert _read("copy_gb_per_s.process", summary,
                 {"frames_traced": 16, "batch": 8}) is None


@pytest.mark.parametrize("cell,present,absent", [
    ("chfak5.process", {"host_idle_ms_per_batch.process"},
     {"copy_gb_per_s.process"}),
    ("chfak1.process", {"host_idle_ms_per_batch.process"},
     {"copy_gb_per_s.process"}),
    ("chfak5.train_masker", {"host_idle_ms_per_step.train"}, set())])
def test_traced_cpu_run_reads_the_programs_metrics(cell, present, absent):
    """A traced CPU run at small sizes: the span readers read a number
    (the CPU trace holds no device event, so the whole window is one
    gap); the copy rate has no device copy to read on the CPU and is
    left out."""
    r = run_small(cell, trace=True)
    assert r["correct"] is True
    for name in present:
        assert r["metrics"][name]["value"] >= 0.0
    assert not absent & set(r["metrics"])
