"""The readers of the program's span totals (`run_lead_ms_per_call.process`,
`run_tail_ms_per_call.process`, `host_work_ms_per_batch.process`) on
planted totals and on a program without them; then traced CPU runs of
two cells."""

from collections import Counter

import pytest
from _small import run_small

from portbench.lib import manifest as mf

from cgs_tpu_torch.utils import profiling

READERS = ("run_lead_ms_per_call.process", "run_tail_ms_per_call.process",
           "host_work_ms_per_batch.process")
# two traced calls of 4 batches each, one wait a batch
NS = Counter({"cgs.pipeline.run": 400_000_000, "cgs.pipeline.lead": 30_000_000,
              "cgs.pipeline.tail": 22_000_000,
              "cgs.pipeline.wait": 80_000_000,
              "cgs.pipeline.forward": 9_000_000})
CALLS = Counter({"cgs.pipeline.run": 2, "cgs.pipeline.lead": 2,
                 "cgs.pipeline.tail": 2, "cgs.pipeline.wait": 8,
                 "cgs.pipeline.forward": 8})


def _read(name):
    return mf.metric_reader(name).read(
        {"summary": None, "layer": {}, "config": {}, "traffic": {},
         "flops": None})


@pytest.mark.parametrize("name,want", [
    ("run_lead_ms_per_call.process", 15.0),
    ("run_tail_ms_per_call.process", 11.0),
    ("host_work_ms_per_batch.process", (400 - 80) / 8)])
def test_exact_ratio_on_planted_totals(name, want, monkeypatch):
    monkeypatch.setattr(profiling, "span_ns", NS)
    monkeypatch.setattr(profiling, "span_calls", CALLS)
    assert _read(name) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_none_without_span_totals(name, monkeypatch):
    """The tree before the totals: `span` but no `span_ns` to read."""
    monkeypatch.delattr(profiling, "span_ns")
    assert _read(name) is None


@pytest.mark.parametrize("name", READERS)
def test_none_when_no_run_was_recorded(name, monkeypatch):
    monkeypatch.setattr(profiling, "span_ns", Counter(
        {k: v for k, v in NS.items() if k != "cgs.pipeline.run"}))
    monkeypatch.setattr(profiling, "span_calls", Counter(
        {k: v for k, v in CALLS.items() if k != "cgs.pipeline.run"}))
    assert _read(name) is None


@pytest.mark.parametrize("cell", ["chfak1.process", "chfak5.process"])
def test_traced_cpu_run_reads_the_run_ends(cell):
    """A traced CPU run at small sizes records the traced call's spans:
    each reader reads a number (no wait off the card)."""
    r = run_small(cell, trace=True)
    assert r["correct"] is True
    for name in READERS:
        assert r["metrics"][name]["value"] >= 0.0
