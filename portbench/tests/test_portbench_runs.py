"""Whole runs of each cell on the CPU at small sizes: the result's keys,
the reference against the port's plain path, and every planted fault and
the bf16 control caught."""

import json
import subprocess
import sys

import numpy as np
import pytest
import torch
from _small import ROOT, run_small

from portbench.lib import faults

CELLS = ("chfak5.process", "chfak1.process", "chfak5.train_masker")
KIND = {"chfak5.process": "process", "chfak1.process": "process",
        "chfak5.train_masker": "train_masker"}


@pytest.mark.parametrize("cell", CELLS)
def test_result_line(cell):
    r = run_small(cell)
    assert list(r)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(r)
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    assert "setup_s" in r["metrics"]
    assert len(r["metrics"]) == 2
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(
        r["device"])
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r, allow_nan=False)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_result_line(cell):
    r = run_small(cell, trace=True)
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "setup_s" not in r["metrics"]
    for v in r["metrics"].values():
        if v["unit"] == "%":
            assert 0.0 <= v["value"] <= 100.0


@pytest.mark.parametrize("cell,fault", [
    (c, f) for c in CELLS for f in faults.applicable(KIND[c])
    if f != "tf32"])
def test_fault_comes_out_not_correct(cell, fault):
    r = run_small(cell, fault=fault)
    assert r["correct"] is False, r["checks"]


def test_reference_against_plain_path_chfak1():
    """The reference's eval forward against the port's plain path (its
    CPU version) on a few frames, same seeded weights."""
    from portbench.lib.weights import device_frames, seeded_params
    from portbench.reference import model as ref

    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.pipeline import MaskPipeline

    cfg = json.loads((ROOT / "portbench/configs/chfak1.json").read_text())
    p = seeded_params(cfg, 5, "cpu")
    pipe = MaskPipeline(Critic(chfak=1), UnetDecoder(chfak=1), p,
                        batch_size=8, device="cpu")
    frames = device_frames(8, 5, "cpu")
    out = pipe.run(frames.numpy())
    pred, mask = ref.forward_masks(p, frames)
    assert np.abs(out.preds - pred.numpy()).max() < 1e-6
    assert np.abs(out.masks[..., 0] - mask.numpy()).max() < 1e-6


def test_reference_masker_step_against_port():
    """One checked masker step (three by the traffic's setting) of the
    port against the reference's."""
    r = run_small("chfak5.train_masker")
    for c in r["checks"].values():
        assert c["value"] < 1e-4


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_window_fault_caught_by_the_window_chunks(fault, monkeypatch):
    """A fault only in the window's chunks, after the set-up's checked
    steps: the start's numbers stay inside their limits, the window
    chunks' do not."""
    from portbench.drivers.train_masker import TrainMasker

    window = TrainMasker.window

    def faulty_window(self, seconds, traced):
        with faults.Fault(fault, "train_masker"):
            return window(self, seconds, traced)

    monkeypatch.setattr(TrainMasker, "window", faulty_window)
    r = run_small("chfak5.train_masker")
    checks = r["checks"]
    assert r["correct"] is False, checks
    for k in ("loss_gap", "grad_gap", "change_gap"):
        assert checks[k]["value"] <= checks[k]["limit"], checks
    assert any(checks[k]["value"] > checks[k]["limit"]
               for k in ("chunk1_loss_gap", "chunk1_grad_gap",
                         "chunk1_change_gap", "last_loss_gap")), checks


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(ROOT / "portbench/run.py"),
                        "--workload", "chfak5.process", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""
