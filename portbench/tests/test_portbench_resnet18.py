"""The `resnet18.process` cell on the CPU at a small size: its driver's
run against the plain reference, the faults and the bf16 control it
catches, and its two readers (`join_roofline.resnet18`,
`bn_ms_per_batch.process`) on hand-built trace summaries."""

from collections import Counter

import pytest
import torch
from _small import ROOT, SEED

from portbench.lib import flops
from portbench.lib import manifest as mf
from portbench.lib import shapes_resnet18
from portbench.lib.faults import Fault
from portbench.lib.harness import run_cell
from portbench.lib.trace import Summary

from cgs_tpu_torch.utils import profiling

CELL = "resnet18.process"
SMALL = {"pool_frames": 24, "batch": 8, "sample_per_call": 4}


def _run(trace=False, fault=None, dtype=None, seconds=0.3):
    torch.set_num_threads(2)
    man = mf.Manifest(ROOT)
    cell = man.cell(CELL)
    config = dict(cell.config, bn_stat_frames=32)
    if dtype:
        config["dtype"] = dtype
    cell = type(cell)(**{**cell.__dict__, "config": config})
    return run_cell(man, cell, SEED, seconds, trace, device="cpu",
                    faults=None if fault is None else Fault(fault,
                                                            "process"),
                    overrides=SMALL)


def test_result_line_correct():
    r = _run()
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"frames_per_s", "setup_s"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


def test_traced_run_reports_its_metrics():
    r = _run(trace=True)
    assert r["correct"] is True
    # no CUDA kernels on the CPU: the device-trace readers find nothing
    assert {"mfu.process", "idle.process"} <= set(r["metrics"])
    assert "join_roofline.resnet18" not in r["metrics"]


@pytest.mark.parametrize("fault", ["half_batch", "answer_altered", "bf16"])
def test_faults_come_out_not_correct(fault):
    if fault == "bf16":
        r = _run(dtype="bfloat16")
    else:
        r = _run(fault=fault)
    assert r["correct"] is False, r["checks"]


def _read(name, summary, layer, config):
    return mf.metric_reader(name).read(
        {"summary": summary, "layer": layer, "config": config,
         "traffic": {}, "flops": flops})


def _config():
    return mf.load_json(ROOT / "portbench/configs/resnet18.json")


def _summary(device):
    return Summary(window_s=1.0, busy_s=0.5, device=list(device), gaps=[])


def test_join_roofline_resnet18_on_a_summary():
    cfg = _config()
    batch = 8192
    bound_s = shapes_resnet18.joins_bytes(cfg, batch) \
        / flops.PEAK_HBM_BYTES_PER_S
    assert shapes_resnet18.joins_bytes(cfg, 1) == 2_777_088
    # 8 batches of 5 joins, each batch's joins at twice the bound
    per = 2 * bound_s * 1e6 / 5
    dev = [(i * per, (i + 1) * per, "upsample_cat_fwd<float>")
           for i in range(40)]
    layer = {"batch": batch, "frames_traced": 8 * batch}
    assert _read("join_roofline.resnet18", _summary(dev), layer,
                 cfg) == pytest.approx(50.0)
    assert _read("join_roofline.resnet18", _summary(dev[:-1]), layer,
                 cfg) is None


def test_bn_ms_per_batch_on_a_summary(monkeypatch):
    cfg = _config()
    layer = {"batch": 8, "frames_traced": 16}
    bn = [(i * 10.0, i * 10.0 + 5.0, "cudnn::bn_fw_inf_1C11_kernel_NCHW")
          for i in range(40)]
    other = [(500.0, 900.0, "implicit_convolve_sgemm")]
    state = Counter({"model.critic_frames": 48, "model.bn_running": 120})
    monkeypatch.setattr(profiling, "counts", state)
    # 2 batches of 20 launches, 5 us each: 0.1 ms a batch
    assert _read("bn_ms_per_batch.process", _summary(bn + other), layer,
                 cfg) == pytest.approx(0.1)
    assert _read("bn_ms_per_batch.process", _summary(bn[:-1] + other),
                 layer, cfg) is None
    monkeypatch.setattr(profiling, "counts", Counter())
    assert _read("bn_ms_per_batch.process", _summary(bn), layer,
                 cfg) is None
    monkeypatch.delattr(profiling, "counts")
    assert _read("bn_ms_per_batch.process", _summary(bn), layer,
                 cfg) is None
