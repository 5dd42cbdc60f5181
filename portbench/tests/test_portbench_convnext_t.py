"""The `convnext_t.process` cell on the CPU at a small size: its driver's
run against the plain reference, the faults and the bf16 control it
catches, its four readers (`layernorm_roofline.convnext_t`,
`join_roofline.convnext_t`, `dwconv_ms_per_batch.process`,
`dwconv_roofline.convnext_t`) on hand-built trace summaries, and the
manifest's entries for it."""

import json
from collections import Counter

import pytest
import torch
from _small import ROOT, SEED

from portbench.lib import flops
from portbench.lib import manifest as mf
from portbench.lib import shapes_convnext_t
from portbench.lib.faults import Fault
from portbench.lib.harness import run_cell
from portbench.lib.trace import Summary

from cgs_tpu_torch.utils import profiling

CELL = "convnext_t.process"
SMALL = {"pool_frames": 12, "batch": 4, "sample_per_call": 3}
NEW = ("layernorm_roofline.convnext_t", "join_roofline.convnext_t",
       "dwconv_ms_per_batch.process", "dwconv_roofline.convnext_t")


def _run(trace=False, fault=None, dtype=None, seconds=0.3):
    torch.set_num_threads(2)
    man = mf.Manifest(ROOT)
    cell = man.cell(CELL)
    if dtype:
        cell = type(cell)(**{**cell.__dict__,
                             "config": dict(cell.config, dtype=dtype)})
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
    assert not set(NEW) & set(r["metrics"])


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
    return mf.load_json(ROOT / "portbench/configs/convnext_t.json")


def _summary(device):
    return Summary(window_s=1.0, busy_s=0.5, device=list(device), gaps=[])


def test_shapes_count_the_published_model():
    cfg = _config()
    assert shapes_convnext_t.process_flops_per_frame(cfg) == 1_402_068_480
    assert shapes_convnext_t.joins_bytes(cfg, 1) == 3_330_048
    assert shapes_convnext_t.layer_norms_bytes(cfg, 1) == 1_947_648
    assert shapes_convnext_t.dw_convs_bytes(cfg, 1) == 1_400_832
    assert len(shapes_convnext_t.layer_norms(cfg)) == 23
    assert len(shapes_convnext_t.dw_convs(cfg)) == 18
    assert sum(L.macs_per_frame
               for L in shapes_convnext_t.dw_convs(cfg)) == 8_580_096


def test_join_roofline_convnext_t_on_a_summary():
    cfg = _config()
    batch = 8192
    bound_s = shapes_convnext_t.joins_bytes(cfg, batch) \
        / flops.PEAK_HBM_BYTES_PER_S
    # 8 batches of 5 joins, each batch's joins at twice the bound
    per = 2 * bound_s * 1e6 / 5
    dev = [(i * per, (i + 1) * per, "upsample_cat_fwd<unsigned int>")
           for i in range(40)]
    layer = {"batch": batch, "frames_traced": 8 * batch}
    assert _read("join_roofline.convnext_t", _summary(dev), layer,
                 cfg) == pytest.approx(50.0)
    assert _read("join_roofline.convnext_t", _summary(dev[:-1]), layer,
                 cfg) is None


def _counted(monkeypatch, **kw):
    monkeypatch.setattr(profiling, "counts", Counter(kw))


def test_layernorm_roofline_on_a_summary(monkeypatch):
    cfg = _config()
    batch = 8192
    layer = {"batch": batch, "frames_traced": 2 * batch}
    bound_s = shapes_convnext_t.layer_norms_bytes(cfg, batch) \
        / flops.PEAK_HBM_BYTES_PER_S
    per = 4 * bound_s * 1e6 / 23      # each batch's 23 at 4x the bound
    ln = [(i * per, (i + 1) * per,
           "vectorized_layer_norm_kernel<float, float, false>")
          for i in range(46)]
    other = [(1e7, 2e7, "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n")]
    _counted(monkeypatch, **{"model.critic_frames": 3 * batch,
                             "model.layer_norms": 69})
    assert _read("layernorm_roofline.convnext_t", _summary(ln + other),
                 layer, cfg) == pytest.approx(25.0)
    assert _read("layernorm_roofline.convnext_t", _summary(ln[:-1]),
                 layer, cfg) is None
    _counted(monkeypatch)
    assert _read("layernorm_roofline.convnext_t", _summary(ln), layer,
                 cfg) is None
    monkeypatch.delattr(profiling, "counts")
    assert _read("layernorm_roofline.convnext_t", _summary(ln), layer,
                 cfg) is None


def test_dwconv_ms_per_batch_on_a_summary(monkeypatch):
    cfg = _config()
    layer = {"batch": 8, "frames_traced": 16}
    dw = [(i * 10.0, i * 10.0 + 5.0, "conv2d_c1_k1_nhwc") for i in range(36)]
    other = [(500.0, 900.0, "implicit_convolve_sgemm")]
    _counted(monkeypatch, **{"model.critic_frames": 24,
                             "model.dw_convs": 54})
    # 2 batches of 18 launches, 5 us each: 0.09 ms a batch
    assert _read("dwconv_ms_per_batch.process", _summary(dw + other), layer,
                 cfg) == pytest.approx(0.09)
    assert _read("dwconv_ms_per_batch.process", _summary(dw[:-1] + other),
                 layer, cfg) is None
    _counted(monkeypatch)
    assert _read("dwconv_ms_per_batch.process", _summary(dw), layer,
                 cfg) is None
    monkeypatch.delattr(profiling, "counts")
    assert _read("dwconv_ms_per_batch.process", _summary(dw), layer,
                 cfg) is None


def test_dwconv_roofline_on_a_summary(monkeypatch):
    cfg = _config()
    batch = 8192
    layer = {"batch": batch, "frames_traced": 2 * batch}
    # at f32 the depthwise layers are bound by their bytes, not FLOPs
    bound_s = shapes_convnext_t.dw_convs_bytes(cfg, batch) \
        / flops.PEAK_HBM_BYTES_PER_S
    assert bound_s > 2 * batch * 8_580_096 / flops.PEAK_F32_FLOPS
    per = 8 * bound_s * 1e6 / 18      # each batch's 18 at 8x the bound
    dw = [(i * per, (i + 1) * per, "conv2d_c1_k1_nhwc") for i in range(36)]
    other = [(1e7, 2e7, "implicit_convolve_sgemm")]
    _counted(monkeypatch, **{"model.critic_frames": 3 * batch,
                             "model.dw_convs": 54})
    assert _read("dwconv_roofline.convnext_t", _summary(dw + other),
                 layer, cfg) == pytest.approx(12.5)
    assert _read("dwconv_roofline.convnext_t", _summary(dw[:-1]),
                 layer, cfg) is None
    monkeypatch.delattr(profiling, "counts")
    assert _read("dwconv_roofline.convnext_t", _summary(dw), layer,
                 cfg) is None


def test_manifest_names_the_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    man = mf.Manifest(ROOT)
    cell = man.cell(CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "process_convnext_t"
    assert cell.config["reduced"] == [] and cell.config["tf32"] is False
    assert set(cell.limits) >= {"pred_gap", "level_gap", "hard_gap"}
    traced = {m.name for m in man.metrics_for(CELL, True)}
    assert set(NEW) <= traced
    assert {m.name for m in man.metrics_for(CELL, False)} == {
        "frames_per_s", "setup_s"}
    conf = {c["name"]: c for c in bench["configs"]}["convnext_t"]
    assert conf["reduced"] == [] and conf["file"].endswith("convnext_t.json")
    for name in NEW:
        assert mf.metric_reader(name).MOVES == "frames_per_s"
