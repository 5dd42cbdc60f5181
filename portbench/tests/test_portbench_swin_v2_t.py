"""The `swin_v2_t.process` cell on the CPU at a small size: its driver's
run against the plain reference, the faults and the bf16 control it
catches, its shapes module, its two readers
(`window_attn_ms_per_batch.process`, `window_attn_roofline.swin_v2_t`)
on hand-built trace summaries, and the manifest's entries for it."""

import json
from collections import Counter

import pytest
import torch
from _small import ROOT, SEED

from portbench.lib import flops
from portbench.lib import manifest as mf
from portbench.lib import shapes_swin_v2_t
from portbench.lib.faults import Fault
from portbench.lib.harness import run_cell
from portbench.lib.trace import Summary

from cgs_tpu_torch.utils import profiling

CELL = "swin_v2_t.process"
SMALL = {"pool_frames": 12, "batch": 4, "sample_per_call": 3}
NEW = ("window_attn_ms_per_batch.process", "window_attn_roofline.swin_v2_t")
SHARED = ("mfu.process", "ingest_roofline", "copy_ms_per_batch.process",
          "copy_gb_per_s.process", "idle.process",
          "host_idle_ms_per_batch.process", "pointwise_ms_per_batch.process",
          "mask_head_ms_per_batch.process")
KERNEL = ("fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::"
          "AttentionKernel<float, cutlass::arch::Sm80, true, 64, 64, 64, "
          "true, true>::Params)")


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


def test_control_tool_plants_each_kind():
    """`tools/control_swin_v2_t.py`, which read the limits: the sound run
    correct; the shift mask zeroed in the program and a fault planted
    with the process kind both not; the program's mask back after."""
    from cgs_tpu_torch.models import swin
    from portbench.tools import control_swin_v2_t as control

    torch.set_num_threads(2)
    mask = swin.shift_mask
    recs = {r["kind"]: r for r in control.readings(
        [SEED], ["sound", "no_shift_mask", "answer_altered"], 0.3, SMALL,
        device="cpu")}
    assert recs["sound"]["correct"] is True, recs["sound"]
    for kind in ("no_shift_mask", "answer_altered"):
        assert recs[kind]["correct"] is False, recs[kind]
    assert swin.shift_mask is mask


def _read(name, summary, layer, config):
    return mf.metric_reader(name).read(
        {"summary": summary, "layer": layer, "config": config,
         "traffic": {}, "flops": flops})


def _config():
    return mf.load_json(ROOT / "portbench/configs/swin_v2_t.json")


def _summary(device):
    return Summary(window_s=1.0, busy_s=0.5, device=list(device), gaps=[])


def _counted(monkeypatch, **kw):
    monkeypatch.setattr(profiling, "counts", Counter(kw))


def test_shapes_count_the_published_model():
    """The stages at 64x64 under the authors' rule, and the sums the
    readers and `mfu.process` use: 1.406 GFLOP a frame (0.710 of the
    critic's linears and patch ops, 0.021 of attention, 0.675 of the
    decoder), the attention's 15.3 GB a batch of 8192."""
    cfg = _config()
    assert shapes_swin_v2_t.stages(cfg) == [
        (96, 2, 3, 16, 8, 4), (192, 2, 6, 8, 8, 0), (384, 6, 12, 4, 4, 0),
        (768, 2, 24, 2, 2, 0)]
    assert 2 * sum(L.macs_per_frame for L in shapes_swin_v2_t.critic_layers(
        cfg)) == 710_149_632
    assert shapes_swin_v2_t.window_attn_flops(cfg, 1) == 21_331_968
    assert shapes_swin_v2_t.process_flops_per_frame(cfg) == 1_406_240_256
    assert shapes_swin_v2_t.window_attn_bytes(cfg, 8192) == 15_301_487_616
    attns = shapes_swin_v2_t.window_attns(cfg)
    assert [a[5] for a in attns] == [0, 4] + [0] * 10
    assert [(a[1], a[3]) for a in attns] == [(4, 64)] * 2 + [(1, 64)] * 2 \
        + [(1, 16)] * 6 + [(1, 4)] * 2
    p = shapes_swin_v2_t.seeded_params(cfg, SEED, "cpu")["critic"]
    tau = torch.cat([v.flatten() for k, v in p.items()
                     if k.endswith("logit_scale")]).exp()
    assert 5.0 <= float(tau.min()) and float(tau.max()) <= 20.0


def test_window_attn_ms_per_batch_on_a_summary(monkeypatch):
    cfg = _config()
    layer = {"batch": 8, "frames_traced": 16}
    att = [(i * 10.0, i * 10.0 + 5.0, KERNEL) for i in range(24)]
    other = [(500.0, 900.0, "sm80_xmma_gemm_f32f32_f32f32_f32_tn_n")]
    _counted(monkeypatch, **{"model.critic_frames": 24,
                             "model.window_attns": 36})
    # 2 batches of 12 launches, 5 us each: 0.06 ms a batch
    assert _read("window_attn_ms_per_batch.process", _summary(att + other),
                 layer, cfg) == pytest.approx(0.06)
    assert _read("window_attn_ms_per_batch.process",
                 _summary(att[:-1] + other), layer, cfg) is None
    _counted(monkeypatch)
    assert _read("window_attn_ms_per_batch.process", _summary(att), layer,
                 cfg) is None
    monkeypatch.delattr(profiling, "counts")
    assert _read("window_attn_ms_per_batch.process", _summary(att), layer,
                 cfg) is None


def test_window_attn_roofline_on_a_summary(monkeypatch):
    cfg = _config()
    batch = 8192
    layer = {"batch": batch, "frames_traced": 2 * batch}
    # at f32 the attention is bound by its bytes, not FLOPs
    nbytes = shapes_swin_v2_t.window_attn_bytes(cfg, batch)
    bound_s = nbytes / flops.PEAK_HBM_BYTES_PER_S
    assert bound_s > shapes_swin_v2_t.window_attn_flops(cfg, batch) \
        / flops.PEAK_F32_FLOPS
    per = 8 * bound_s * 1e6 / 12      # each batch's 12 at 8x the bound
    att = [(i * per, (i + 1) * per, KERNEL) for i in range(24)]
    other = [(1e7, 2e7, "vectorized_layer_norm_kernel")]
    _counted(monkeypatch, **{"model.critic_frames": 3 * batch,
                             "model.window_attns": 36})
    assert _read("window_attn_roofline.swin_v2_t", _summary(att + other),
                 layer, cfg) == pytest.approx(12.5)
    assert _read("window_attn_roofline.swin_v2_t", _summary(att[:-1]),
                 layer, cfg) is None
    monkeypatch.delattr(profiling, "counts")
    assert _read("window_attn_roofline.swin_v2_t", _summary(att), layer,
                 cfg) is None


def test_math_path_reads_nothing(monkeypatch):
    """Attention that took PyTorch's math path (no `fmha_cutlassF`
    kernel) gives the readers nothing to read."""
    cfg = _config()
    layer = {"batch": 8, "frames_traced": 8}
    math_path = [(i * 10.0, i * 10.0 + 5.0,
                  "cunn_SoftMaxForward<4, float, float, float>")
                 for i in range(12)]
    _counted(monkeypatch, **{"model.critic_frames": 8,
                             "model.window_attns": 12})
    for name in NEW:
        assert _read(name, _summary(math_path), layer, cfg) is None


def test_manifest_names_the_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    man = mf.Manifest(ROOT)
    cell = man.cell(CELL)
    assert cell.chips == 1 and cell.traffic["driver"] == "process_swin_v2_t"
    assert cell.config["reduced"] == [] and cell.config["tf32"] is False
    assert set(cell.limits) >= {"pred_gap", "level_gap", "hard_gap"}
    traced = {m.name for m in man.metrics_for(CELL, True)}
    assert traced == set(NEW) | set(SHARED)
    assert {m.name for m in man.metrics_for(CELL, False)} == {
        "frames_per_s", "setup_s"}
    conf = {c["name"]: c for c in bench["configs"]}["swin_v2_t"]
    assert conf["reduced"] == [] and conf["file"].endswith("swin_v2_t.json")
    for name in NEW:
        reader = mf.metric_reader(name)
        assert reader.MOVES == "frames_per_s"
        assert reader.LAYER == "model step: models/swin.py under pipeline.py"
