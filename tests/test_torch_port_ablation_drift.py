"""PyTorch port: the paired ablation and the critic-drift probe
(`cgs_tpu_torch/sandbox/ablation.py`, `sandbox/drift.py`).

The ablation's own copies of `VARIANT_FLAGS`, `_with_variant` and
`paired_summary` equal the JAX package's (`cgs_tpu/sandbox/ablation.py`)
on the same inputs, and the ablation passes each variant's flags,
--runs, --base-seed and the 'slow' cell to the port's seed-parallel
runner, with the JAX package's guard rails. The drift probe equals the
JAX package's `_make_probe` on the same converted weights and inputs
(within 1e-5) and reads exactly 0 drift for the phase-1 critic itself;
a tiny `drift.main` on the CPU shows the frozen variant's rows at 0
and the full model's above.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cgs_tpu.sandbox import ablation as jax_ablation
from cgs_tpu.sandbox import drift as jax_drift
from cgs_tpu_torch.models.interop import CRITIC_KEYMAP, state_dict_from_flax
from cgs_tpu_torch.sandbox import ablation, drift
from cgs_tpu_torch.sandbox import seed_parallel
from cgs_tpu_torch.train.losses import ingest
from torch_port_common import (  # noqa: F401 (one_torch_thread: fixture)
    jax_models, one_torch_thread, port_models, port_params,
)

IOUS = {
    "full": [0.6, 0.7, 0.5],
    "noinject": [0.5, 0.6, 0.45],
    "frozen": [0.7, 0.8, 0.6],
    "separate": [0.4, 0.5, 0.3],
}


def _fake_seed_parallel(calls):
    def fake_main(argv):
        calls.append(list(argv))
        if "--critic-lr-scale" in argv:
            return {"ious": [0.65, 0.72, 0.6]}
        present = [v for v, fs in ablation.VARIANT_FLAGS.items()
                   if fs and set(fs) <= set(argv)]
        return {"ious": IOUS[present[0] if present else "full"]}
    return fake_main


@pytest.mark.parametrize("results", [
    {v: {"ious": IOUS[v]} for v in IOUS},
    {"full": {"ious": [0.9]}, "frozen": {"ious": [0.8]}},
    {"full": {"ious": [0.61, 0.72]}, "separate": {"ious": [0.7, 0.7]},
     "slow": {"ious": [0.5, 0.9]}},
])
def test_paired_summary_equals_jax(results):
    assert ablation.paired_summary(results) == \
        jax_ablation.paired_summary(results)


def test_paired_summary_rejects_unequal_lengths():
    res = {v: {"ious": IOUS[v]} for v in IOUS}
    res["frozen"] = {"ious": IOUS["frozen"][:2]}
    with pytest.raises(ValueError, match="frozen"):
        ablation.paired_summary(res)


@pytest.mark.parametrize("argv", [
    ["--model", "abl"], ["--model=abl"], ["-synthetic_data"],
    ["--model", "a", "--model", "b"]])
@pytest.mark.parametrize("variant", list(jax_ablation.VARIANT_FLAGS))
def test_with_variant_equals_jax(argv, variant):
    assert ablation.VARIANT_FLAGS == jax_ablation.VARIANT_FLAGS
    assert ablation._with_variant(argv, variant) == \
        jax_ablation._with_variant(argv, variant)


def test_run_ablation_paired_flow(monkeypatch, tmp_path):
    monkeypatch.chdir(tmp_path)
    calls = []
    monkeypatch.setattr(seed_parallel, "main", _fake_seed_parallel(calls))
    out = ablation.main(["--runs", "3", "-synthetic_data", "--model", "abl",
                         "--base-seed", "10", "--slow-critic=0.1"])
    assert [c[c.index("--model") + 1] for c in calls] == [
        "abl-full", "abl-noinject", "abl-frozen", "abl-separate", "abl-slow"]
    for argv, variant in zip(calls, list(ablation.VARIANT_FLAGS) + ["slow"]):
        assert argv[argv.index("--runs") + 1] == "3"
        assert argv[argv.index("--base-seed") + 1] == "10"
        for other, flags in ablation.VARIANT_FLAGS.items():
            for f in flags:
                assert (f in argv) == (other == variant)
    assert calls[-1][calls[-1].index("--critic-lr-scale") + 1] == "0.1"
    summary = open("results.txt").read()
    assert summary == ablation.paired_summary(out) + "\n"
    assert "+0.100" in summary and "3/3 above full" in summary


def test_ablation_guard_rails():
    with pytest.raises(SystemExit):
        ablation.run_ablation(["-frozen", "--model", "x"], runs=2)
    with pytest.raises(SystemExit):
        ablation.run_ablation(["--model", "x"], runs=2,
                              variants=("frozen", "separate"))


def _probe_inputs(seed=0):
    rng = np.random.default_rng(seed)

    def u8(n):
        return rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)

    return dict(x_test=u8(12), y_test=rng.random(12).astype(np.float32),
                xpos=u8(6), xneg=u8(7), probe_x=u8(5), x_eval=u8(9),
                gt=rng.random((9, 64, 64)) > 0.6)


def _port_probe(jparams, c0, inp, thresh):
    critic, masker = port_models()
    params = port_params(jparams)
    critic.load_state_dict(params["critic"])
    masker.load_state_dict(params["masker"])
    theta1 = state_dict_from_flax(c0, CRITIC_KEYMAP)
    critic0, _ = port_models()
    critic0.load_state_dict(theta1)
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in inp.items()}
    with torch.no_grad():
        _, embeds1 = critic0.eval()(ingest(t["probe_x"]), collect=True)
    return drift.probe(critic, masker, theta1, t["x_test"], t["y_test"],
                       t["xpos"], t["xneg"], t["probe_x"], embeds1,
                       t["x_eval"], t["gt"], thresh)


def test_probe_equals_jax_make_probe(one_torch_thread):
    jcritic, jmasker, jparams = jax_models(chfak=1)
    c0 = jax_models(chfak=1, seed=1)[2]["critic"]    # a 'phase-1' critic
    inp = _probe_inputs()
    thresh = 0.5
    got = _port_probe(jparams, c0, inp, thresh)

    probe = jax_drift._make_probe(jcritic, jmasker, thresh)
    _, embeds1 = jcritic.apply({"params": c0}, jnp.asarray(
        inp["probe_x"], jnp.float32) / 255.0, collect=True)
    n, eb = inp["x_eval"].shape[0], 4
    eval_idx = jnp.asarray(np.minimum(
        np.arange(-(-n // eb) * eb, dtype=np.int32), n - 1).reshape(-1, eb))
    want = jax.tree.map(np.asarray, probe(
        jparams["critic"], jparams["masker"], c0,
        *(jnp.asarray(inp[k]) for k in ("x_test", "y_test", "xpos", "xneg",
                                        "probe_x")),
        embeds1, jnp.asarray(inp["x_eval"]), jnp.asarray(inp["gt"]),
        eval_idx))
    assert 0.0 < float(want["iou"]) < 1.0
    for key in ("test_mse", "separation", "param_drift", "iou"):
        np.testing.assert_allclose(got[key], float(want[key]), atol=1e-5,
                                   err_msg=key)
    assert got["param_drift"] > 0.1
    np.testing.assert_allclose(got["embeds_drift"], want["embeds_drift"],
                               atol=1e-5)


def test_probe_of_the_phase1_critic_reads_zero_drift(one_torch_thread):
    _, _, jparams = jax_models(chfak=1)
    got = _port_probe(jparams, jparams["critic"], _probe_inputs(1), 0.05)
    assert got["param_drift"] == 0.0
    assert got["embeds_drift"] == [0.0] * 5


def test_drift_main_frozen_reads_zero_full_drifts(tmp_path, monkeypatch,
                                                  capsys, one_torch_thread):
    monkeypatch.chdir(tmp_path)
    from cgs_tpu_torch.data import synthetic
    real_set = synthetic.synthetic_eval_set
    monkeypatch.setattr(synthetic, "synthetic_eval_set",   # 490 frames
                        lambda n_frames, **kw: real_set(1080, **kw))
    results = drift.main(
        ["--device", "cpu", "-synthetic_data", "--datasize", "600",
         "--testsize", "100", "--cepochs", "6", "--batch-size", "32",
         "--dropout", "0", "--high-rew-thresh", "0.55",
         "--low-rew-thresh", "0.45", "--contrastive-min", "5",
         "--mepochs", "1", "--model", "dr", "--variants", "full,frozen"],
        primary=False)
    keys = {"epoch", "test_mse", "separation", "param_drift", "iou",
            "embeds_drift"}
    for variant, rows in results.items():
        assert [r["epoch"] for r in rows] == [0, 1]
        assert keys <= set(rows[0]) and len(rows[0]["embeds_drift"]) == 5
        assert "replace_loss" in rows[1]
    assert results["frozen"][1]["param_drift"] == 0.0
    assert results["frozen"][1]["embeds_drift"] == [0.0] * 5
    assert results["full"][1]["param_drift"] > 0.0
    assert min(results["full"][1]["embeds_drift"]) > 0.0
    # the variants share the phase-1 critic: their epoch-0 rows agree
    assert results["full"][0] == results["frozen"][0]
    out = capsys.readouterr().out
    assert out.count('"variant": "dr-frozen"') == 2
    assert "drift summary" in out


def test_drift_requires_synthetic_data_and_known_variants():
    with pytest.raises(SystemExit, match="synthetic"):
        drift.main(["--device", "cpu"])
    with pytest.raises(SystemExit, match="unknown variants"):
        drift.main(["--device", "cpu", "-synthetic_data",
                    "--variants", "full,bogus"])
