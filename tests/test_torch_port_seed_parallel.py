"""PyTorch port: the seed-parallel runner with the seed axis written out
(`cgs_tpu_torch/sandbox/seed_parallel.py`, `models/seeded.py`, the
R-seed ingest of `ops/kernels.py:gather_normalize_u8`).

On the CPU, at chfak 1 (the seeded critic chunk against the JAX
package's is in `test_torch_port_seed_parallel_jax.py`): the seeded
masker chunk against the port's serial `masker_step`, seed by seed, for every
ablation variant (dropout 0, each seed its own given shift; loss terms
and params within 1e-5: a grouped convolution sums as the R single
ones do, up to the order of a few float32 sums); the R-seed ingest's
plain version against JAX's `normalize_u8` (Pallas, interpret mode) of
each seed's rolled frames, bit for bit; `eval_seeds` and
`ensemble_iou` against host numpy IoUs of the serial models' masks;
and a tiny `run_parallel` end to end.
"""

import dataclasses
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cgs_tpu.ops.pallas_kernels import normalize_u8 as jax_normalize_u8
from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.models.interop import unstack_seed
from cgs_tpu_torch.models.seeded import SeededCritic, SeededDecoder
from cgs_tpu_torch.ops.kernels import (
    Segment, gather_normalize_u8, gather_normalize_u8_plain,
)
from cgs_tpu_torch.sandbox import seed_parallel as sp
from cgs_tpu_torch.train.steps import (
    StepRng, make_optimizer, masker_step, trained_param_keys,
)
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

R = 2
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def bank():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (32, 64, 64, 3), dtype=np.uint8)
    y = rng.random(32).astype(np.float32)
    return x, y


def _seeded(state_by_name, separate=False, dropout=0.0):
    critic = SeededCritic(R, dropout=dropout)
    critic.load_state_dict(state_by_name["critic"])
    models = {"critic": critic.to(memory_format=torch.channels_last)}
    masker = SeededDecoder(R)
    masker.load_state_dict(state_by_name["masker"])
    models["masker"] = masker.to(memory_format=torch.channels_last)
    if separate:
        sep = SeededCritic(R, dropout=dropout)
        sep.load_state_dict(state_by_name["sepcrit"])
        models["sepcrit"] = sep.to(memory_format=torch.channels_last)
    return {n: m.train() for n, m in models.items()}


VARIANTS = ["default", "frozen", "noinject", "separate"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_seeded_masker_chunk_matches_serial_step(variant, bank,
                                                 one_torch_thread):
    """Two seeded masker steps of R = 2 seeds, each seed its own shift,
    against two serial `masker_step`s per seed on the same index stacks
    and shifts."""
    x, y = bank
    flags = {} if variant == "default" else {variant: True}
    cfg = Config(shift=4, dropout=0.0, device="cpu", **flags).derive()
    init = sp.init_seed_params(Critic(), UnetDecoder(), [0, 1],
                               separate=cfg.separate)
    rng = np.random.default_rng(7)
    h = rng.integers(0, 32, (R, 2, 32))
    l = rng.integers(0, 32, (R, 2, 32))
    c = rng.integers(0, 32, (R, 2, 64))
    shifts = np.array([[3, -5], [0, 11]])             # (S, R)
    x_t, y_t = torch.from_numpy(x), torch.from_numpy(y)
    trained = trained_param_keys(cfg)

    models = _seeded(init, cfg.separate)
    for name, m in models.items():
        m.requires_grad_(name in trained)
    opt = make_optimizer({n: models[n] for n in trained})
    terms = sp.seeded_masker_chunk(cfg, models, opt, x_t, y_t, h, l, c,
                                   sp.SeedRng.seeded([0, 1], CPU),
                                   shifts=shifts)
    assert terms.shape == (R, 2, 4)
    if variant == "noinject":
        assert float(terms[..., 1].abs().max()) == 0.0
    if variant == "frozen":
        assert torch.equal(models["critic"].state_dict()["features.0.weight"],
                           init["critic"]["features.0.weight"])

    serial_cfg = dataclasses.replace(cfg, shift=0)
    for r in range(R):
        smodels = {}
        for name in models:
            m = (UnetDecoder() if name == "masker" else Critic(dropout=0.0))
            m.load_state_dict(unstack_seed(init[name], r, R))
            smodels[name] = m.to(memory_format=torch.channels_last).train()
            smodels[name].requires_grad_(name in trained)
        sopt = make_optimizer({n: smodels[n] for n in trained})
        for s in range(2):
            a = [Segment(x_t, torch.from_numpy(h[r, s]), int(shifts[s, r]),
                         y_t),
                 Segment(x_t, torch.from_numpy(l[r, s]), int(shifts[s, r]),
                         y_t)]
            want = masker_step(serial_cfg, smodels, sopt, a,
                               Segment(x_t, torch.from_numpy(c[r, s])),
                               StepRng.seeded(0, CPU))
            np.testing.assert_allclose(terms[r, s].numpy(),
                                       torch.stack(want).numpy(), atol=1e-5,
                                       err_msg=f"seed {r} step {s}")
        for name, model in models.items():
            got = unstack_seed(model.state_dict(), r, R)
            for k, v in smodels[name].state_dict().items():
                np.testing.assert_allclose(got[k].numpy(), v.numpy(),
                                           atol=1e-5,
                                           err_msg=f"seed {r} {name}.{k}")


def test_seeded_ingest_plain_matches_jax(bank):
    """Segment-major, seed-major within a segment, each seed rolled by
    its own shift; labels of the labelled segment beside its frames."""
    x, y = bank
    rng = np.random.default_rng(3)
    ia, ib = rng.integers(0, 32, (3, 5)), rng.integers(0, 32, (3, 4))
    shifts = [7, -63, 0]
    segs = [Segment(torch.from_numpy(x), torch.from_numpy(ia), shifts,
                    torch.from_numpy(y)),
            Segment(torch.from_numpy(x), torch.from_numpy(ib))]
    got, labels = gather_normalize_u8(segs)
    want_plain, want_lab = gather_normalize_u8_plain(segs)
    assert torch.equal(got, want_plain) and torch.equal(labels, want_lab)
    pieces = [jnp.roll(jnp.take(jnp.asarray(x), ia[r], axis=0), shifts[r],
                       axis=2) for r in range(3)]
    pieces += [jnp.take(jnp.asarray(x), ib[r], axis=0) for r in range(3)]
    want = np.asarray(jax_normalize_u8(
        jnp.concatenate(pieces).reshape(27, -1), interpret=True)
    ).reshape(27, 64, 64, 3)
    assert got.shape == (27, 64, 64, 3)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))
    np.testing.assert_array_equal(labels.numpy(), y[ia.reshape(-1)])


def test_seeded_ingest_checks_seeds(bank):
    x, y = bank
    xt = torch.from_numpy(x)
    two = torch.zeros((2, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="same 2 seeds"):
        gather_normalize_u8([Segment(xt, two), Segment(xt, two[0])])
    with pytest.raises(ValueError, match="3 shifts for 2 seeds"):
        gather_normalize_u8([Segment(xt, two, [1, 2, 3])])
    with pytest.raises(ValueError, match="1 to 64 seeds"):
        gather_normalize_u8([Segment(xt, torch.zeros((65, 1),
                                                     dtype=torch.int64))])


def _host_iou(m, g, t):
    hard = m > t
    return float((hard & g).sum()) / max(float((hard | g).sum()), 1.0)


def test_eval_seeds_and_ensemble_match_host_numpy(one_torch_thread):
    init = sp.init_seed_params(Critic(), UnetDecoder(), [3, 4])
    models = _seeded(init)
    rng = np.random.default_rng(5)
    xe = rng.integers(0, 256, (10, 64, 64, 3), dtype=np.uint8)
    gt = rng.random((10, 64, 64)) > 0.5
    xt, gtt = torch.from_numpy(xe), torch.from_numpy(gt)
    ious = sp.eval_seeds(models["critic"], models["masker"], xt, gtt,
                         thresh=0.5, batch=4)
    ens = sp.ensemble_iou(models["critic"], models["masker"], xt, gtt,
                          thresh=0.5, batch=4)
    masks = []
    for r in range(R):
        c, m = Critic(dropout=0.0).eval(), UnetDecoder().eval()
        c.load_state_dict(unstack_seed(init["critic"], r, R))
        m.load_state_dict(unstack_seed(init["masker"], r, R))
        xf = torch.from_numpy(xe).float().mul(1 / 255.).permute(0, 3, 1, 2)
        xf = xf.contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            _, em = c(xf, collect=True)
            masks.append(m(xf, em)[:, 0].numpy())
    want = [_host_iou(mk, gt, 0.5) for mk in masks]
    assert 0.0 < min(want) and max(want) < 1.0
    np.testing.assert_allclose(ious, want, atol=1e-6)
    np.testing.assert_allclose(ens, _host_iou(np.mean(masks, 0), gt, 0.5),
                               atol=1e-6)


def test_mesh_raises_naming_its_roadmap_item():
    """mesh= is ported (queue 1 item 4, `test_torch_port_dp_train.py`):
    what raises now is a seed count that does not divide over the
    ranks, before any work."""
    from cgs_tpu_torch.parallel.mesh import Mesh
    with pytest.raises(ValueError, match="must divide over the 2 ranks"):
        sp.run_parallel(Config(device="cpu").derive(), None, None, 3,
                        mesh=Mesh(rank=0, world=2, device=CPU))


def test_run_parallel_end_to_end(tmp_path, monkeypatch, one_torch_thread):
    """R = 2 on 1200 synthetic frames: the common masker step count,
    per-seed .pt files that `load_seed_ensemble` reads (phase-1 critic,
    final masker), and the JAX runner's results.txt line."""
    from cgs_tpu_torch.data.synthetic import (
        synthetic_dataset, synthetic_eval_set,
    )
    from cgs_tpu_torch.train.checkpoints import load_seed_ensemble

    monkeypatch.chdir(tmp_path)
    # 8 critic epochs: at 6, one seed in six (seed 4) predicts no frame
    # above 0.55 on this 1100-frame set
    cfg = Config(shift=4, dropout=0.0, batch_size=32, cepochs=8,
                 mepochs=1, testsize=100, high_rew_thresh=0.55,
                 low_rew_thresh=0.45, contrastive_min=5, model="sp",
                 device="cpu").derive()
    x, y, _ = synthetic_dataset(n_frames=1200, seed=0)
    xe, gt = synthetic_eval_set(n_frames=40, seed=99)
    out = sp.run_parallel(cfg, x, y, runs=R, base_seed=3, x_eval=xe,
                          gt_eval=gt, results_path="results.txt",
                          chunk_steps=16, verbose=False,
                          save_checkpoints=True)
    n_pos = max(p for p, _ in out["contrastive"])
    assert out["steps"] == {"critic": 8 * 35, "masker": -(-n_pos // 32)}
    assert out["critic_losses"].shape == (R, 8 * 35)
    assert out["masker_losses"].shape == (R, -(-n_pos // 32), 4)
    assert np.isfinite(out["masker_losses"]).all()
    assert len(out["ious"]) == R and 0.0 <= out["ensemble_iou"] <= 1.0
    line = open("results.txt").read()
    want = (f"runs=2 seed-parallel base_seed=3 "
            f"ious={[round(v, 3) for v in out['ious']]} "
            f"mean={out['mean']:.3f} std={out['std']:.3f} "
            f"best={out['best']:.3f} ensemble={out['ensemble_iou']:.3f}\n")
    assert line == want
    assert re.fullmatch(r"runs=2 seed-parallel base_seed=3 ious=\[[0-9., ]+\] "
                        r"mean=\S+ std=\S+ best=\S+ ensemble=\S+\n", line)
    members = load_seed_ensemble(cfg, R, base_seed=3)
    assert not torch.equal(members[0]["masker"]["masker.0.weight"],
                           members[1]["masker"]["masker.0.weight"])
    final = unstack_seed(out["params"]["masker"], 1, R)
    assert all(torch.equal(final[k], members[1]["masker"][k]) for k in final)
    # the saved critic is phase 1's: the live critic trained on after it
    live = unstack_seed(out["params"]["critic"], 0, R)
    assert not torch.equal(live["features.0.weight"],
                           members[0]["critic"]["features.0.weight"])


def test_run_parallel_masker_steps_replaces_the_common_count(
        tmp_path, monkeypatch, one_torch_thread):
    """masker_steps runs that many masker steps per epoch whatever the
    positives give, and refuses a count below 1 before training."""
    from cgs_tpu_torch.data.synthetic import synthetic_dataset

    monkeypatch.chdir(tmp_path)
    cfg = Config(shift=4, dropout=0.0, batch_size=32, cepochs=8,
                 mepochs=2, testsize=100, high_rew_thresh=0.55,
                 low_rew_thresh=0.45, contrastive_min=5, model="spm",
                 device="cpu").derive()
    with pytest.raises(ValueError, match="masker_steps must be >= 1"):
        sp.run_parallel(cfg, None, None, 1, masker_steps=0)
    x, y, _ = synthetic_dataset(n_frames=1200, seed=0)
    out = sp.run_parallel(cfg, x, y, runs=1, base_seed=3,
                          results_path=None, chunk_steps=2, verbose=False,
                          masker_steps=3)
    assert out["steps"] == {"critic": 8 * 35, "masker": 2 * 3}
    assert out["masker_losses"].shape == (1, 2 * 3, 4)
    assert np.isfinite(out["masker_losses"]).all()


def test_ten_seeds_masker_steps_needs_the_seed_parallel_runner(capsys):
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "ten_seeds.py"
    spec = importlib.util.spec_from_file_location("ten_seeds", path)
    ten_seeds = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ten_seeds)
    with pytest.raises(SystemExit) as e:
        ten_seeds.main(["--protocol", "B", "--masker-steps", "108"])
    assert e.value.code == 2
    assert "--masker-steps needs --runner seed-parallel" in \
        capsys.readouterr().err


def test_ten_seeds_tf32_needs_the_seed_parallel_runner(capsys):
    """--tf32 switches cuDNN's TF32 on in the seed-parallel runner only
    (the serial runner's CLI sets the switches of its own)."""
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).resolve().parents[1] / "ten_seeds.py"
    spec = importlib.util.spec_from_file_location("ten_seeds", path)
    ten_seeds = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ten_seeds)
    with pytest.raises(SystemExit) as e:
        ten_seeds.main(["--protocol", "B", "--tf32"])
    assert e.value.code == 2
    assert "--tf32 needs --runner seed-parallel" in capsys.readouterr().err
