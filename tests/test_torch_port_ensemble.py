"""PyTorch port: the mean-mask ensemble (`MaskPipeline(ensemble=True)`,
`train/checkpoints.py:load_seed_ensemble`, `--ensemble N`) against the
JAX package's, on the same R = 3 members.

Tolerances as in tests/test_torch_port_pipeline.py: preds and f32 masks
1e-5; saliency rtol 1e-4 / atol 1e-6; u8 wire +-1 (the JAX mean and the
port's member-order sum round differently). Within the port the wire is
exact: it encodes the mean.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax

from cgs_tpu.core.config import parse_args as jax_parse_args
from cgs_tpu.eval.segment import segment_folder as jax_segment_folder
from cgs_tpu.pipeline import MaskPipeline as JPipeline
from cgs_tpu.train.checkpoints import checkpoint_paths as jax_ckpt_paths
from cgs_tpu.train.checkpoints import save_model_pt as jax_save_pt
from cgs_tpu_torch import cli
from cgs_tpu_torch.core.config import parse_args
from cgs_tpu_torch.data.synthetic import synthetic_eval_set
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.train.checkpoints import load_seed_ensemble
from torch_port_common import (  # noqa: F401 (one_torch_thread: fixture)
    jax_models, one_torch_thread, port_models, port_params,
)

R = 3
THRESH = 0.5


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(2).integers(0, 256, (21, 64, 64, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def members():
    """(JAX critic, JAX masker, JAX members, port members): member s is
    the seeded JAX weights plus seeded noise of std 0.05 (member 0: the
    weights as they are)."""
    jc, jm, base = jax_models()
    jtrees = []
    for s in range(R):
        rng = np.random.default_rng(s)
        jtrees.append({n: jax.tree.map(
            lambda a: (a + (s > 0) * rng.normal(0, 0.05, a.shape))
            .astype(a.dtype), base[n]) for n in ("critic", "masker")})
    return jc, jm, jtrees, [port_params(t) for t in jtrees]


def _stacked(jtrees):
    return jax.tree.map(lambda *a: np.stack(a), *jtrees)


def _pipes(members, **kw):
    jc, jm, jtrees, pmembers = members
    pc, pm = port_models()
    return (JPipeline(jc, jm, _stacked(jtrees), batch_size=8,
                      ensemble=True, **kw),
            MaskPipeline(pc, pm, pmembers, batch_size=8, ensemble=True,
                         device="cpu", **kw))


def test_ensemble_equals_jax(members, frames, one_torch_thread):
    jpipe, pipe = _pipes(members)
    a, b = jpipe.run(frames), pipe.run(frames)
    assert b.preds.shape == (21,) and b.masks.shape == (21, 64, 64, 1)
    np.testing.assert_allclose(b.preds, a.preds, atol=1e-5)
    np.testing.assert_allclose(b.masks, a.masks, atol=1e-5)
    # the mean of three single-member pipelines
    pc, pm = port_models()
    singles = [MaskPipeline(pc, pm, p, batch_size=8, device="cpu")
               .run(frames) for p in members[3]]
    np.testing.assert_allclose(
        b.masks, sum(s.masks for s in singles) / R, atol=1e-6)
    np.testing.assert_allclose(
        b.preds, sum(s.preds for s in singles) / R, atol=1e-6)
    assert np.abs(singles[0].masks - b.masks).max() > 1e-3


def test_ensemble_saliency_equals_jax(members, frames, one_torch_thread):
    jpipe, pipe = _pipes(members, salience=True)
    a, b = jpipe.run(frames[:8]), pipe.run(frames[:8])
    np.testing.assert_allclose(b.saliency, a.saliency, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(b.masks, a.masks, atol=1e-5)


def test_ensemble_wire_encodes_the_mean(members, frames, one_torch_thread):
    jpipe, pipe = _pipes(members, wire="u8", hard_threshold=THRESH)
    a, b = jpipe.run(frames), pipe.run(frames)
    assert b.masks is None
    diff = np.abs(b.masks_u8.astype(int) - a.masks_u8.astype(int))
    assert diff.max() <= 1
    # within the port: the u8 wire and the hard plane are those of the
    # f32 mean, not means of encoded members
    mean = _pipes(members)[1].run(frames).masks
    np.testing.assert_array_equal(
        b.masks_u8, (255 * np.clip(mean, 0, 1)).astype(np.uint8))
    np.testing.assert_array_equal(b.hard, (mean >= THRESH).astype(np.uint8))


def test_ensemble_update_params_and_bad_members(members, frames):
    _, _, _, pmembers = members
    pc, pm = port_models()
    pipe = MaskPipeline(pc, pm, pmembers[:2], batch_size=8, ensemble=True,
                        device="cpu")
    pipe.update_params(pmembers)
    full = _pipes(members)[1].run(frames[:8])
    np.testing.assert_array_equal(pipe.run(frames[:8]).masks, full.masks)
    pipe.update_params(pmembers[:1])           # R = 1 is one model
    single = MaskPipeline(pc, pm, pmembers[0], batch_size=8, device="cpu")
    np.testing.assert_array_equal(pipe.run(frames[:8]).masks,
                                  single.run(frames[:8]).masks)
    with pytest.raises(ValueError, match="member"):
        MaskPipeline(pc, pm, [], ensemble=True, device="cpu")


def test_ensemble_noevalmode_draws_in_member_order(members, frames):
    """-noevalmode: the members draw their dropout from the pipeline's
    one generator, member 0 first; the same seed gives the same masks."""
    _, _, _, pmembers = members
    pc, pm = port_models(dropout=0.3)

    def ensemble(seed):
        return MaskPipeline(pc, pm, pmembers, batch_size=8, ensemble=True,
                            eval_mode=False, seed=seed, device="cpu")

    got = ensemble(5).run(frames[:8])
    gen = torch.Generator().manual_seed(5)
    singles = []
    for member in pmembers:
        single = MaskPipeline(pc, pm, member, batch_size=8, eval_mode=False,
                              device="cpu")
        single.generator = gen
        singles.append(single.run(frames[:8]))
    np.testing.assert_allclose(
        got.masks, sum(s.masks for s in singles) / R, atol=1e-6)
    np.testing.assert_array_equal(ensemble(5).run(frames[:8]).masks,
                                  got.masks)
    assert not np.array_equal(ensemble(6).run(frames[:8]).masks, got.masks)


def _write_members(argv, jtrees, seeds):
    """Save member s as the run `{model}-seed{s}` where --ensemble
    looks for it, with the JAX package's writer."""
    for s, tree in zip(seeds, jtrees):
        cfg = jax_parse_args(argv + ["--model", f"ens-seed{s}"])
        paths = jax_ckpt_paths(cfg)
        for name in ("critic", "masker"):
            jax_save_pt(tree[name], name, paths[name])


def test_load_seed_ensemble(members, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _, _, jtrees, pmembers = members
    _write_members(["-eval"], jtrees, [2, 3, 4])
    cfg = parse_args(["-eval", "--model", "ens", "--device", "cpu"])
    got = load_seed_ensemble(cfg, 3, base_seed=2)
    assert len(got) == 3
    for m, want in zip(got, pmembers):
        assert set(m) == {"critic", "masker"}
        for name in m:
            for k, v in want[name].items():
                assert m[name][k].device.type == "cpu"
                torch.testing.assert_close(m[name][k], v, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="ens-seed1/saves/critic"):
        load_seed_ensemble(cfg, 3, base_seed=1)
    with pytest.raises(FileNotFoundError, match="ens-seed5/saves/critic"):
        load_seed_ensemble(cfg, 4, base_seed=2)
    sep = parse_args(["-eval", "-separate", "--model", "ens"])
    with pytest.raises(ValueError, match="separate"):
        load_seed_ensemble(sep, 3, base_seed=2)


def test_process_ensemble_writes_jax_names(members, tmp_path, monkeypatch,
                                           one_torch_thread):
    """-process --ensemble 3 through the port's CLI writes the JAX
    driver's files, with masks within the u8 wire's +-1."""
    monkeypatch.chdir(tmp_path)
    jc, jm, jtrees, _ = members
    src = tmp_path / "src"
    src.mkdir()
    x, _ = synthetic_eval_set(n_frames=6, seed=4)
    for i, f in enumerate(x):
        Image.fromarray(f).save(src / f"img{i}.png")
    argv = ["-process", "--source-imgs", str(src), "--ensemble", "3",
            "--model", "ens", "-concatenated"]
    _write_members(argv, jtrees, range(3))
    handler = cli.main(argv + ["--mask-output-imgs", "ours", "--device",
                               "cpu"])
    assert handler._ensemble_params is not None
    pipe = handler._pipes[(False, "u8", 0.5)]
    assert pipe.ensemble and len(pipe._members) == 3
    # reused: not refreshed from the Handler's own (random) weights
    assert handler._pipeline(False, "u8", 0.5) is pipe
    jcfg = jax_parse_args(argv)
    jax_segment_folder(jcfg, JPipeline(jc, jm, _stacked(jtrees),
                                       batch_size=8, ensemble=True,
                                       wire="u8", hard_threshold=0.5),
                       str(src), out_dir="theirs")
    ours, theirs = sorted(os.listdir("ours")), sorted(os.listdir("theirs"))
    assert ours == theirs == [f"img{i}_with_mask.png" for i in range(6)]
    for name in ours:
        a = np.asarray(Image.open(f"ours/{name}")).astype(int)
        b = np.asarray(Image.open(f"theirs/{name}")).astype(int)
        assert a.shape == b.shape == (64, 192, 3)
        assert np.abs(a[:, :128] - b[:, :128]).max() <= 1
