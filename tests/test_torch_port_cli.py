"""PyTorch port: the flag grammar, the slices end to end (`-eval` and
`-process` through the port's CLI on the CPU, against the JAX
package's `evaluate` and `segment_folder` on the same weights and
frames; `-train -eval` on the CPU, its first critic chunk against the
JAX package's on the same weights and batches), the CPU-only default
guard, and the static import guard.
"""

import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cgs_tpu.core.config import parse_args as jax_parse_args
from cgs_tpu.data.collect import collect_data as jax_collect_data
from cgs_tpu.data.loader import DataBundle as JBundle
from cgs_tpu.data.loader import EpochLoader as JLoader
from cgs_tpu.eval.harness import evaluate as jax_evaluate
from cgs_tpu.eval.harness import load_eval_set as jax_load_eval_set
from cgs_tpu.eval.segment import segment_folder as jax_segment_folder
from cgs_tpu.pipeline import MaskPipeline as JPipeline
from cgs_tpu.train.loops import make_critic_chunk
from cgs_tpu.train.steps import init_train_state
from cgs_tpu.train.steps import make_optimizer as jax_make_optimizer
from cgs_tpu.train.checkpoints import checkpoint_paths as jax_ckpt_paths
from cgs_tpu.train.checkpoints import load_model_pt as jax_load_pt
from cgs_tpu.train.checkpoints import save_model_pt as jax_save_pt
from cgs_tpu_torch import cli
from cgs_tpu_torch.core.config import parse_args
from cgs_tpu_torch.data.synthetic import synthetic_eval_set
from cgs_tpu_torch.handler import Handler
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.train.checkpoints import load_model_pt
from torch_port_common import (  # noqa: F401 (one_torch_thread: fixture)
    jax_models, one_torch_thread, port_models, port_params,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("argv", [
    [],
    ["-eval", "-process", "--chfak", "5", "--bf16", "-salience",
     "--eval-thresh", "0.1", "--model", "m1", "-noinject", "-test"],
    ["-train", "-separate", "-synthetic_data", "--synthetic-variant",
     "hard", "--infer-batch", "64", "--serve-wire", "u8", "--lr", "1"],
])
def test_config_matches_jax_grammar(argv):
    ours = dataclasses.asdict(parse_args(argv + ["--device", "cpu"]))
    assert ours.pop("device") == "cpu"
    assert ours == dataclasses.asdict(jax_parse_args(argv))
    assert parse_args(argv).device == "cuda"      # the default
    cfg = parse_args(argv)
    jcfg = jax_parse_args(argv)
    assert cfg.critic_fingerprint() == jcfg.critic_fingerprint()
    assert cfg.masker_fingerprint() == jcfg.masker_fingerprint()


def test_synthetic_eval_set_equals_jax():
    from cgs_tpu.data.synthetic import synthetic_eval_set as jax_set
    for variant in ("easy", "hard"):
        x, gt = synthetic_eval_set(n_frames=700, seed=3, variant=variant)
        jx, jgt = jax_set(n_frames=700, seed=3, variant=variant)
        np.testing.assert_array_equal(x, jx)
        np.testing.assert_array_equal(gt, jgt)


def _write_jax_checkpoints(argv):
    """Save seeded JAX weights where -cload/-mload look for them."""
    _, _, jp = jax_models()
    paths = jax_ckpt_paths(jax_parse_args(argv))
    for name in ("critic", "masker"):
        jax_save_pt(jp[name], name, paths[name])
    return jp


def test_eval_slice_equals_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    # -cload/-mload are bool-typed: any value turns them on
    argv = ["-cload", "1", "-mload", "1", "-eval", "-synthetic_data",
            "-salience", "--model", "slice", "--eval-video-max-frames",
            "4"]
    jp = _write_jax_checkpoints(argv)
    handler = cli.main(argv + ["--device", "cpu"])
    assert handler.device == torch.device("cpu")
    ours = handler.last_ious

    jcfg = jax_parse_args(argv)
    jc, jm, _ = jax_models()
    x, gt = jax_load_eval_set(jcfg)
    jpipe = JPipeline(jc, jm, {"critic": jp["critic"],
                               "masker": jp["masker"]},
                      batch_size=128, salience=True)
    theirs = jax_evaluate(jcfg, jpipe, x, gt, write=False)["ious"]
    assert len(ours) == 2 and ours == [float(v) for v in theirs]
    videos = list((tmp_path / "eval-results" / "slice").glob("iou=*.mp4"))
    assert len(videos) == 1 and videos[0].stat().st_size > 0

    # the port's save_models writes what the JAX package loads back
    os.remove(handler.save_paths["critic"])
    handler.save_models(["critic"])
    back = jax_load_pt("critic", handler.save_paths["critic"])
    for name, leaf in jp["critic"].items():
        np.testing.assert_array_equal(np.asarray(back[name]["kernel"]),
                                      leaf["kernel"])


def _decode(folder):
    return {name: np.asarray(Image.open(folder / name))
            for name in sorted(os.listdir(folder))}


def test_process_slice_equals_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    src = tmp_path / "src"
    src.mkdir()
    frames, _ = synthetic_eval_set(n_frames=8, seed=5)
    for i, f in enumerate(frames):
        Image.fromarray(f).save(src / f"img{i:03d}.png")
    argv = ["-cload", "1", "-mload", "1", "-process", "--source-imgs",
            str(src), "--mask-output-imgs", str(tmp_path / "ours"),
            "--model", "slice"]
    jp = _write_jax_checkpoints(argv)
    cli.main(argv + ["--device", "cpu"])

    jcfg = jax_parse_args(argv)
    jc, jm, _ = jax_models()
    params = {"critic": jp["critic"], "masker": jp["masker"]}
    jax_segment_folder(jcfg, JPipeline(jc, jm, params, batch_size=128,
                                       wire="u8", hard_threshold=0.5),
                       str(src), out_dir=str(tmp_path / "theirs"))
    # the JAX f32 masks decide which hard pixels sit at the edge
    jmask = JPipeline(jc, jm, params, batch_size=128).run(frames).masks
    ours, theirs = _decode(tmp_path / "ours"), _decode(tmp_path / "theirs")
    assert ours.keys() == theirs.keys() and len(ours) == 16
    for name, a in ours.items():
        b = theirs[name]
        assert a.shape == b.shape == (64, 64, 3)
        i = int(name[3:6])
        diff = np.abs(a.astype(int) - b.astype(int))
        if name.endswith("-raw-mask.png"):
            assert diff.max() <= 1, name
        else:                                   # thresholded-mask
            edge = np.abs(jmask[i, ..., 0] - 0.5) < 1e-5
            assert not np.any(diff.max(axis=-1) * ~edge), name


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pc, pm = port_models()
    params = {"critic": pc.state_dict(), "masker": pm.state_dict()}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MaskPipeline(pc, pm, params)
    with pytest.raises(RuntimeError, match="--device cpu"):
        Handler(parse_args(["-eval"]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-eval", "-synthetic_data"])


# the arguments of tests/test_e2e_synthetic.py:17-19, with a short
# eval video
TRAIN_ARGS = ["-synthetic_data", "--datasize", "2000", "--testsize",
              "200", "--cepochs", "8", "--visevery", "40", "--dropout",
              "0", "--shift", "0", "--contrastive-min", "100", "--model",
              "e2erun", "--eval-video-max-frames", "4"]


def test_train_eval_slice_runs_and_tracks_jax(tmp_path, monkeypatch,
                                             one_torch_thread):
    """-train -eval through the port's CLI on the CPU writes both .pt
    files and the run's artifacts, and the saved critic loads back.
    Both packages start from the same weights (the JAX ones) and draw
    the same numpy batch order from --seed, so the first critic chunk
    (32 steps, dropout 0, shift 0) tracks the JAX chunk: step 0 within
    1e-5, the chunk within 3e-3 relative. Adam amplifies 1e-7 gradient
    noise (tests/test_torch_port_train.py), and how far the chunk
    drifts depends on the CPU's summation order: up to 1.4e-3 on one
    thread, under 1e-3 on eight."""
    monkeypatch.chdir(tmp_path)
    jc, _, jp = jax_models()

    def reset_models(self):
        self.params = {n: v for n, v in port_params(jp).items()
                       if n in ("critic", "masker")}

    monkeypatch.setattr(Handler, "reset_models", reset_models)
    handler = cli.main(["--device", "cpu", "-train", "-eval"] + TRAIN_ARGS)
    run = tmp_path / "e2erun"
    (critic_pt,) = (run / "saves").glob("critic-*.pt")
    assert list((run / "saves").glob("masker-*.pt"))
    back = Critic(dropout=0.0)
    back.load_state_dict(load_model_pt("critic", str(critic_pt)))
    w = back.state_dict()["features.0.weight"]
    # trained in phase 1; the live critic that phase 2 moved on stays in
    # memory unsaved (cgs_tpu/handler.py:524-525)
    assert not torch.equal(w, port_params(jp)["critic"]["features.0.weight"])
    assert not torch.equal(w, handler.params["critic"]["features.0.weight"])
    for art in ("critic/_loss.png", "critic/log.txt", "segment/_loss.png",
                "pred_idx1_hist.png", "metrics.jsonl"):
        assert (run / art).exists(), art
    assert list(run.glob("*>0.7__*<0.3.txt"))
    assert handler.contrastive.n_pos >= 100
    assert len(handler.last_ious) == 1 and 0 <= handler.last_ious[0] <= 1
    assert handler.loss_log["masker"].shape[1] == 4

    jcfg = jax_parse_args(["-train"] + TRAIN_ARGS)
    bundle = JBundle.from_arrays(*jax_collect_data(jcfg), jcfg)  # our cache
    bundle.to_device(jcfg)
    idx = next(JLoader(bundle.n_train, jcfg.batch_size,
                       np.random.default_rng(jcfg.seed)).chunks(100))
    tx = jax_make_optimizer()
    _, jl = make_critic_chunk(jcfg, jc, tx)(
        init_train_state({"critic": jp["critic"]}, tx), bundle.x_train_dev,
        bundle.y_train_dev, jnp.asarray(idx), jax.random.PRNGKey(0))
    ours = handler.loss_log["critic"][:len(idx)]
    np.testing.assert_allclose(ours[0], float(jl[0]), rtol=1e-5)
    np.testing.assert_allclose(ours, np.asarray(jl), rtol=3e-3)


@pytest.mark.parametrize("argv", [["-orbax"], ["--profile", "trace"],
                                  ["-vismasker"], ["-eval", "-crf"],
                                  ["--ensemble", "2"]])
def test_unported_modes_raise(argv, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        cli.main(argv + ["--device", "cpu", "-synthetic_data"])


BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "cgs_tpu")


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_cgs_tpu():
    """Static: this process has JAX imported already."""
    files = sorted((REPO / "cgs_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 20
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in BANNED, \
                f"{path.relative_to(REPO)} imports {mod}"
