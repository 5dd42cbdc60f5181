"""PyTorch port: the dense CRF (`cgs_tpu_torch/eval/crf.py`) against the
JAX package's (`cgs_tpu/eval/crf.py`), and its wiring into `-eval` and
`-process`.

Both bind the same C++ solver (`native/densecrf`): the port builds it
into `build/native/` with g++, the JAX package with its Makefile, with
the same flags, so on the same frames and masks the refined masks are
equal exactly. Across packages the f32 masks differ by <= 1e-5, so the
CRF IoU of `evaluate` may differ by 1e-3; the mask IoU is equal.
"""

import os

import numpy as np
import pytest
from PIL import Image

from cgs_tpu.core.config import parse_args as jax_parse_args
from cgs_tpu.eval import crf as jax_crf
from cgs_tpu.eval.harness import evaluate as jax_evaluate
from cgs_tpu.eval.segment import segment_folder as jax_segment_folder
from cgs_tpu.pipeline import MaskPipeline as JPipeline
from cgs_tpu_torch.core.config import parse_args
from cgs_tpu_torch.data.synthetic import synthetic_eval_set
from cgs_tpu_torch.eval import crf
from cgs_tpu_torch.eval.harness import evaluate
from cgs_tpu_torch.eval.segment import _mask_variants, segment_folder
from cgs_tpu_torch.handler import Handler
from cgs_tpu_torch.pipeline import MaskPipeline
from torch_port_common import (  # noqa: F401 (one_torch_thread: fixture)
    jax_models, one_torch_thread, port_models, port_params,
)

N = 24


@pytest.fixture(scope="module")
def eval_frames():
    """Synthetic eval frames (float in [0,1]) and their ground truth."""
    x, gt = synthetic_eval_set(n_frames=64, seed=99)
    return (x / 255.0).astype(np.float32), gt


@pytest.fixture(scope="module")
def frames_masks(eval_frames):
    """Eval frames (u8), masks with soft blobs, ground truth."""
    x, gt = eval_frames
    x_u8 = (x[:N] * 255).astype(np.uint8)
    rng = np.random.default_rng(0)
    yy, xx = np.mgrid[:64, :64]
    cy, cx = rng.uniform(10, 54, (2, N, 1, 1))
    masks = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / 120.0)
    masks = np.clip(masks + rng.uniform(0, 0.3, masks.shape), 0, 1)
    return x_u8, masks.astype(np.float32), gt[:N]


@pytest.mark.parametrize("kw", [{}, {"skip": 2}, {"rescale": True},
                                {"params": {"iters": 3, "w1": 10.0}}])
def test_densecrf_equals_jax(frames_masks, kw):
    x_u8, masks, _ = frames_masks
    ours = crf.DenseCRF(**kw)(x_u8, masks)
    theirs = jax_crf.DenseCRF(**kw)(x_u8, masks)
    assert ours.dtype == bool and ours.shape == (N, 64, 64)
    np.testing.assert_array_equal(ours, theirs)
    # a (N, H, W, 1) mask is the same call
    np.testing.assert_array_equal(
        crf.DenseCRF(**kw)(x_u8, masks[..., None]), ours)
    # the refinement moved something: the output is not the threshold
    if "skip" not in kw:
        assert not np.array_equal(ours, masks >= 1)


def test_densecrf_empty_and_all_background(frames_masks):
    x_u8, masks, _ = frames_masks
    empty = crf.DenseCRF()(x_u8[:0], masks[:0])
    assert empty.shape == (0, 64, 64) and empty.dtype == bool
    zeros = np.zeros_like(masks[:8])
    ours = crf.DenseCRF()(x_u8[:8], zeros)
    np.testing.assert_array_equal(ours, jax_crf.DenseCRF()(x_u8[:8], zeros))
    assert not ours.any()


def test_grid_search_equals_jax(frames_masks):
    x_u8, masks, gt = frames_masks
    grid = dict(w1=(22.0, 5.0), gamma=(1.8, 3.0), iters=(2,), skip=3)
    ours, ours_best = crf.grid_search(x_u8, masks, gt, **grid)
    theirs, theirs_best = jax_crf.grid_search(x_u8, masks, gt, **grid)
    assert len(ours) == 4 and ours == theirs
    np.testing.assert_array_equal(ours_best, theirs_best)


def test_library_builds_into_build_and_not_native():
    path = crf.build_library()
    assert path == crf.ROOT / "build" / "native" / "libcgs_densecrf.so"
    assert path.exists()
    mtime = path.stat().st_mtime
    assert crf.build_library() == path and path.stat().st_mtime == mtime


@pytest.fixture(scope="module")
def both():
    jc, jm, jp = jax_models()
    return (jc, jm, jp), (*port_models(), port_params(jp))


def test_evaluate_under_crf_tracks_jax(both, eval_frames,
                                      one_torch_thread):
    """[mask, crf] against JAX on the same weights and frames; then
    [mask, crf, sal, sal_crf] within the port."""
    (jc, jm, jp), (pc, pm, pp) = both
    x, gt = eval_frames
    argv = ["-eval", "-crf", "-synthetic_data"]
    jcfg, cfg = jax_parse_args(argv), parse_args(argv + ["--device", "cpu"])
    jpipe = JPipeline(jc, jm, jp, batch_size=len(x))
    pipe = MaskPipeline(pc, pm, pp, batch_size=64, device="cpu")
    theirs = jax_evaluate(jcfg, jpipe, x, gt,
                          crf_fn=jax_crf.DenseCRF(), write=False)
    ours = evaluate(cfg, pipe, x, gt, crf_fn=crf.DenseCRF(), write=False)
    assert len(ours["ious"]) == 2
    assert ours["ious"][0] == theirs["ious"][0]
    np.testing.assert_allclose(ours["ious"], theirs["ious"], atol=1e-3)
    assert list(ours["variants"]) == list(theirs["variants"])
    # without a crf_fn (the library did not load) -crf adds nothing
    assert len(evaluate(cfg, pipe, x, gt, write=False)["ious"]) == 1

    cfg = parse_args(argv + ["-salience", "--device", "cpu"])
    pipe = MaskPipeline(pc, pm, pp, batch_size=64, salience=True,
                        device="cpu")
    ours = evaluate(cfg, pipe, x, gt, crf_fn=crf.DenseCRF(), write=False)
    v = ours["variants"]
    assert len(ours["ious"]) == 4
    assert list(v) == ["mask", "hard", "crf", "sal", "sal_hard", "sal_crf"]
    # the CRF variants refine this package's own soft masks
    x_u8 = (x * 255).astype(np.uint8)
    np.testing.assert_array_equal(v["crf"], crf.DenseCRF()(x_u8, v["mask"]))
    np.testing.assert_array_equal(v["sal_crf"],
                                  crf.DenseCRF()(x_u8, v["sal"]))


def test_process_under_crf_writes_jax_variants(both, eval_frames, tmp_path,
                                               one_torch_thread):
    (jc, jm, jp), (pc, pm, pp) = both
    src = tmp_path / "src"
    src.mkdir()
    x, _ = eval_frames
    for i in range(6):
        Image.fromarray((x[i] * 255).astype(np.uint8)).save(
            src / f"f{i}.png")
    argv = ["-process", "-crf", "-process_salience"]
    jcfg, cfg = jax_parse_args(argv), parse_args(argv + ["--device", "cpu"])
    jax_segment_folder(jcfg, JPipeline(jc, jm, jp, batch_size=8,
                                       salience=True), str(src),
                       crf_fn=jax_crf.DenseCRF(),
                       out_dir=str(tmp_path / "theirs"))
    pipe = MaskPipeline(pc, pm, pp, batch_size=8, salience=True,
                        device="cpu")
    out = segment_folder(cfg, pipe, str(src), crf_fn=crf.DenseCRF(),
                         out_dir=str(tmp_path / "ours"))
    assert len(out["variants"]) == 6
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "theirs"))
    assert len(names) == 36 and "f0-crf-mask.png" in names \
        and "f5-crf-saliency.png" in names
    # a u8-wire pipeline cannot feed the CRF
    u8 = MaskPipeline(pc, pm, pp, batch_size=8, wire="u8",
                      hard_threshold=0.5, device="cpu")
    with pytest.raises(ValueError, match="f32"):
        _mask_variants(cfg, u8, x[:4], crf.DenseCRF())


def test_handler_crf_fn_and_wire(monkeypatch, capsys, tmp_path):
    monkeypatch.chdir(tmp_path)
    handler = Handler(parse_args(["-process", "-crf", "--device", "cpu"]))
    assert isinstance(handler._crf_fn(), crf.DenseCRF)
    seen = {}

    def fake_segment_folder(cfg, pipe, folder, crf_fn=None, write=True):
        seen.update(wire=pipe.wire, hard=pipe.hard_threshold, crf=crf_fn)
        return {}

    import cgs_tpu_torch.handler as handler_mod
    monkeypatch.setattr(handler_mod, "segment_folder", fake_segment_folder)
    handler.segment(str(tmp_path))
    assert seen["wire"] == "f32" and seen["hard"] is None
    assert isinstance(seen["crf"], crf.DenseCRF)

    def broken():
        raise RuntimeError("densecrf build failed")

    monkeypatch.setattr(crf, "_libs", {})
    monkeypatch.setattr(crf, "build_library", broken)
    assert handler._crf_fn() is None
    assert "CRF unavailable (densecrf build failed)" in capsys.readouterr().out
    no_crf = Handler(parse_args(["-process", "--device", "cpu"]))
    assert no_crf._crf_fn() is None
