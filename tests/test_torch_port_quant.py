"""PyTorch port: int8 inference (`cgs_tpu_torch/ops/quant.py`,
`MaskPipeline(quantize="int8", calib=...)`) against the JAX package's
(`cgs_tpu/ops/quant.py`, `cgs_tpu/pipeline.py`) on the same weights.

On the CPU at chfak 1: `quantize_tree` gives the same int8 weights and
scales within 1 ulp; the s32 convolution (the plain float64 version and
the card's im2col + `torch._int_mm` version, both run here) equals
`lax.conv_general_dilated`'s int32 one exactly; the int8 forwards give
JAX's preds and masks within 1e-5, with dynamic and with calibrated
scales; the f32 mode is the port's `Critic` / `UnetDecoder` bit for
bit; the int8 error against f32 stays in JAX's own bounds
(tests/test_quant.py); and the pipeline's guards, the 1e-12 clamp of a
baked scale (where JAX divides by 0), the ensemble + calib warning and
ensemble int8.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from cgs_tpu.ops import quant as jq
from cgs_tpu.pipeline import MaskPipeline as JPipeline
from cgs_tpu_torch.models.interop import CRITIC_KEYMAP, DECODER_KEYMAP
from cgs_tpu_torch.ops import quant as pq
from cgs_tpu_torch.parallel.mesh import Mesh
from cgs_tpu_torch.pipeline import MaskPipeline
from torch_port_common import (  # noqa: F401 (one_torch_thread: fixture)
    jax_models, nchw, one_torch_thread, port_models, port_params,
)

TOL = 1e-5
KEYMAPS = {"critic": CRITIC_KEYMAP, "masker": DECODER_KEYMAP}


@pytest.fixture(scope="module")
def setup():
    """(JAX critic, JAX masker, JAX params, port params, frames u8 and
    f32 NHWC)."""
    jc, jm, jp = jax_models()
    jp = {k: jp[k] for k in ("critic", "masker")}
    frames = np.random.default_rng(11).integers(0, 256, (8, 64, 64, 3),
                                                dtype=np.uint8)
    xf = frames.astype(np.float32) * np.float32(1 / 255)
    return jc, jm, jp, port_params(jp), frames, xf


def _forward_q(qp, xf, **kw):
    with torch.no_grad():
        pred, em = pq.critic_apply_q(qp["critic"], nchw(xf), **kw)
        mask = pq.masker_apply_q(qp["masker"], nchw(xf), em, **kw)
    return pred.numpy(), mask.permute(0, 2, 3, 1).numpy(), em


def _jax_forward_q(qp, xf, **kw):
    pred, em = jq.critic_apply_q(qp["critic"], jnp.asarray(xf), **kw)
    mask = jq.masker_apply_q(qp["masker"], jnp.asarray(xf), em, **kw)
    return np.asarray(pred), np.asarray(mask)


def test_quantize_tree_matches_jax(setup):
    _, _, jp, pp, _, _ = setup
    jqt, pqt = jq.quantize_tree(jp), pq.quantize_tree(pp)
    n_conv = 0
    for sub, keymap in KEYMAPS.items():
        for flax, layer in keymap.items():
            leaf, q = jqt[sub][flax], pqt[sub]
            np.testing.assert_array_equal(q[f"{layer}.bias"].numpy(),
                                          np.asarray(leaf["bias"]))
            if "kernel_scale" not in leaf:          # dense: f32 as it was
                assert q[f"{layer}.weight"].dtype == torch.float32
                assert f"{layer}.weight_scale" not in q
                continue
            n_conv += 1
            w = q[f"{layer}.weight"]
            assert w.dtype == torch.int8
            np.testing.assert_array_equal(w.numpy().transpose(2, 3, 1, 0),
                                          np.asarray(leaf["kernel"]))
            np.testing.assert_array_max_ulp(
                q[f"{layer}.weight_scale"].numpy(),
                np.asarray(leaf["kernel_scale"]), maxulp=1)
    assert n_conv == 12
    kq = pqt["masker"]["masker.0.weight"]
    assert int(kq.max()) == 127 or int(kq.min()) == -127


@pytest.mark.parametrize("cin,hw,cout,k,padding", [
    (3, 16, 8, 3, "SAME"),       # conv0
    (19, 16, 16, 3, "SAME"),     # mask0 (K = 171, N = 16)
    (16, 4, 32, 4, "VALID"),     # conv_neck
    (32, 1, 32, 1, "VALID"),     # dec4
    (16, 8, 1, 3, "SAME"),       # mask1 (N = 1)
])
def test_conv_s32_matches_lax_int32(cin, hw, cout, k, padding):
    rng = np.random.default_rng(cin * 100 + hw)
    xq = rng.integers(-127, 128, (5, hw, hw, cin), dtype=np.int8)
    wq = rng.integers(-127, 128, (k, k, cin, cout), dtype=np.int8)
    want = np.asarray(lax.conv_general_dilated(
        jnp.asarray(xq), jnp.asarray(wq), (1, 1), padding,
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        preferred_element_type=jnp.int32))
    x = nchw(xq)
    w = torch.from_numpy(np.ascontiguousarray(wq.transpose(3, 2, 0, 1)))
    pad = 1 if padding == "SAME" else 0
    for conv in (pq.conv_s32_plain, pq.conv_s32_mm, pq.conv_s32):
        got = conv(x, w, pad)
        assert got.dtype == torch.int32
        assert got.is_contiguous(memory_format=torch.channels_last)
        np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(),
                                      want, err_msg=conv.__name__)


def test_conv_s32_mm_chunks_and_small_batches(monkeypatch):
    """A few frames per chunk (the card's GEMM row cap cut small) and a
    chunk of fewer than 17 rows still give the exact sums."""
    rng = np.random.default_rng(2)
    x = nchw(rng.integers(-127, 128, (7, 4, 4, 10), dtype=np.int8))
    w = torch.from_numpy(rng.integers(-127, 128, (9, 10, 3, 3),
                                      dtype=np.int8))
    monkeypatch.setattr(pq, "MAX_ROWS", 3 * 16)
    assert torch.equal(pq.conv_s32_mm(x, w, 1), pq.conv_s32_plain(x, w, 1))
    one = x[:1].contiguous(memory_format=torch.channels_last)
    assert torch.equal(pq.conv_s32_mm(one, w, 0),
                       pq.conv_s32_plain(one, w, 0))


def test_int8_forward_matches_jax_dynamic(setup, one_torch_thread):
    _, _, jp, pp, _, xf = setup
    jpred, jmask = _jax_forward_q(jq.quantize_tree(jp), xf)
    pred, mask, _ = _forward_q(pq.quantize_tree(pp), xf)
    np.testing.assert_allclose(pred, jpred, atol=TOL)
    np.testing.assert_allclose(mask, jmask, atol=TOL)


def test_int8_forward_matches_jax_static(setup, one_torch_thread):
    """Calibrated scales: the same per-layer scales (1 ulp of the f32
    maxima), then the same preds and masks."""
    _, _, jp, pp, frames, xf = setup
    calib = np.random.default_rng(12).integers(0, 256, (16, 64, 64, 3),
                                               dtype=np.uint8)
    js = jq.calibrate_act_scales(jp, calib)
    cf = calib.astype(np.float32) * np.float32(1 / 255)
    ps = pq.calibrate_act_scales(pp, nchw(cf))
    for sub, keymap in KEYMAPS.items():
        for flax, layer in keymap.items():
            if flax in js[sub]:
                np.testing.assert_allclose(ps[sub][layer], js[sub][flax],
                                           rtol=2e-7)
    jqt = jq.merge_act_scales(jq.quantize_tree(jp), js)
    pqt = pq.merge_act_scales(pq.quantize_tree(pp), ps)
    assert float(pqt["masker"]["masker.0.act_scale"]) > 0
    jpred, jmask = _jax_forward_q(jqt, xf)
    pred, mask, _ = _forward_q(pqt, xf)
    np.testing.assert_allclose(pred, jpred, atol=TOL)
    np.testing.assert_allclose(mask, jmask, atol=TOL)


def test_f32_mode_is_the_port_models(setup, one_torch_thread):
    """The skeleton on raw weights equals `Critic` / `UnetDecoder`
    bit for bit; so does the int8 path with nothing quantized."""
    _, _, _, pp, _, xf = setup
    critic, masker = port_models()
    critic.load_state_dict(pp["critic"])
    masker.load_state_dict(pp["masker"])
    critic.eval()
    x = nchw(xf).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want_pred, want_em = critic(x, collect=True)
        want_mask = masker(x, want_em).permute(0, 2, 3, 1).numpy()
    for qp, mode in ((pp, "f32"), (pq.quantize_tree(pp, only=set()),
                                   "int8")):
        pred, mask, em = _forward_q(qp, xf, mode=mode)
        np.testing.assert_array_equal(pred, want_pred.numpy())
        for a, b in zip(em, want_em):
            assert torch.equal(a, b)
        np.testing.assert_array_equal(mask, want_mask)
    only = pq.quantize_tree(pp, only={"masker.0", "masker.2"})
    assert only["masker"]["masker.0.weight"].dtype == torch.int8
    assert only["masker"]["dec_model.0.weight"].dtype == torch.float32
    assert "dec_model.0.weight_scale" not in only["masker"]


def test_int8_close_to_f32(setup, one_torch_thread):
    """JAX's own accuracy bounds (tests/test_quant.py:84-89)."""
    _, _, _, pp, _, xf = setup
    pred32, mask32, _ = _forward_q(pp, xf, mode="f32")
    pred, mask, _ = _forward_q(pq.quantize_tree(pp), xf)
    assert np.abs(pred - pred32).max() < 1e-2
    assert np.abs(mask - mask32).max() < 3e-2
    assert np.mean((mask >= 0.5) == (mask32 >= 0.5)) > 0.995


def test_pipeline_int8_matches_jax_pipeline(setup, one_torch_thread):
    """MaskPipeline(quantize='int8') with dynamic and static scales, the
    u8 wire and hard plane composed, against the JAX pipeline's."""
    jc, jm, jp, pp, _, _ = setup
    critic, masker = port_models()
    rng = np.random.default_rng(13)
    frames = rng.integers(0, 256, (11, 64, 64, 3), dtype=np.uint8)
    calib = rng.integers(0, 256, (16, 64, 64, 3), dtype=np.uint8)
    for kw in ({}, {"calib": calib}):
        want = JPipeline(jc, jm, jp, batch_size=8, quantize="int8",
                         **kw).run(frames)
        pipe = MaskPipeline(critic, masker, pp, batch_size=8,
                            quantize="int8", device="cpu", **kw)
        got = pipe.run(frames)
        np.testing.assert_allclose(got.preds, want.preds, atol=TOL)
        np.testing.assert_allclose(got.masks, want.masks, atol=TOL)
        assert pipe.params is pp
        if kw:
            assert "masker.0.act_scale" in pipe._members[0]["masker"]
    red = MaskPipeline(critic, masker, pp, batch_size=8, quantize="int8",
                       wire="u8", hard_threshold=0.5, device="cpu")
    soft = MaskPipeline(critic, masker, pp, batch_size=8, quantize="int8",
                        device="cpu").run(frames)
    out = red.run(frames)
    np.testing.assert_array_equal(
        np.floor(np.clip(soft.masks, 0, 1) * 255).astype(np.uint8),
        out.masks_u8)
    np.testing.assert_array_equal((soft.masks >= 0.5).astype(np.uint8),
                                  out.hard)


def test_pipeline_int8_guards(setup):
    _, _, _, pp, _, _ = setup
    critic, masker = port_models()
    with pytest.raises(ValueError, match="saliency"):
        MaskPipeline(critic, masker, pp, salience=True, quantize="int8",
                     device="cpu")
    with pytest.raises(ValueError, match="eval_mode"):
        MaskPipeline(critic, masker, pp, eval_mode=False, quantize="int8",
                     device="cpu")
    with pytest.raises(ValueError, match="quantize"):
        MaskPipeline(critic, masker, pp, quantize="fp8", device="cpu")
    # a mesh is ported; int8 members that do not divide over the ranks
    # are refused like f32 ones
    with pytest.raises(ValueError, match="R % ranks"):
        MaskPipeline(critic, masker, [pp] * 3, ensemble=True,
                     quantize="int8", device="cpu",
                     mesh=Mesh(rank=0, world=2, device=torch.device("cpu")))


def test_zero_calibrated_scale_is_clamped(setup, one_torch_thread):
    """A conv input that is all zero in the calibration batch bakes a 0
    scale: JAX's int8 forward then divides by 0 (0/0 is NaN before the
    int8 cast, whose result the platform defines); the port clamps the
    baked scale at 1e-12, so every quantized input is a number and the
    masks are finite (ADVICE r5 #1)."""
    _, _, jp, pp, _, xf = setup
    black = np.zeros((4, 64, 64, 3), np.uint8)
    js = jq.calibrate_act_scales(jp, black)
    ps = pq.calibrate_act_scales(pp, nchw(black.astype(np.float32)))
    assert js["critic"]["conv0"] == 0.0 and ps["critic"]["features.0"] == 0.0
    jqt = jq.merge_act_scales(jq.quantize_tree(jp), js)
    assert float(jqt["critic"]["conv0"]["act_scale"]) == 0.0
    pqt = pq.merge_act_scales(pq.quantize_tree(pp), ps)
    assert float(pqt["critic"]["features.0.act_scale"]) == pytest.approx(
        1e-12)
    x = nchw(xf).clone()
    x[0, 0, 0, 0] = 0.0
    xq, _ = pq.act_quant(x, pqt["critic"]["features.0.act_scale"])
    assert torch.equal(xq, torch.where(x > 0, 127, 0).to(torch.int8))
    pred, mask, _ = _forward_q(pqt, xf)
    assert np.isfinite(pred).all() and np.isfinite(mask).all()


def test_pipeline_int8_ensemble(setup, one_torch_thread):
    """Each member quantized on its own: the int8 ensemble equals the
    mean of JAX's int8 forwards of the members within 1e-5, and JAX's
    jitted int8 ensemble and the port's f32 one within JAX's int8
    bounds. (XLA's compiled int8 forward quantizes a few activations one
    step off its op-by-op forward: 6.6e-4 in the masks of the second
    member here, so the compiled pipeline is not held to 1e-5.) calib
    with ensemble warns and leaves the scales dynamic."""
    jc, jm, jp, pp, frames, xf = setup
    critic, masker = port_models()
    jtrees = [jp, jax.tree.map(lambda a: a * np.float32(1.02), jp)]
    members = [port_params(t) for t in jtrees]
    eager = [_jax_forward_q(jq.quantize_tree(t), xf) for t in jtrees]
    stacked = jax.tree.map(lambda *a: np.stack(a), *jtrees)
    jit = JPipeline(jc, jm, stacked, batch_size=8, ensemble=True,
                    quantize="int8").run(frames)
    f32 = MaskPipeline(critic, masker, members, batch_size=8, ensemble=True,
                       device="cpu").run(frames)
    with pytest.warns(UserWarning, match="calib is ignored"):
        pipe = MaskPipeline(critic, masker, members, batch_size=8,
                            ensemble=True, quantize="int8", device="cpu",
                            calib=frames)
    got = pipe.run(frames)
    assert all("masker.0.act_scale" not in m["masker"]
               for m in pipe._members)
    np.testing.assert_allclose(got.masks, (eager[0][1] + eager[1][1]) / 2,
                               atol=TOL)
    np.testing.assert_allclose(got.preds,
                               (eager[0][0] + eager[1][0])[:, 0] / 2,
                               atol=TOL)
    for want in (jit, f32):
        assert np.abs(got.masks - want.masks).max() < 3e-2
        assert np.mean((got.masks >= 0.5) == (want.masks >= 0.5)) > 0.995
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        MaskPipeline(critic, masker, members, batch_size=8, ensemble=True,
                     quantize="int8", device="cpu")
