"""PyTorch port: `MaskPipeline` against the JAX `MaskPipeline`.

chfak 1, 37 seeded frames at batch 16, so the last batch is padded.
Tolerances: preds and f32 masks 1e-5; saliency rtol 1e-4 / atol 1e-6
(a gradient through the same sums, reordered); bf16 masks 2e-2 (both
round to bf16 at every layer, at different places). The u8 wire and
the hard plane mirror tests/test_wire_reduction.py across packages: a
u8 value may differ by 1 from JAX, a hard pixel only where the JAX f32
mask lies within 1e-5 of the threshold. Within the port they are exact.
"""

import numpy as np
import pytest
import torch

from cgs_tpu.pipeline import MaskPipeline as JPipeline
from cgs_tpu_torch.pipeline import MaskPipeline
from torch_port_common import jax_models, port_models, port_params

THRESH = 0.5


@pytest.fixture(scope="module")
def frames():
    return np.random.default_rng(0).integers(0, 256, (37, 64, 64, 3),
                                             dtype=np.uint8)


@pytest.fixture(scope="module")
def both():
    jc, jm, jp = jax_models()
    return (jc, jm, jp), (*port_models(), port_params(jp))


def _pipes(both, **kw):
    (jc, jm, jp), (pc, pm, pp) = both
    return (JPipeline(jc, jm, jp, batch_size=16, **kw),
            MaskPipeline(pc, pm, pp, batch_size=16, device="cpu", **kw))


def test_f32_preds_and_masks(both, frames):
    jpipe, pipe = _pipes(both)
    a, b = jpipe.run(frames), pipe.run(frames)
    assert b.preds.shape == (37,) and b.masks.shape == (37, 64, 64, 1)
    np.testing.assert_allclose(b.preds, a.preds, atol=1e-5)
    np.testing.assert_allclose(b.masks, a.masks, atol=1e-5)
    assert b.saliency is None and b.masks_u8 is None and b.hard is None


def test_saliency(both, frames):
    jpipe, pipe = _pipes(both, salience=True)
    a, b = jpipe.run(frames), pipe.run(frames)
    assert b.saliency.shape == (37, 64, 64, 1)
    np.testing.assert_allclose(b.saliency, a.saliency, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(b.masks, a.masks, atol=1e-5)


def test_separate_critic_feeds_the_masker(both, frames):
    jpipe, pipe = _pipes(both, separate=True)
    a, b = jpipe.run(frames), pipe.run(frames)
    np.testing.assert_allclose(b.preds, a.preds, atol=1e-5)
    np.testing.assert_allclose(b.masks, a.masks, atol=1e-5)
    plain = _pipes(both)[1].run(frames)
    assert np.abs(plain.masks - b.masks).max() > 1e-3  # sepcrit differs


def test_u8_wire_and_hard_plane(both, frames):
    jf32, pf32 = _pipes(both)
    ju8, pu8 = _pipes(both, wire="u8", hard_threshold=THRESH)
    a, b = jf32.run(frames), pu8.run(frames)
    assert b.masks is None and b.masks_u8.dtype == np.uint8
    # within the port: exactly what the PNG writer computes from f32
    own = pf32.run(frames).masks
    np.testing.assert_array_equal(
        b.masks_u8, (255 * np.clip(own, 0, 1)).astype(np.uint8))
    np.testing.assert_array_equal(b.hard, (own >= THRESH).astype(np.uint8))
    # across packages: +-1 on u8; hard only where JAX is at the edge
    j = ju8.run(frames)
    diff = np.abs(b.masks_u8.astype(int) - j.masks_u8.astype(int))
    assert diff.max() <= 1
    flips = b.hard != j.hard
    assert np.all(np.abs(a.masks[flips] - THRESH) < 1e-5)
    np.testing.assert_array_equal(j.hard, (a.masks >= THRESH).astype(
        np.uint8))


def test_f32_wire_with_device_hard(both, frames):
    pf32 = _pipes(both)[1]
    pdev = _pipes(both, hard_threshold=THRESH)[1]
    a, b = pf32.run(frames), pdev.run(frames)
    np.testing.assert_array_equal(a.masks, b.masks)
    np.testing.assert_array_equal(b.hard, (a.masks >= THRESH).astype(
        np.uint8))


def test_bf16_masks():
    jc, jm, jp = jax_models(bf16=True)
    pc, pm = port_models(bf16=True)
    x = np.random.default_rng(1).integers(0, 256, (8, 64, 64, 3),
                                          dtype=np.uint8)
    a = JPipeline(jc, jm, jp, batch_size=8).run(x)
    b = MaskPipeline(pc, pm, port_params(jp), batch_size=8,
                     device="cpu").run(x)
    assert b.masks.dtype == np.float32
    np.testing.assert_allclose(b.masks, a.masks, atol=2e-2)
    np.testing.assert_allclose(b.preds, a.preds, atol=2e-2)


def test_noevalmode_is_seeded_and_live(frames):
    _, _, jp = jax_models()
    pc, pm = port_models(dropout=0.3)

    def run(seed, eval_mode):
        return MaskPipeline(pc, pm, port_params(jp), batch_size=16,
                            device="cpu", eval_mode=eval_mode,
                            seed=seed).run(frames[:16])

    live0, live0b, live1 = run(0, False), run(0, False), run(1, False)
    det = run(0, True)
    np.testing.assert_array_equal(live0.masks, live0b.masks)
    assert not np.array_equal(live0.masks, live1.masks)
    assert not np.array_equal(live0.preds, det.preds)


def test_run_bounds_in_flight_chunks(both):
    """run() holds at most max_in_flight chunks of outputs undelivered;
    a chunk is live from dispatch until its first readback."""
    (_, _, _), (pc, pm, pp) = both
    pipe = MaskPipeline(pc, pm, pp, batch_size=4, max_in_flight=2,
                        device="cpu")
    state = {"live": 0, "max": 0, "dispatches": 0}

    class _Lazy:
        def __init__(self, t):
            self.t = t

        def cpu(self):
            state["live"] -= 1
            return self.t

    def fake_run_device(u8):
        state["live"] += 1
        state["dispatches"] += 1
        state["max"] = max(state["max"], state["live"])
        n = int(u8.shape[0])
        return (_Lazy(torch.zeros(n)), torch.zeros(n, 64, 64, 1), None)

    pipe.run_device = fake_run_device
    out = pipe.run(np.zeros((40, 64, 64, 3), np.uint8))   # 10 chunks
    assert state["dispatches"] == 10 and state["live"] == 0
    assert state["max"] <= 2
    assert out.preds.shape == (40,)


def test_empty_input_and_unported_modes(both):
    (_, _, _), (pc, pm, pp) = both
    pipe = MaskPipeline(pc, pm, pp, batch_size=8, wire="u8",
                        hard_threshold=0.5, device="cpu")
    out = pipe.run(np.zeros((0, 64, 64, 3), np.uint8))
    assert out.masks is None
    assert out.masks_u8.shape == out.hard.shape == (0, 64, 64, 1)
    for kw in ({"mesh": object()}, {"ensemble": True},
               {"quantize": "int8"}):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            MaskPipeline(pc, pm, pp, device="cpu", **kw)
    with pytest.raises(ValueError, match="wire"):
        MaskPipeline(pc, pm, pp, device="cpu", wire="f16")


def test_run_device_keeps_outputs_on_the_device(both, frames):
    (_, _, _), (pc, pm, pp) = both
    pipe = MaskPipeline(pc, pm, pp, device="cpu", wire="u8",
                        hard_threshold=THRESH)
    pred, mask, sal, hard = pipe.run_device(torch.from_numpy(frames[:5]))
    assert pred.shape == (5,) and mask.shape == hard.shape == (5, 64, 64, 1)
    assert mask.dtype == hard.dtype == torch.uint8 and sal is None
