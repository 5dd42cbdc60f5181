"""PyTorch port: `MaskPipeline.run`'s staging ring on the CPU, where it
runs the same slot bookkeeping as on the card with unpinned buffers and
no side streams.

`run` must equal the per-batch `run_device` outputs, padded batches
concatenated and cut to N, bit for bit; its outputs are the call's own
arrays, never the ring's buffers; the ring is made once for calls of
the same or a smaller batch; a forward that raises leaves the pipeline
usable. chfak 1, batch 4, three slots: 25 frames make 7 batches, more
than twice the slots.
"""

import numpy as np
import pytest
import torch

from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.models.interop import init_torch_default
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.utils import profiling
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

BATCH = 4
CONFIGS = {
    "f32": {},
    "u8_hard": {"wire": "u8", "hard_threshold": 0.5},
    "f32_hard": {"hard_threshold": 0.5},
    "saliency": {"salience": True},
    "ensemble_u8_hard": {"ensemble": True, "wire": "u8",
                         "hard_threshold": 0.5},
}


def _frames(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                dtype=np.uint8)


def _pipeline(batch=BATCH, ensemble=False, **kw):
    critic, masker = Critic(chfak=1, dropout=0.0), UnetDecoder(chfak=1)
    gen = torch.Generator().manual_seed(5)
    members = [{name: {k: v.clone() for k, v in
                       init_torch_default(mod, gen).state_dict().items()}
                for name, mod in (("critic", critic), ("masker", masker))}
               for _ in range(2 if ensemble else 1)]
    return MaskPipeline(critic, masker,
                        members if ensemble else members[0],
                        batch_size=batch, device="cpu", ensemble=ensemble,
                        **kw)


def _outputs(out):
    return [out.preds, out.masks, out.saliency, out.masks_u8, out.hard]


def _per_batch(pipe, frames):
    """The oracle: `run_device` on each zero-padded batch, the outputs
    concatenated and cut to N, in `_outputs`' order."""
    n = frames.shape[0]
    bs = min(pipe.batch, n)
    got = []
    for lo in range(0, n, bs):
        chunk = frames[lo:lo + bs]
        pad = np.zeros((bs - chunk.shape[0],) + chunk.shape[1:], np.uint8)
        got.append(pipe.run_device(torch.from_numpy(
            np.concatenate([chunk, pad]))))
    cat = [None if got[0][k] is None else
           torch.cat([g[k] for g in got])[:n].numpy()
           for k in range(len(got[0]))]
    hard = cat[3] if len(cat) > 3 else None
    if pipe.wire == "u8":
        return [cat[0], None, cat[2], cat[1], hard]
    return [cat[0], cat[1], cat[2], None, hard]


@pytest.fixture(scope="module")
def pipes():
    return {}


@pytest.mark.parametrize("config", list(CONFIGS))
@pytest.mark.parametrize("n", [1, BATCH - 1, BATCH, 2 * BATCH + 3,
                               6 * BATCH + 1])
def test_run_equals_per_batch_run_device(config, n, pipes,
                                         one_torch_thread):
    if config not in pipes:
        pipes[config] = _pipeline(**CONFIGS[config])
    pipe = pipes[config]
    frames = _frames(n, seed=n)
    got, want = _outputs(pipe.run(frames)), _per_batch(pipe, frames)
    for name, a, b in zip(("preds", "masks", "saliency", "masks_u8",
                           "hard"), got, want):
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape[0] == n and a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_outputs_never_alias_the_ring(one_torch_thread):
    pipe = _pipeline(wire="u8", hard_threshold=0.5, salience=True)
    x = _frames(2 * BATCH + 3)
    first = _outputs(pipe.run(x))
    kept = [None if a is None else a.copy() for a in first]
    pipe.run(_frames(2 * BATCH + 3, seed=9))   # refills every slot
    x[:] = 0                                   # the caller's input
    for a, k in zip(first, kept):
        if a is not None:
            np.testing.assert_array_equal(a, k)
            for slot in pipe._ring.slots:
                for buf in [slot.frames, slot.frames_dev] + [
                        o for o in slot.outs if o is not None]:
                    assert not np.shares_memory(a, buf.numpy())


def test_ring_is_made_once_for_equal_or_smaller_batches(one_torch_thread):
    def buffers(ring):
        return [t.data_ptr() for s in ring.slots
                for t in [s.frames] + [o for o in s.outs if o is not None]]

    pipe = _pipeline(wire="u8", hard_threshold=0.5)
    pipe.run(_frames(6 * BATCH + 1))
    ring, ptrs = pipe._ring, buffers(pipe._ring)
    assert len(ring.slots) == pipe.max_in_flight and ring.rows == BATCH
    for n in (6 * BATCH + 1, BATCH, BATCH - 2, 1):
        pipe.run(_frames(n))
        assert pipe._ring is ring and buffers(ring) == ptrs, n
    # it grows only: a larger batch makes a new ring, a smaller one keeps it
    pipe = _pipeline(batch=2 * BATCH, wire="u8", hard_threshold=0.5)
    pipe.run(_frames(BATCH))
    assert pipe._ring.rows == BATCH
    pipe.run(_frames(3 * BATCH))
    grown = pipe._ring
    assert grown.rows == 2 * BATCH
    pipe.run(_frames(BATCH + 1))
    assert pipe._ring is grown


def test_no_batch_is_staged_off_the_card(one_torch_thread):
    pipe = _pipeline(wire="u8", hard_threshold=0.5)
    before = profiling.counts["pipeline.staged_batches"]
    pipe.run(_frames(6 * BATCH + 1))
    assert profiling.counts["pipeline.staged_batches"] == before == 0
    assert pipe._ring.upload is None and pipe._ring.read_back is None
    assert not pipe._ring.slots[0].frames.is_pinned()


def test_a_forward_that_raises_leaves_the_pipeline_usable(
        one_torch_thread):
    pipe = _pipeline(wire="u8", hard_threshold=0.5)
    x = _frames(6 * BATCH + 1)
    want = _outputs(pipe.run(x))
    calls = {"n": 0}
    forward = pipe.run_device

    def failing(u8):
        calls["n"] += 1
        if calls["n"] == 5:
            raise RuntimeError("forward failed")
        return forward(u8)

    pipe.run_device = failing
    with pytest.raises(RuntimeError, match="forward failed"):
        pipe.run(x)
    del pipe.run_device
    for a, b in zip(_outputs(pipe.run(x)), want):
        if a is not None:
            np.testing.assert_array_equal(a, b)
