"""PyTorch port: the gather-shift-normalise ingest and the merges into
the critic's joined batch (`ops/kernels.py:gather_normalize_u8`,
`merge_pair`, `ops/merge.py:merge_both`, `train/steps.py`,
`train/loops.py`).

On the CPU the wrappers run their plain versions, held here against
the JAX package's expression of the same work: the ingest against
`jnp.take`, `jnp.roll(..., s, axis=2)` and `cgs_tpu/train/losses.py`
`ingest`, bit-equal (a gather, a roll and one f32 multiply); the merges
against `cgs_tpu/ops/merge.py:merge_both` (Pallas, interpret mode) and
its VJP, within 1e-6 / 1e-5 as `tests/test_torch_port_train.py` holds
them. A masker chunk through the joined batches is held against the
same chunk with separate a, b and `torch.cat`, exactly. The CUDA kernel
itself is held against the plain version on the card by
`tests/test_torch_port_cuda.py` and `chip_smoke.py`.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cgs_tpu.ops.merge import merge_both as jax_merge_both
from cgs_tpu.train.losses import ingest as jax_ingest
import cgs_tpu_torch.train.losses as losses_mod
import cgs_tpu_torch.train.steps as steps_mod
from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.ops import _build
from cgs_tpu_torch.ops.augment import shift_batch_by
from cgs_tpu_torch.ops.kernels import (
    MAX_SEGMENTS, Segment, blend, gather_normalize_u8,
    gather_normalize_u8_plain, merge_pair, merge_pair_bwd_plain,
    normalize_u8,
)
from cgs_tpu_torch.ops.merge import inject_merge, merge_both, replace_merge
from cgs_tpu_torch.train.loops import critic_chunk, masker_chunk
from cgs_tpu_torch.train.losses import build_masker_loss, ingest
from cgs_tpu_torch.train.steps import StepRng, make_optimizer
from torch_port_common import (  # noqa: F401 (one_torch_thread: fixture)
    nchw, nhwc, one_torch_thread, port_models,
)

SHIFTS = [0, 1, -1, 11, -11, 63, -63, 64, -70]
H, W, C = 3, 64, 3


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view({4: np.uint32, 2: np.uint16}[a.dtype.itemsize])


def _segments(nseg: int, shift: int, seed: int = 0):
    """Up to three (bank, idx, shift, labels) segments as numpy arrays:
    the masker step's layout (two shifted labelled segments, then an
    unshifted unlabelled one), with repeated, unsorted indices and a
    segment without an index (all of its bank, in order)."""
    rng = np.random.default_rng(seed)
    specs = [(9, np.array([5, 0, 5, 3, 8, 1, 1]), shift, True),
             (6, None, shift, True),
             (11, np.array([10, 2, 2, 7]), 0, False)][:nseg]
    return [(rng.integers(0, 256, (m, H, W, C), dtype=np.uint8), idx, s,
             rng.random(m, dtype=np.float32) if lab else None)
            for m, idx, s, lab in specs]


def _port(segs):
    return [Segment(torch.from_numpy(bank),
                    None if idx is None else torch.from_numpy(idx),
                    s, None if lab is None else torch.from_numpy(lab))
            for bank, idx, s, lab in segs]


def _jax(segs):
    """jnp.take, jnp.roll along W, concatenate, ingest; labels taken."""
    frames, labels = [], []
    for bank, idx, s, lab in segs:
        x = jnp.asarray(bank)
        if idx is not None:
            x = jnp.take(x, jnp.asarray(idx), axis=0)
        frames.append(jnp.roll(x, s, axis=2))
        if lab is not None:
            labels.append(lab if idx is None else lab[idx])
    out = np.asarray(jax_ingest(jnp.concatenate(frames, axis=0)))
    return out, (np.concatenate(labels) if labels else None)


# -- gather-shift-normalise ----------------------------------------------

@pytest.mark.parametrize("shift", SHIFTS)
@pytest.mark.parametrize("nseg", [1, 2, 3])
def test_gather_normalize_u8_bit_equal_to_jax(nseg, shift):
    segs = _segments(nseg, shift)
    want, want_y = _jax(segs)
    out, y = gather_normalize_u8(_port(segs))
    assert out.dtype == torch.float32 and out.shape == want.shape
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(want))
    np.testing.assert_array_equal(y.numpy(), want_y)


@pytest.mark.parametrize("empty", ["one segment", "all"])
def test_gather_normalize_u8_with_no_rows(empty):
    segs = _segments(3, 11)
    idx = np.zeros(0, np.int64)
    segs = [(b, idx if (empty == "all" or k == 1) else i, s, lab)
            for k, (b, i, s, lab) in enumerate(segs)]
    want, want_y = _jax(segs)
    out, y = gather_normalize_u8(_port(segs))
    assert out.shape == want.shape
    np.testing.assert_array_equal(_bits(out.numpy()), _bits(want))
    np.testing.assert_array_equal(y.numpy(), want_y)


def test_gather_normalize_u8_bf16_is_the_f32_result_rounded():
    """Every byte value: the bf16 ingest is JAX's f32 ingest rounded to
    bfloat16, so a bf16 model's own input cast does nothing to it."""
    bank = np.arange(256, dtype=np.uint8).reshape(2, 2, 64, 1)
    bank = np.repeat(bank, 3, axis=3)
    segs = [(bank, np.array([1, 0]), 5, None)]
    out, _ = gather_normalize_u8(_port(segs), torch.bfloat16)
    want = jnp.asarray(_jax(segs)[0]).astype(jnp.bfloat16)
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(out.view(torch.int16).numpy(),
                                  np.asarray(want).view(np.int16))
    f32, _ = gather_normalize_u8(_port(segs))
    assert torch.equal(out, f32.to(torch.bfloat16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalize_u8_is_the_one_segment_case(dtype):
    x = torch.from_numpy(_segments(1, 0)[0][0])
    out = normalize_u8(x, dtype)
    assert torch.equal(out, gather_normalize_u8([Segment(x)], dtype)[0])
    assert torch.equal(out, (x.float() * (1 / 255.0)).to(dtype))
    assert torch.equal(ingest(x), normalize_u8(x).permute(0, 3, 1, 2))


def _bad_segments(case):
    bank = torch.zeros(4, H, W, C, dtype=torch.uint8)
    lab = torch.zeros(4)
    return {
        "too many": [Segment(bank)] * (MAX_SEGMENTS + 1),
        "float bank": [Segment(bank.float())],
        "frame shapes differ": [Segment(bank), Segment(bank[:, :, :8])],
        "int32 index": [Segment(bank, torch.zeros(2, dtype=torch.int32))],
        "labels of another length": [Segment(bank, labels=lab[:3])],
        "labels after a segment without": [Segment(bank),
                                           Segment(bank, labels=lab)],
    }[case]


@pytest.mark.parametrize("case", ["too many", "float bank",
                                  "frame shapes differ", "int32 index",
                                  "labels of another length",
                                  "labels after a segment without"])
def test_gather_normalize_u8_rejects_what_the_kernel_does_not_take(case):
    with pytest.raises(ValueError):
        gather_normalize_u8(_bad_segments(case))


def test_gather_normalize_u8_rejects_other_dtypes():
    bank = torch.zeros(4, H, W, C, dtype=torch.uint8)
    with pytest.raises(ValueError, match="dtype"):
        gather_normalize_u8([Segment(bank)], torch.float16)
    _build.launches.clear()
    gather_normalize_u8_plain([Segment(bank)])
    normalize_u8(bank)
    assert sum(_build.launches.values()) == 0          # CPU: plain only


# -- the merges into the joined batch ------------------------------------

@pytest.mark.parametrize("grad_format", ["channels_last", "nchw"])
def test_merge_both_joined_batch_and_grads(grad_format):
    """a and b as the two halves of one joined batch (the ingest's),
    the merges into one joined batch: values equal the plain blends
    (exactly) and JAX's merge_both (Pallas, interpret); gradients
    equal merge_pair_bwd_plain on the joined gradient (exactly),
    autograd of the blends (1e-6) and JAX's VJP
    (1e-5)."""
    rng = np.random.default_rng(9)
    n = 3
    ab_np = rng.random((2 * n, 64, 64, 3), dtype=np.float32)
    z_np = rng.random((n, 64, 64, 1), dtype=np.float32)
    g_np = rng.random((2 * n, 64, 64, 3), dtype=np.float32)
    ab = nchw(ab_np)
    a, b = ab[:n], ab[n:]
    z = nchw(z_np).requires_grad_()
    merged = merge_both(a, b, z)
    assert merged.shape == (2 * n, 3, 64, 64)
    assert merged.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(merged, merge_pair(a, b, z.detach()))
    assert torch.equal(merged[:n], blend(a, b, z))
    assert torch.equal(merged[n:], blend(b, a, z))
    ja, jb, jz = (jnp.asarray(v) for v in (ab_np[:n], ab_np[n:], z_np))
    jrep, jinj = jax_merge_both(ja, jb, jz)
    np.testing.assert_allclose(nhwc(merged),
                               np.concatenate([jrep, jinj]), atol=1e-6)

    g = nchw(g_np)
    if grad_format == "nchw":
        g = g.contiguous()
    merged.backward(g)
    _, _, dz = merge_pair_bwd_plain(a, b, z.detach(), g)
    assert torch.equal(z.grad, dz)
    zz = z.detach().clone().requires_grad_()
    torch.cat([replace_merge(a, b, zz), inject_merge(a, b, zz)]).backward(g)
    torch.testing.assert_close(z.grad, zz.grad, atol=1e-6, rtol=0)
    _, vjp = jax.vjp(jax_merge_both, ja, jb, jz)
    jdz = vjp((jnp.asarray(g_np[:n]), jnp.asarray(g_np[n:])))[2]
    np.testing.assert_allclose(nhwc(z.grad), np.asarray(jdz), atol=1e-5)


# -- the train steps' frame path -----------------------------------------

def _banks(seed=1, m=12):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy(rng.integers(0, 256, (m, 64, 64, 3),
                                          dtype=np.uint8)),
            torch.from_numpy(rng.random(m, dtype=np.float32)))


def _reference_masker_chunk(cfg, models, opt, xpos, ypos, xneg, yneg, h, l,
                            c, shifts, rng):
    """The chunk as the port ran it before the joined batches: the
    frames gathered with index_select and joined with torch.cat, rolled,
    ingested one tensor at a time, the fused (A, B) pass over
    torch.cat([a, b]) and the fused merge pass over torch.cat([replaced,
    injected])."""
    rows = []
    for s in range(h.shape[0]):
        hs, ls, cs = (torch.from_numpy(np.asarray(i[s], np.int64))
                      for i in (h, l, c))
        a_u8 = shift_batch_by(torch.cat([xpos.index_select(0, hs),
                                         xneg.index_select(0, ls)]),
                              shifts[s])
        y = torch.cat([ypos.index_select(0, hs), yneg.index_select(0, ls)])
        b_u8 = xneg.index_select(0, cs)
        n = a_u8.shape[0]
        with mock.patch.object(
                losses_mod, "merge_both",
                lambda a, b, z: torch.cat(list(merge_both(a, b, z)
                                               .split(n)))):
            loss, aux = build_masker_loss(cfg)(models, ingest(a_u8), y,
                                               ingest(b_u8), rng.dropout)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        rows.append(torch.stack([aux[t].detach() for t in
                                 ("replace", "inject", "norm", "critic")]))
    return torch.stack(rows)


def test_masker_chunk_through_joined_batches_equals_the_cat_path(
        one_torch_thread):
    """Two masker steps (default flags, dropout 0, shifts 5 and -7):
    the chunk through one gather-ingest and the joined batches gives
    the same loss terms and parameters as the chunk with separate a, b
    and torch.cat, bit for bit."""
    cfg = Config(dropout=0.0, shift=12).derive()
    xpos, ypos = _banks(1)
    xneg, yneg = _banks(2)
    rng = np.random.default_rng(3)
    h, l = (rng.integers(0, 12, (2, 2)) for _ in range(2))
    c = rng.integers(0, 12, (2, 4))
    shifts = [5, -7]
    results = []
    for joined in (True, False):
        critic, masker = port_models()
        torch.manual_seed(0)
        for m in (critic, masker):
            for p in m.parameters():
                torch.nn.init.uniform_(p, -0.1, 0.1)
        models = {"critic": critic.to(memory_format=torch.channels_last),
                  "masker": masker.to(memory_format=torch.channels_last)}
        opt = make_optimizer(models)
        srng = StepRng.seeded(0, "cpu")
        if joined:
            draws = iter(shifts)
            with mock.patch.object(steps_mod, "draw_shift",
                                   lambda *_: next(draws)):
                terms = masker_chunk(cfg, models, opt, xpos, ypos, xneg,
                                     yneg, h, l, c, srng)
        else:
            terms = _reference_masker_chunk(cfg, models, opt, xpos, ypos,
                                            xneg, yneg, h, l, c, shifts,
                                            srng)
        results.append((terms, [p.detach().clone() for m in models.values()
                                for p in m.parameters()]))
    (t_j, p_j), (t_c, p_c) = results
    assert t_j.shape == (2, 4) and torch.equal(t_j, t_c)
    for pj, pc in zip(p_j, p_c):
        assert torch.equal(pj, pc)


def test_masker_step_ingests_once_with_one_shift_for_a():
    """One ingest call per masker step, with A's two labelled segments
    rolled by the same draw and B unrolled; the fused critic pass reads
    the ingest's joined batch itself."""
    cfg = Config(dropout=0.0, shift=12).derive()
    xpos, ypos = _banks(1)
    xneg, yneg = _banks(2)
    critic, masker = port_models()
    models = {"critic": critic, "masker": masker}
    calls, inputs = [], []
    real = losses_mod.gather_normalize_u8

    def spy(segments):
        out = real(segments)
        calls.append(([s.shift for s in segments],
                      [s.labels is not None for s in segments],
                      out[0].data_ptr()))
        return out

    critic.register_forward_pre_hook(
        lambda _m, args: inputs.append(args[0].data_ptr()))
    with mock.patch.object(losses_mod, "gather_normalize_u8", spy):
        masker_chunk(cfg, models, make_optimizer(models), xpos, ypos, xneg,
                     yneg, np.array([[1, 2]]), np.array([[3, 4]]),
                     np.array([[5, 6, 7, 8]]), StepRng.seeded(0, "cpu"))
    assert len(calls) == 1
    shifts, labelled, ptr = calls[0]
    assert shifts[0] == shifts[1] and shifts[2] == 0
    assert labelled == [True, True, False]
    assert inputs[0] == ptr


@pytest.mark.parametrize("stack,bad", [("critic", -1), ("critic", 12),
                                       ("h", 12), ("l", 12), ("c", -3)])
def test_out_of_range_index_stacks_raise_on_the_host(stack, bad):
    """A gather in a kernel reads out of bounds silently, so the chunks
    check their index stacks on the host before anything runs."""
    x, y = _banks(1)
    idx = {k: np.zeros((1, 4 if k == "c" else 2), np.int64)
           for k in ("critic", "h", "l", "c")}
    idx[stack][0, 1] = bad
    _build.launches.clear()
    with pytest.raises(IndexError, match="out of range"):
        if stack == "critic":
            critic_chunk(Config().derive(), None, None, x, y,
                         idx["critic"], None)
        else:
            masker_chunk(Config().derive(), {}, None, x, y, x, y,
                         idx["h"], idx["l"], idx["c"], None)
    assert sum(_build.launches.values()) == 0
