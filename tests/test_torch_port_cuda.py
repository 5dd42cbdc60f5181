"""PyTorch port on the card: each CUDA kernel against its plain
version, the pipeline's and the masker step's kernel path against
their plain paths, and the gradient of a fused upsample-into-concat
join through a conv.

Marked `cuda`; every test skips without a CUDA device. This file
imports neither JAX nor the JAX package, so it also runs on a machine
with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

from unittest import mock

import pytest
import torch

from cgs_tpu_torch.ops import _build
from cgs_tpu_torch.ops.kernels import (
    Segment, gather_normalize_u8, gather_normalize_u8_plain, merge_pair,
    merge_pair_bwd, merge_pair_bwd_plain, merge_pair_plain, normalize_u8,
    normalize_u8_plain, threshold_iou, threshold_iou_plain,
)
from cgs_tpu_torch.ops.upsample import (
    up_cat, upcat_bwd, upcat_bwd_plain, upcat_fwd, upcat_plain, upsample2x,
    upsample2x_bwd, upsample2x_bwd_plain, upsample2x_plain,
)

STEPS = [(1, 1, 160), (2, 2, 160), (4, 4, 80), (8, 8, 40), (16, 16, 40),
         (32, 32, 40), (1, 1, 32), (2, 2, 32), (4, 4, 16), (8, 8, 8),
         (16, 16, 8), (32, 32, 8), (3, 5, 7), (5, 9, 3)]
# the decoder's skip joins (Cs, Cu, H, W, factor) at chfak 5 and 1, and
# ragged ones (odd Cs, Cu and W; no pixel or row 16-byte aligned)
JOINS = [(80, 160, 1, 1, 4), (40, 80, 4, 4, 2), (40, 40, 8, 8, 2),
         (40, 40, 16, 16, 2), (3, 40, 32, 32, 2), (16, 32, 1, 1, 4),
         (8, 16, 4, 4, 2), (8, 8, 8, 8, 2), (8, 8, 16, 16, 2),
         (3, 8, 32, 32, 2), (5, 7, 3, 9, 2), (3, 5, 2, 3, 4),
         (0, 7, 3, 5, 2)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


def _unaligned(t):
    """A copy of t whose data starts 1 element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return buf.copy_(t.flatten()).view(t.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalize_u8_bit_equal(dev, dtype):
    for shape in [(0, 12288), (7, 12288), (1001, 12288), (3, 4097),
                  (5, 64, 64, 3), (4, 5, 7, 3)]:
        u8 = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev)
        assert torch.equal(_bits(normalize_u8(u8, dtype)),
                           _bits(normalize_u8_plain(u8, dtype))), shape
    # a buffer that is not 16-byte aligned takes the one-element path
    u8 = torch.randint(0, 256, (4099,), dtype=torch.uint8, device=dev)[3:]
    assert torch.equal(normalize_u8(u8, dtype), normalize_u8_plain(u8, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gather_normalize_u8_bit_equal(dev, dtype):
    """The masker step's three segments (repeated indices, one shift for
    A, labels for A) at every shift -70..70, the critic step's one, an
    empty segment, N = 0, rows that are not a multiple of 16 bytes and
    banks off a 16-byte boundary."""
    def bank(m, h=64, w=64):
        return torch.randint(0, 256, (m, h, w, 3), dtype=torch.uint8,
                             device=dev)

    def idx(n, m):
        return torch.randint(0, m, (n,), device=dev)

    xpos, xneg = bank(40), bank(50)
    ypos, yneg = torch.rand(40, device=dev), torch.rand(50, device=dev)
    h, l, c = idx(32, 40), idx(32, 50), idx(64, 50)
    h[:4] = 7                                    # repeated indices
    cases = [[Segment(xpos, h, s, ypos), Segment(xneg, l, s, yneg),
              Segment(xneg, c)] for s in range(-70, 71)]
    cases += [[Segment(xpos, idx(64, 40), -12, ypos)],
              [Segment(xpos, h, 3, ypos), Segment(xneg, c[:0], 3, yneg),
               Segment(xneg, c)],
              [Segment(xpos, c[:0])],
              [Segment(bank(6, 5, 7), idx(9, 6), 4), Segment(bank(3, 5, 7))],
              [Segment(_unaligned(xpos), h, -5, ypos), Segment(xneg, c)]]
    for segs in cases:
        (got, gy), (want, wy) = (gather_normalize_u8(segs, dtype),
                                 gather_normalize_u8_plain(segs, dtype))
        assert got.shape == want.shape and torch.equal(_bits(got),
                                                        _bits(want))
        assert (gy is None and wy is None) or torch.equal(gy, wy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample2x_bit_equal(dev, dtype):
    for h, w, c in STEPS:
        x = torch.rand((3, h, w, c), device=dev).to(dtype)
        assert torch.equal(_bits(upsample2x(x)),
                           _bits(upsample2x_plain(x))), (h, w, c)


@pytest.mark.cuda
def test_threshold_iou_exact(dev):
    """Exact counts at the eval set, ragged N, an odd numel (the tail
    element by element), N = 0, a mask and a gt off their 16-byte
    boundaries (the element path), and calls back to back (each leaves
    the last-block ticket at 0 for the next)."""
    for shape in [(0, 4096), (5, 4096), (2450, 4096), (3, 4095)]:
        m = torch.rand(shape, device=dev)
        g = torch.rand(shape, device=dev) > 0.7
        got = [int(v) for v in threshold_iou(m, g, 0.05)]
        assert got == [int(v) for v in threshold_iou_plain(m, g, 0.05)]
        if shape[0]:
            um, ug = _unaligned(m), _unaligned(g)
            assert [int(v) for v in threshold_iou(um, g, 0.05)] == got
            assert [int(v) for v in threshold_iou(m, ug, 0.05)] == got
    m = torch.rand((2450, 4096), device=dev)
    g = torch.rand((2450, 4096), device=dev) > 0.5
    outs = [threshold_iou(m, g, t) for t in (0.05, 0.5, 0.05, 0.95)]
    for (i, u), t in zip(outs, (0.05, 0.5, 0.05, 0.95)):
        assert [int(i), int(u)] == [int(v) for v in
                                    threshold_iou_plain(m, g, t)], t


@pytest.mark.cuda
def test_wrappers_count_launches_and_raise_on_bad_input(dev):
    _build.launches.clear()
    normalize_u8(torch.zeros(4, 16, dtype=torch.uint8, device=dev))
    upsample2x(torch.zeros(2, 4, 4, 8, device=dev))
    threshold_iou(torch.zeros(2, 8, device=dev),
                  torch.zeros(2, 8, dtype=torch.bool, device=dev), 0.5)
    assert dict(_build.launches) == {"normalize_u8": 1, "upsample2x": 1,
                                     "threshold_iou": 1}
    with pytest.raises(ValueError, match="contiguous"):
        normalize_u8(torch.zeros(4, 16, dtype=torch.uint8,
                                 device=dev).t())


@pytest.mark.cuda
def test_pipeline_kernel_path_equals_plain_path(dev):
    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.pipeline as pipeline_mod
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.pipeline import MaskPipeline

    critic, masker = Critic(dropout=0.0), UnetDecoder()
    params = {"critic": critic.state_dict(), "masker": masker.state_dict()}
    pipe = MaskPipeline(critic, masker, params, batch_size=64)
    frames = torch.randint(0, 256, (64, 64, 64, 3), dtype=torch.uint8,
                           device=dev)
    _build.launches.clear()
    pred, mask, _ = pipe.run_device(frames)
    assert dict(_build.launches) == {"normalize_u8": 1, "upsample2x": 5}
    with mock.patch.object(pipeline_mod, "normalize_u8",
                           normalize_u8_plain), \
            mock.patch.object(upsample_mod, "upcat_fwd", upcat_plain):
        ppred, pmask, _ = pipe.run_device(frames)
    torch.testing.assert_close(mask, pmask, atol=1e-5, rtol=0)
    torch.testing.assert_close(pred, ppred, atol=1e-5, rtol=0)


def _frames(dev, n, h=64, w=64, c=3):
    """NCHW float32 stored channels_last, as the critic takes frames."""
    return torch.rand((n, h, w, c), device=dev).permute(0, 3, 1, 2)


def _same(got, want):
    return all(g.shape == w.shape and torch.equal(_bits(g), _bits(w))
               for g, w in zip(got, want))


NEEDS = [(False, False, True), (True, True, True), (True, False, True)]


def _same_or_none(got, want):
    return all((g is None) == (w is None) for g, w in zip(got, want)) and \
        _same([g for g in got if g is not None],
              [w for w in want if w is not None])


@pytest.mark.cuda
def test_merge_pair_and_bwd_bit_equal(dev):
    """The joined output at the masker step's shape, a ragged one (a
    pixel count not divisible by 4 or by the backward's 1024-pixel
    tile), N = 0, frames that are the halves of one joined batch and
    frames off a 16-byte boundary; the backward for the outputs the
    masker step asks for (dz), all three and (da, dz), with the joined
    gradient in both memory formats."""
    for n, h, w in [(0, 64, 64), (7, 5, 9), (64, 64, 64), (3, 64, 65)]:
        ab = _frames(dev, 2 * n, h, w)
        z = _frames(dev, n, h, w, 1)
        _build.launches.clear()
        for a, b in ((_frames(dev, n, h, w), _frames(dev, n, h, w)),
                     (ab[:n], ab[n:])):
            got = merge_pair(a, b, z)
            assert got.is_contiguous(memory_format=torch.channels_last)
            assert _same([got], [merge_pair_plain(a, b, z)]), n
        ua = _unaligned(a.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        if n:
            assert _same([merge_pair(ua, b, z)],
                         [merge_pair_plain(ua, b, z)])
        g = _frames(dev, 2 * n, h, w)
        for fmt in (torch.channels_last, torch.contiguous_format):
            gg = g.contiguous(memory_format=fmt)
            for x, y in ((a, b), (ab[:n], ab[n:]), (ua, b)):
                for need in NEEDS:
                    got = merge_pair_bwd(x, y, z, gg, need)
                    assert all((t is not None) == k
                               for t, k in zip(got, need))
                    assert _same_or_none(
                        got, merge_pair_bwd_plain(x, y, z, gg, need)), (
                        n, h, w, fmt, need)
        assert dict(_build.launches) == (
            {"merge_pair": 3, "merge_pair_bwd": 18} if n else {})
    with pytest.raises(ValueError, match="channels_last"):
        a = torch.rand(2, 3, 8, 8, device=dev)          # NCHW frames
        merge_pair(a, a, torch.rand(2, 1, 8, 8, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample2x_bwd_bit_equal(dev, dtype):
    for h, w, c in STEPS:
        g = torch.rand((3, 2 * h, 2 * w, c), device=dev).to(dtype)
        assert _same([upsample2x_bwd(g)], [upsample2x_bwd_plain(g)]), \
            (h, w, c)
    # channel slices of a concat's gradient, in both memory formats
    wide = torch.rand((4, 64, 64, 43), device=dev).to(dtype)
    nchw = wide.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    for g in (wide[..., 3:], nchw[..., 3:]):
        assert _same([upsample2x_bwd(g)], [upsample2x_bwd_plain(g)])
    assert upsample2x_bwd(torch.zeros(0, 4, 4, 8, device=dev)).shape == (
        0, 2, 2, 8)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upcat_and_bwd_bit_equal(dev, dtype):
    """The fused pair at every join, a ragged shape, Cs = 0 and N = 0,
    with the concat gradient in both memory formats cuDNN's dgrad may
    hand over, with and without the skip's gradient."""
    for cs, cu, h, w, f in JOINS:
        for n in (3, 0):
            skip = torch.rand((n, f * h, f * w, cs), device=dev).to(dtype)
            x = torch.rand((n, h, w, cu), device=dev).to(dtype)
            _build.launches.clear()
            assert _same([upcat_fwd(skip, x, f)], [upcat_plain(skip, x, f)])
            g = torch.rand((n, f * h, f * w, cs + cu), device=dev).to(dtype)
            nchw = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            for gg in (g, nchw):
                for need in (True, False):
                    got = upcat_bwd(gg, cs, f, need)
                    want = upcat_bwd_plain(gg, cs, f, need)
                    assert (got[0] is None) == (want[0] is None)
                    assert _same([t for t in got if t is not None],
                                 [t for t in want if t is not None]), (
                        cs, cu, h, w, f, n, gg.stride(), need)
            assert dict(_build.launches) == (
                {"upsample2x": 1, "upsample2x_bwd": 4} if n else {})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_up2_gradient_through_cat_equals_plain(dev, dtype):
    """A decoder skip join as the masker step runs it: `up_cat` of a
    skip feature and an upsampled activation, then a conv. The kernel
    path's output and input gradients against autograd of `torch.cat`
    and the plain upsample (repeat_interleave's own backward sums in
    another order, and in bf16 rounds after each of its two pair sums
    where the kernel rounds once: 1e-6 in f32, two bf16 ulps in bf16);
    the skip's gradient is a copy, exact."""
    torch.manual_seed(0)
    conv = torch.nn.Conv2d(80, 40, 3, padding=1).to(
        dev, dtype, memory_format=torch.channels_last)
    skip0 = torch.rand(4, 40, 32, 32, device=dev, dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    x0 = torch.rand(4, 40, 16, 16, device=dev, dtype=dtype).contiguous(
        memory_format=torch.channels_last)

    def grad(join):
        skip = skip0.clone().requires_grad_()
        x = x0.clone().requires_grad_()
        y = conv(join(skip, x))
        y.float().square().sum().backward()
        return y.detach(), skip.grad, x.grad

    _build.launches.clear()
    y_k, s_k, g_k = grad(up_cat)
    assert dict(_build.launches) == {"upsample2x": 1, "upsample2x_bwd": 1}
    y_p, s_p, g_p = grad(lambda s, t: torch.cat([s, upsample2x_plain(
        t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)], dim=1))
    assert torch.equal(y_k, y_p) and torch.equal(s_k, s_p)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -6
    torch.testing.assert_close(g_k.float(), g_p.float(), atol=tol,
                               rtol=tol)
    assert bool(g_k.abs().sum() > 0)


@pytest.mark.cuda
def test_masker_step_kernel_path_equals_plain_path(dev, monkeypatch):
    """One masker step (`train/steps.py:masker_step`, frames gathered
    from uint8 banks by index and shifted), its loss terms and
    gradients, kernel path against the plain versions patched in,
    bit-equal under deterministic cuDNN (the kernels are bit-equal to
    their plain versions); one ingest launch for the step's frames and
    labels; every decoder gradient is non-zero (an upsample without a
    gradient would zero them). The optimizer has lr 0, so both runs
    start from the same weights and the gradients stay in .grad."""
    import cgs_tpu_torch.ops.merge as merge_mod
    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.train.losses as losses_mod
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.train.steps import StepRng, masker_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = Config(dropout=0.0).derive()
    models = {"critic": Critic(dropout=0.0), "masker": UnetDecoder()}
    for m in models.values():
        m.to(dev, memory_format=torch.channels_last)
    opt = torch.optim.SGD([p for m in models.values()
                           for p in m.parameters()], lr=0.0)
    xpos, xneg = (torch.randint(0, 256, (24, 64, 64, 3), dtype=torch.uint8,
                                device=dev) for _ in range(2))
    ypos, yneg = torch.rand(24, device=dev), torch.rand(24, device=dev)
    h, l, c = (torch.randint(0, 24, (n,), device=dev) for n in (8, 8, 16))
    a = [Segment(xpos, h, labels=ypos), Segment(xneg, l, labels=yneg)]

    def run():
        terms = masker_step(cfg, models, opt, a, Segment(xneg, c),
                            StepRng.seeded(0, dev))
        return ([float(t) for t in terms],
                [p.grad.clone() for m in models.values()
                 for p in m.parameters()])

    _build.launches.clear()
    terms, grads = run()
    assert dict(_build.launches) == {
        "normalize_u8": 1, "merge_pair": 1, "merge_pair_bwd": 1,
        "upsample2x": 5, "upsample2x_bwd": 5}
    with mock.patch.object(losses_mod, "gather_normalize_u8",
                           gather_normalize_u8_plain), \
            mock.patch.object(merge_mod, "merge_pair", merge_pair_plain), \
            mock.patch.object(merge_mod, "merge_pair_bwd",
                              merge_pair_bwd_plain), \
            mock.patch.object(upsample_mod, "upcat_fwd", upcat_plain), \
            mock.patch.object(upsample_mod, "upcat_bwd", upcat_bwd_plain):
        p_terms, p_grads = run()
    assert terms == p_terms
    for g, pg in zip(grads, p_grads):
        assert torch.equal(_bits(g), _bits(pg))
    for name, p in models["masker"].named_parameters():
        assert bool(p.grad.abs().sum() > 0), name
