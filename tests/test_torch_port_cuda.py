"""PyTorch port on the card: each CUDA kernel against its plain
version (the ingest for R seeds too) at the shapes of the serve batch
(8192 frames), the masker step (2K = 64) and ragged ones, in f32 and
bf16, with `threshold_iou` one device operation a call; the pipeline's
(chfak 1 and 5, f32 and bf16), the R = 3 ensemble's and the masker
step's (chfak 1, and chfak 5 at K = 32 with the gradient layouts and
outputs the step hands the kernels) kernel path against their plain
paths; no concat kernel in a pipeline batch, a critic step or a masker
step, and finite critic and masker chunk losses;
`MaskPipeline.run`'s staging ring against `run_device`, a seeded masker
step's launches at R = 1, 3 and 10, the dense CRF on kernel-path masks,
and the gradient of a fused upsample-into-concat join through a conv;
the convolution epilogue (bias, activation, pool) bit-equal to PyTorch's
own chain at every (act, pool) and width, and the pipeline through it
against the same modules run eagerly (chfak 1 and 5, ResNet-18,
ConvNeXt-T, Swin V2-T, f32 and bf16: preds and the rest bit-equal, the mask of the
one-launch mask head within twice the eager chain's own gap to a
float64 evaluation); the mask head kernel against its plain version and
float64 at the serve batch and ragged shapes; the ConvNeXt-T pair on the
card against its CPU path; the Swin V2-T pair's fused attention against
the benchmark's plain reference, 12 attention launches a forward.
These are the card's checks of single kernels and single steps;
`chip_smoke.py` runs whole paths, and `portbench/` measures speed.

Marked `cuda`; every test skips without a CUDA device. This file
imports neither JAX nor the JAX package, so it also runs on a machine
with the card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py
"""

import contextlib
import math
from unittest import mock

import numpy as np
import pytest
import torch

from cgs_tpu_torch.ops import _build
from cgs_tpu_torch.ops.kernels import (
    ACTS, Segment, bias_act_pool, bias_act_pool_plain, conv_mask_head,
    conv_mask_head_plain, gather_normalize_u8, gather_normalize_u8_plain,
    mask_head, mask_head_plain, merge_pair,
    merge_pair_bwd, merge_pair_bwd_plain, merge_pair_plain, normalize_u8,
    normalize_u8_plain, threshold_iou, threshold_iou_plain,
)
from cgs_tpu_torch.ops.upsample import (
    up_cat, upcat_bwd, upcat_bwd_plain, upcat_fwd, upcat_plain, upsample2x,
    upsample2x_bwd, upsample2x_bwd_plain, upsample2x_plain,
)

BATCH = 8192            # the serve batch
MASKER_N = 64           # the frames a masker step merges and decodes (2K)
STEPS = [(1, 1, 160), (2, 2, 160), (4, 4, 80), (8, 8, 40), (16, 16, 40),
         (32, 32, 40), (1, 1, 32), (2, 2, 32), (4, 4, 16), (8, 8, 8),
         (16, 16, 8), (32, 32, 8), (3, 5, 7), (5, 9, 3)]
# the decoder's skip joins (Cs, Cu, H, W, factor) at chfak 5 and 1
DECODER_JOINS = [(80, 160, 1, 1, 4), (40, 80, 4, 4, 2), (40, 40, 8, 8, 2),
                 (40, 40, 16, 16, 2), (3, 40, 32, 32, 2), (16, 32, 1, 1, 4),
                 (8, 16, 4, 4, 2), (8, 8, 8, 8, 2), (8, 8, 16, 16, 2),
                 (3, 8, 32, 32, 2)]
# ragged joins no decoder has (odd Cs, Cu and W; no pixel or row 16-byte
# aligned; Cs = 0 is the plain upsample)
RAGGED_JOINS = [(5, 7, 3, 9, 2), (3, 5, 2, 3, 4), (0, 7, 3, 5, 2),
                (0, 3, 5, 7, 2)]
JOINS = DECODER_JOINS + RAGGED_JOINS
# zoo.Unet's joins at chfak 5 (upsampled channels first)
UNET_JOINS = [(80, 80, 4, 4, 2), (40, 40, 8, 8, 2), (40, 40, 16, 16, 2),
              (40, 40, 32, 32, 2)]


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


# the device kernel each launch counter of `_build.launches` stands for,
# by a piece of its name (the first piece a name holds decides)
PORT_KERNELS = (("merge_pair_bwd", "merge_pair_bwd"),
                ("merge_pair", "merge_pair"),
                ("upsample_cat_bwd", "upsample2x_bwd"),
                ("upsample_cat_fwd", "upsample2x"),
                ("ingest_", "normalize_u8"),
                ("threshold_iou", "threshold_iou"),
                ("bias_act_pool", "bias_act_pool"),
                ("conv_mask_head", "conv_mask_head"),
                ("mask_head", "mask_head"))


def _device_ops(fn):
    """{name: count} of the device operations (kernels, copies, fills)
    of one fn() call, from torch.profiler; it times nothing. The last of
    three calls is read, each launched 50 ms into its step (the tracer
    can drop device events from the first milliseconds of a step). The
    trace must hold every port kernel that call launched, as many times
    as `_build.launches` counted it, so a check that a kernel is absent
    never rests on a trace with a window missing."""
    import collections
    import time

    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=1, active=1)) as prof:
        for _ in range(3):
            time.sleep(0.05)
            _build.launches.clear()
            fn()
            torch.cuda.synchronize()
            prof.step()
    launched = dict(_build.launches)
    ops = {e.key: e.count for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)}
    traced = collections.Counter()
    for name, count in ops.items():
        for piece, launch in PORT_KERNELS:
            if piece in name:
                traced[launch] += count
                break
    assert launched and dict(traced) == launched, (launched, ops)
    return ops


def _concats(ops):
    """The concat kernels among `ops` (torch.cat's `CatArray*`); the
    port's own kernels, `upsample_cat_*` among them, are not concats."""
    ours = ("ingest_", "upsample", "threshold_iou", "merge_pair")
    return [k for k in ops
            if any(c in k.lower() for c in ("catarray", "cat_"))
            and not any(o in k.lower() for o in ours)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_normalize_u8_bit_equal(dev, dtype):
    for shape in [(0, 12288), (7, 12288), (1001, 12288), (3, 4097),
                  (5, 64, 64, 3), (4, 5, 7, 3), (BATCH, 64, 64, 3)]:
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
    empty segment, N = 0, rows that are not a multiple of 16 bytes,
    banks off a 16-byte boundary and the serve batch, a bank of 8192
    frames read whole."""
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
              [Segment(_unaligned(xpos), h, -5, ypos), Segment(xneg, c)],
              [Segment(bank(BATCH))]]
    for segs in cases:
        (got, gy), (want, wy) = (gather_normalize_u8(segs, dtype),
                                 gather_normalize_u8_plain(segs, dtype))
        assert got.shape == want.shape and torch.equal(_bits(got),
                                                        _bits(want))
        assert (gy is None and wy is None) or torch.equal(gy, wy)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_seeded_gather_normalize_u8_bit_equal(dev, dtype):
    """R seeds in one launch: each seed's index rows and its own shift,
    segment-major and seed-major within a segment, at R = 1, 3 and 64
    (the most one launch takes); at R = 3 a masker step's A and B and a
    critic step's batch at shift triples across -63..63; R = 1 equals
    the (n,) call."""
    bank = torch.randint(0, 256, (40, 64, 64, 3), dtype=torch.uint8,
                         device=dev)
    y = torch.rand(40, device=dev)
    for r in (1, 3, 64):
        a = torch.randint(0, 40, (r, 16), device=dev)
        b = torch.randint(0, 40, (r, 8), device=dev)
        shifts = [(7 * i) % 129 - 64 for i in range(r)]
        segs = [Segment(bank, a, shifts, y), Segment(bank, b)]
        _build.launches.clear()
        got, gy = gather_normalize_u8(segs, dtype)
        assert _build.launches["normalize_u8"] == 1
        want, wy = gather_normalize_u8_plain(segs, dtype)
        assert torch.equal(_bits(got), _bits(want)) and torch.equal(gy, wy)
    a, b = (torch.randint(0, 40, (3, MASKER_N), device=dev) for _ in "ab")
    for sh in range(-63, 64, 9):
        shifts = [sh, -sh, 2 * sh]
        for segs in ([Segment(bank, a, shifts, y), Segment(bank, b)],
                     [Segment(bank, b, shifts, y)]):
            got, gy = gather_normalize_u8(segs, dtype)
            want, wy = gather_normalize_u8_plain(segs, dtype)
            assert torch.equal(_bits(got), _bits(want)), shifts
            assert torch.equal(gy, wy), shifts
    one, _ = gather_normalize_u8([Segment(bank, a[:1], [9], y)], dtype)
    flat, _ = gather_normalize_u8([Segment(bank, a[0], 9, y)], dtype)
    assert torch.equal(_bits(one), _bits(flat))


@pytest.mark.cuda
@pytest.mark.parametrize("r", [1, 3, 10])
def test_seeded_masker_step_launches_once_per_kernel(dev, r):
    """A seeded masker step of R seeds launches what a serial one does:
    1 ingest, 1 + 1 merge, 5 + 5 joins; its (R, 4) terms are finite."""
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.models.seeded import SeededCritic, SeededDecoder
    from cgs_tpu_torch.sandbox.seed_parallel import (
        SeedRng, _on_device, init_seed_params, seeded_masker_step,
    )
    from cgs_tpu_torch.train.steps import make_optimizer

    init = init_seed_params(Critic(), UnetDecoder(), list(range(r)))
    models = {"critic": _on_device(SeededCritic(r), init["critic"], dev),
              "masker": _on_device(SeededDecoder(r), init["masker"], dev)}
    opt = make_optimizer(models)
    bank = torch.randint(0, 256, (40, 64, 64, 3), dtype=torch.uint8,
                         device=dev)
    y = torch.rand(40, device=dev)
    a = torch.randint(0, 40, (r, 64), device=dev)
    b = torch.randint(0, 40, (r, 64), device=dev)
    _build.launches.clear()
    terms = seeded_masker_step(Config().derive(), models, opt,
                               Segment(bank, a, labels=y), Segment(bank, b),
                               SeedRng.seeded(list(range(r)), dev))
    assert terms.shape == (r, 4) and bool(torch.isfinite(terms).all())
    assert dict(_build.launches) == {
        "normalize_u8": 1, "merge_pair": 1, "merge_pair_bwd": 1,
        "upsample2x": 5, "upsample2x_bwd": 5}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample2x_bit_equal(dev, dtype):
    for h, w, c in STEPS:
        x = torch.rand((3, h, w, c), device=dev).to(dtype)
        assert torch.equal(_bits(upsample2x(x)),
                           _bits(upsample2x_plain(x))), (h, w, c)


# (N, H, W, C) convolution outputs the epilogue sees: the chfak-5 and
# chfak-1 critic blocks and decoder convs, the 1-channel head, and widths
# that are no multiple of 4 or 8
EPILOGUE_C = (1, 16, 40, 80, 160, 43)


def _eager_epilogue(y, b, act, pool, out_dtype):
    """The modules' chain on the card, NCHW: the bias add in y's type,
    the activation in the output's, the pool."""
    from torch import nn
    mod = {"none": nn.Identity(), "relu": nn.ReLU(),
           "leaky_relu": nn.LeakyReLU(0.01), "sigmoid": nn.Sigmoid()}[act]
    x = y.permute(0, 3, 1, 2)
    out = mod((x + b[:, None, None]).to(out_dtype))
    if pool == 2:
        out = torch.nn.functional.max_pool2d(out, 2)
    return out.permute(0, 2, 3, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
def test_bias_act_pool_bit_equal(dev, dtype, out_dtype):
    """Every (act, pool) at each width, aligned and not: bit-equal to
    the eager chain and to the plain version; one launch a call."""
    for c in EPILOGUE_C:
        y = torch.randn((5, 12, 10, c), device=dev).to(dtype)
        y[0, 0, 0] = 0.0
        y[0, 0, 1] = -0.0
        b = torch.randn(c, device=dev).to(dtype)
        for act in ACTS:
            for pool in (1, 2):
                for t in (y, _unaligned(y)):
                    _build.launches.clear()
                    got = bias_act_pool(t, b, act, pool, out_dtype=out_dtype)
                    assert dict(_build.launches) == {"bias_act_pool": 1}
                    want = _eager_epilogue(t, b, act, pool, out_dtype)
                    key = (c, act, pool, t.data_ptr() % 16)
                    assert got.dtype == out_dtype and got.is_contiguous()
                    assert torch.equal(_bits(got), _bits(want)), key
                    assert torch.equal(got, bias_act_pool_plain(
                        t, b, act, pool, out_dtype=out_dtype)), key


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_bias_act_pool_bit_equal_at_the_serve_batch(dev, dtype):
    """The chfak-5 critic's first block (64 x 64 x 40, ReLU, pool) and
    the mask head (64 x 64 x 16, LeakyReLU; 64 x 64 x 1, sigmoid to f32)
    at batch 8192."""
    for (h, w, c), act, pool, out_dtype in (
            ((64, 64, 40), "relu", 2, dtype),
            ((64, 64, 16), "leaky_relu", 1, dtype),
            ((64, 64, 1), "sigmoid", 1, torch.float32)):
        y = torch.randn((BATCH, h, w, c), device=dev).to(dtype)
        b = torch.randn(c, device=dev).to(dtype)
        got = bias_act_pool(y, b, act, pool, out_dtype=out_dtype)
        want = _eager_epilogue(y, b, act, pool, out_dtype)
        assert torch.equal(_bits(got), _bits(want)), (c, act)
        del y, got, want


@pytest.mark.cuda
def test_bias_act_pool_refuses_a_layout_it_would_copy(dev):
    """An NCHW-contiguous convolution output, seen as NHWC, is strided:
    the wrapper raises rather than copy it."""
    y = torch.randn(4, 16, 8, 8, device=dev)         # NCHW-dense
    with pytest.raises(ValueError, match="channels_last"):
        bias_act_pool(y.permute(0, 2, 3, 1), torch.zeros(16, device=dev),
                      "relu", 2)
    with pytest.raises(ValueError, match="bias"):
        bias_act_pool(y.permute(0, 2, 3, 1).contiguous(),
                      torch.zeros(16), "relu", 2)


def _head_inputs(dev, n, h, w, c, dtype, seed=0):
    """The mask head's inputs: y0 (N, H, W, C) as `masker.0` leaves it
    without its bias, b0 with both signs (so that a border padded with
    leaky(b0) in place of 0 shows), w2 (1, C, 3, 3) at the default
    init's scale, b2 (1,), all of `dtype`."""
    g = torch.Generator(device=dev).manual_seed(seed)
    y0 = torch.randn((n, h, w, c), device=dev, generator=g)
    b0 = torch.rand(c, device=dev, generator=g) + 0.5
    b0[1::2] *= -1
    bound = 1 / math.sqrt(9 * c)
    w2 = (torch.rand((1, c, 3, 3), device=dev, generator=g) * 2 - 1) * bound
    b2 = (torch.rand(1, device=dev, generator=g) * 2 - 1) * bound
    return tuple(t.to(dtype) for t in (y0, b0, w2, b2))


def _gap64(mask, args):
    """The largest distance of `mask` from the head evaluated in float64
    on the same inputs."""
    return float((mask.double() - _exact64(args)).abs().max())


def _exact64(args):
    """The mask head in float64 on `args`: `mask_head_plain`, or with the
    join and masker.0's weight first (6 arguments) `conv_mask_head_plain`,
    a slice of 1024 frames at a time (a serve batch's join in float64
    takes 18 GB at C = 67)."""
    plain = conv_mask_head_plain if len(args) == 6 else mask_head_plain
    x, *rest = args
    rest = [a.double() if torch.is_tensor(a) else a for a in rest]
    return torch.cat([plain(x[lo:lo + 1024].double(), *rest)
                      for lo in range(0, len(x), 1024)])


# the route's two mask-head kernels (`models/epilogue.py`: f32 takes the
# whole head, bf16 the head after masker.0), each with its plain version
HEADS = {"conv_mask_head_op": (conv_mask_head, conv_mask_head_plain),
         "mask_head": (mask_head, mask_head_plain)}


def _recording(head, calls):
    """`head` (a mask-head kernel or its plain version) that appends each
    call's (inputs, a copy of its mask) to `calls`: an ensemble adds its
    members' masks into the first one in place."""
    def run(*args):
        mask = head(*args)
        calls.append((args, mask.clone()))
        return mask
    return run


@contextlib.contextmanager
def _recording_heads(calls, plain=False):
    """A context in which the route's mask heads, either kernel (or its
    plain version), record their calls in `calls`."""
    import cgs_tpu_torch.models.epilogue as epilogue_mod

    with contextlib.ExitStack() as stack:
        for name, fns in HEADS.items():
            stack.enter_context(mock.patch.object(
                epilogue_mod, name, _recording(fns[plain], calls)))
        yield


def _heads_within_twice_the_plain_gap(kernel, plain):
    """Each kernel-path head call's mask within twice its plain-path
    twin's gap to float64, each gap taken on its own path's inputs."""
    assert len(kernel) == len(plain) > 0
    for (ka, km), (pa, pm) in zip(kernel, plain):
        gap, plain_gap = _gap64(km, ka), _gap64(pm, pa)
        assert gap <= 2 * plain_gap, (gap, plain_gap)


def _head_gaps(args):
    """(the kernel's, the eager chain's) largest gap to float64; the
    chain is `mask_head_plain` on the card: the LeakyReLU epilogue,
    cuDNN's convolution, the sigmoid epilogue."""
    _build.launches.clear()
    got = mask_head(*args)
    assert dict(_build.launches) == {"mask_head": 1}
    assert got.dtype == torch.float32 and got.shape == args[0].shape[:3]
    chain = mask_head_plain(*args)
    return _gap64(got, args), _gap64(chain, args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_head_within_twice_the_chains_gap_to_float64(dev, monkeypatch,
                                                         dtype):
    """At the serve batch and at 1 and 7 frames of the head's shape
    (64 x 64 x 16): the kernel's worst gap to float64 is at most twice
    cuDNN's chain's own (TF32 off, as -process runs); its products are
    summed in another order, so bit-equality is not asked. One launch,
    one device kernel a call."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    for n in (BATCH, 1, 7):
        args = _head_inputs(dev, n, 64, 64, 16, dtype, seed=n)
        ours, chain = _head_gaps(args)
        assert ours <= 2 * chain, (n, ours, chain)
        del args
    args = _head_inputs(dev, 7, 64, 64, 16, dtype)
    ops = _device_ops(lambda: mask_head(*args))
    assert sum(ops.values()) == 1 and "mask_head" in next(iter(ops)), ops


# (N, H, W, C) off the main path's shape: ragged strips and columns, more
# than one strip of columns, C below, above and not a multiple of 4 or 8,
# and the main path's width with a ragged last strip
RAGGED_HEADS = [(256, 5, 7, 3), (8, 64, 130, 16), (32, 9, 64, 20),
                (8, 64, 64, 64), (64, 64, 64, 1), (16, 13, 70, 8),
                (16, 13, 64, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mask_head_ragged_shapes_and_layouts(dev, monkeypatch, dtype):
    """Widths from 1 to 64, ragged frames, y0 off its 16-byte boundary
    (the element-by-element loads) and w2 channels_last as the pipeline
    keeps it: within twice the chain's gap to float64 (TF32 off)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    for n, h, w, c in RAGGED_HEADS:
        y0, b0, w2, b2 = _head_inputs(dev, n, h, w, c, dtype, seed=c)
        for y, w2_ in ((y0, w2), (_unaligned(y0), w2),
                       (y0, w2.contiguous(memory_format=torch.channels_last))):
            ours, chain = _head_gaps((y, b0, w2_, b2))
            key = (n, h, w, c, y.data_ptr() % 16, w2_.stride())
            assert ours <= 2 * chain, (key, ours, chain)


@pytest.mark.cuda
def test_mask_head_refuses_a_layout_it_would_copy(dev):
    y0, b0, w2, b2 = _head_inputs(dev, 2, 8, 8, 16, torch.float32)
    nchw = y0.permute(0, 3, 1, 2).contiguous()       # NCHW-dense
    with pytest.raises(ValueError, match="channels_last"):
        mask_head(nchw.permute(0, 2, 3, 1), b0, w2, b2)
    with pytest.raises(ValueError, match="b0"):
        mask_head(y0, b0.cpu(), w2, b2)


# the last join's width in the configurations: chfak 1, chfak 5,
# resnet18, convnext_t and swin_v2_t
JOIN_WIDTHS = (11, 43, 67, 99)


def _conv_head_inputs(dev, n, c, h=64, seed=0):
    """A join (N, H, 64, C), the NHWC view of a channels_last tensor of
    signed values, and a head's parameters: uniform in PyTorch's
    default bounds, masker.0's weights channels_last as the pipeline
    keeps them, b0 of both signs."""
    g = torch.Generator(device=dev).manual_seed(seed)
    cl = torch.channels_last
    x = torch.randn((n, c, h, 64), device=dev, generator=g).contiguous(
        memory_format=cl)
    b = 1 / math.sqrt(9 * c)
    w0 = ((torch.rand((16, c, 3, 3), device=dev, generator=g) * 2 - 1)
          * b).contiguous(memory_format=cl)
    b0 = torch.rand(16, device=dev, generator=g) * b + 0.05
    b0[1::2] *= -1
    w2 = (torch.rand((1, 16, 3, 3), device=dev, generator=g) * 2 - 1) / 12
    b2 = (torch.rand(1, device=dev, generator=g) * 2 - 1) / 12
    return x.permute(0, 2, 3, 1), w0, b0, w2, b2, 0.01


def _conv_head_gaps(args):
    """(the kernel's, the eager chain's) largest gap to float64; the
    chain is cuDNN's masker.0 without its bias, then `mask_head`'s
    kernel, as the route ran before the whole head was one kernel."""
    x, w0, b0, w2, b2, slope = args
    _build.launches.clear()
    got = conv_mask_head(*args)
    assert dict(_build.launches) == {"conv_mask_head": 1}
    assert got.dtype == torch.float32 and got.shape == x.shape[:3]
    y0 = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), w0, None, 1, 1)
    # (at C = 1 cuDNN's output is NCHW-dense, which mask_head refuses)
    y0 = y0.contiguous(memory_format=torch.channels_last)
    chain = mask_head(y0.permute(0, 2, 3, 1), b0, w2, b2, slope)
    del y0
    exact = _exact64(args)
    return tuple(float((m.double() - exact).abs().max())
                 for m in (got, chain))


@pytest.mark.cuda
@pytest.mark.parametrize("c", JOIN_WIDTHS)
def test_conv_mask_head_within_twice_the_chains_gap_to_float64(
        dev, monkeypatch, c):
    """At the serve batch and at 3 frames, at each join width of the
    configurations: the kernel's worst gap to float64 is at most twice
    that of cuDNN's masker.0 and `mask_head` (TF32 off, as -process
    runs); its sums run in another order. One launch a call; on the
    device the kernel and PyTorch's copy of masker.0's weight into the
    kernel's layout."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    for n in (BATCH, 3):
        args = _conv_head_inputs(dev, n, c, seed=n + c)
        ours, chain = _conv_head_gaps(args)
        assert ours <= 2 * chain, (n, ours, chain)
        del args
    args = _conv_head_inputs(dev, 3, c)
    ops = _device_ops(lambda: conv_mask_head(*args))
    heads = [k for k in ops if "conv_mask_head" in k]
    copies = [k for k in ops if "copy_kernel" in k]
    assert len(ops) == 2 and len(heads) == len(copies) == 1, ops
    assert ops[heads[0]] == ops[copies[0]] == 1, ops


@pytest.mark.cuda
def test_conv_mask_head_ragged_frames_borders_and_layouts(dev, monkeypatch):
    """Frames of 1, 13 and 70 rows (no whole tile, a ragged last tile,
    more than a frame's 64), C from 1 to the kernel's limit, both
    weights contiguous or channels_last; and a join whose border pixels
    alone are nonzero, which holds the zero padding of the join and of
    h: within twice the chain's gap to float64."""
    from cgs_tpu_torch.ops.kernels import CONV_MASK_HEAD_MAX_C

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    for n, h, c in ((5, 1, 11), (7, 13, 43), (3, 70, 1), (2, 64, 8),
                    (2, 64, 9), (4, 64, CONV_MASK_HEAD_MAX_C)):
        x, w0, b0, w2, b2, slope = _conv_head_inputs(dev, n, c, h, seed=h)
        for w0_, w2_ in ((w0, w2), (w0.contiguous(), w2.contiguous(
                memory_format=torch.channels_last))):
            ours, chain = _conv_head_gaps((x, w0_, b0, w2_, b2, slope))
            assert ours <= 2 * chain, ((n, h, c, w0_.stride()), ours, chain)
    x, *rest = _conv_head_inputs(dev, 4, 43, seed=1)
    inner = torch.zeros_like(x, dtype=torch.bool)
    inner[:, 1:-1, 1:-1] = True
    x = x.masked_fill(inner, 0.0)
    ours, chain = _conv_head_gaps((x, *rest))
    assert ours <= 2 * chain, (ours, chain)


@pytest.mark.cuda
def test_conv_mask_head_refuses_a_layout_it_would_copy(dev):
    x, w0, b0, w2, b2, slope = _conv_head_inputs(dev, 2, 11, h=8)
    nchw = x.permute(0, 3, 1, 2).contiguous()       # NCHW-dense
    with pytest.raises(ValueError, match="channels_last"):
        conv_mask_head(nchw.permute(0, 2, 3, 1), w0, b0, w2, b2)
    with pytest.raises(ValueError, match="b0"):
        conv_mask_head(x, w0, b0.cpu(), w2, b2)
    with pytest.raises(ValueError, match="f32"):
        conv_mask_head(x.bfloat16(), w0, b0, w2, b2)


def _route_pair(arch, chfak, dtype):
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.build import build_pair
    from cgs_tpu_torch.models.interop import init_torch_default

    cfg = Config(critic_arch=arch, chfak=chfak, dropout=0.0).derive()
    critic, masker = build_pair(cfg, dtype)
    gen = torch.Generator().manual_seed(7)
    params = {name: init_torch_default(mod, gen).state_dict()
              for name, mod in (("critic", critic), ("masker", masker))}
    return critic, masker, params


@pytest.mark.cuda
@pytest.mark.parametrize("arch,chfak,batch,dtype", [
    ("paper", 1, 64, torch.float32), ("paper", 1, 64, torch.bfloat16),
    ("paper", 5, 64, torch.float32), ("paper", 5, 64, torch.bfloat16),
    ("resnet18", 1, 64, torch.float32), ("resnet18", 1, 64, torch.bfloat16),
    ("convnext_t", 1, 64, torch.float32),
    ("convnext_t", 1, 64, torch.bfloat16),
    ("swin_v2_t", 1, 64, torch.float32),
    ("swin_v2_t", 1, 64, torch.bfloat16),
    ("paper", 5, BATCH, torch.float32)])
def test_pipeline_epilogue_route_equals_the_eager_forward(
        dev, monkeypatch, arch, chfak, batch, dtype):
    """`run_device` through the fused epilogues and the one-launch mask
    head against the same modules run eagerly (the route switched off),
    under deterministic cuDNN: preds and the critic's embeds bit-equal;
    the f32 mask within twice the eager mask's own gap to the head
    evaluated in float64 on the head's inputs; the u8 wire and the hard
    plane apart only where that float64 mask lies within the larger of
    the two gaps of a level's edge or of the threshold (in f32, 2e-6,
    the limit of `hard_gap` in `portbench/limits/`, which both gaps must
    stay under).
    A batch: 10 epilogue launches in a paper pair, 5 in a ResNet-18,
    ConvNeXt-T or Swin V2-T one (its decoder, the skipless 32x32 level's
    conv among them; its encoder is no `Critic` and counts under neither
    route), and one mask head: in f32 the whole head as one
    `conv_mask_head`, in bf16 masker.0 then one `mask_head`."""
    import cgs_tpu_torch.models.epilogue as epilogue_mod
    from cgs_tpu_torch.models.build import critic_forward
    from cgs_tpu_torch.pipeline import MaskPipeline
    from cgs_tpu_torch.utils.profiling import counts

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    # TF32 off, as -process runs (core/device.py:train_switches): the
    # eager mask is the float64 bound's yardstick
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    critic, masker, params = _route_pair(arch, chfak, dtype)
    if arch != "paper":
        critic.eval()
    pipes = [MaskPipeline(critic, masker, params, batch_size=batch, **kw)
             for kw in ({}, {"wire": "u8", "hard_threshold": 0.5})]
    frames = torch.randint(0, 256, (batch, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(8)
                           ).to(dev)
    fused = 10 if arch == "paper" else 5
    heads = []          # the head's inputs, for float64
    # f32 runs the whole head as one kernel, bf16 masker.0 then mask_head
    f32 = dtype == torch.float32
    head = "conv_mask_head" if f32 else "mask_head"
    _build.launches.clear()
    names = ("model.epilogue_fused", "model.epilogue_eager",
             "model.mask_heads", "model.mask_head_convs")
    before = [counts[k] for k in names]
    with _recording_heads(heads):
        got = [p.run_device(frames) for p in pipes]
    assert _build.launches["bias_act_pool"] == 2 * fused
    assert _build.launches[head] == 2
    assert [counts[k] - b for k, b in zip(names, before)] == [
        2 * fused, 0, 2, 2 * f32]
    with mock.patch.object(epilogue_mod, "on_card", lambda t: False):
        want = [p.run_device(frames) for p in pipes]
    # the critic's embeds, which the head's route does not touch
    member = pipes[0]._members[0]["critic"]
    x = normalize_u8(frames, pipes[0]._ingest_dtype).permute(0, 3, 1, 2)
    with torch.no_grad():
        embeds = critic_forward(member, x, collect=True)[1]
        with mock.patch.object(epilogue_mod, "on_card", lambda t: False):
            embeds_eager = critic_forward(member, x, collect=True)[1]
    for a, b in zip(embeds, embeds_eager, strict=True):
        assert (a is None) == (b is None)
        assert a is None or torch.equal(a, b)
    exact = _exact64(heads[0][0])[..., None]
    for g, w in zip(got, want):
        assert len(g) == len(w)
        assert g[0].dtype == w[0].dtype and torch.equal(g[0], w[0])
        assert g[2] is None and w[2] is None
    mask, mask_eager = got[0][1], want[0][1]
    assert mask.dtype == torch.float32 and mask.shape == exact.shape
    gap = float((mask.double() - exact).abs().max())
    gap_eager = float((mask_eager.double() - exact).abs().max())
    assert gap <= 2 * gap_eager
    tol = max(gap, gap_eager)
    if dtype == torch.float32:
        assert tol <= 2e-6
        tol = 2e-6
    # the u8 wire (floor(255 m)) and the hard plane (m >= 0.5) of the
    # same masks: apart only next to an edge
    levels = exact.clamp(0, 1) * 255
    level_edge = (levels - levels.round()).abs() <= 255 * tol
    for a, b, edge in ((got[1][1], want[1][1], level_edge),
                       (got[1][3], want[1][3], (exact - 0.5).abs() <= tol)):
        assert a.dtype == b.dtype == torch.uint8
        assert bool((edge | (a == b)).all())


@pytest.mark.cuda
def test_threshold_iou_exact(dev):
    """Exact counts at the eval set, ragged N, an odd numel (the tail
    element by element), N = 0, a mask and a gt off their 16-byte
    boundaries (the element path), and calls back to back (each leaves
    the last-block ticket at 0 for the next); one device operation, the
    kernel, a call."""
    for shape in [(0, 4096), (5, 4096), (1001, 4096), (2450, 4096),
                  (3, 4095)]:
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
    ops = _device_ops(lambda: threshold_iou(m, g, 0.05))
    assert sum(ops.values()) == 1 and "threshold_iou" in next(iter(ops)), ops


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
@pytest.mark.parametrize("chfak, batch, dtype", [
    (1, 64, torch.float32), (5, BATCH, torch.float32),
    (5, BATCH, torch.bfloat16)])
def test_pipeline_kernel_path_equals_plain_path(dev, monkeypatch, chfak,
                                                batch, dtype):
    """One batch of `run_device` at the reference's width and at the
    paper's at the serve batch: 1 ingest, 5 join, 10 epilogue and 1 mask
    head launches (`conv_mask_head` in f32, `mask_head` in bf16), masks
    in (0, 1), no concat kernel, and the plain path's preds under
    deterministic cuDNN; the mask head's kernel sums in another order than
    cuDNN, so its mask is held to twice the plain path's
    (`conv_mask_head_plain`'s or `mask_head_plain`'s) worst gap to the
    head evaluated in float64 on each path's own inputs."""
    import cgs_tpu_torch.models.epilogue as epilogue_mod
    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.pipeline as pipeline_mod
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.models.interop import init_torch_default
    from cgs_tpu_torch.pipeline import MaskPipeline

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    critic = Critic(chfak=chfak, dropout=0.0, compute_dtype=dtype)
    masker = UnetDecoder(chfak=chfak, compute_dtype=dtype)
    gen = torch.Generator().manual_seed(0)
    params = {name: init_torch_default(mod, gen).state_dict()
              for name, mod in (("critic", critic), ("masker", masker))}
    pipe = MaskPipeline(critic, masker, params, batch_size=batch)
    frames = torch.randint(0, 256, (batch, 64, 64, 3), dtype=torch.uint8,
                           device=dev)
    heads, plain_heads = [], []
    _build.launches.clear()
    with _recording_heads(heads):
        pred, mask, _ = pipe.run_device(frames)
    head = "conv_mask_head" if dtype == torch.float32 else "mask_head"
    assert dict(_build.launches) == {"normalize_u8": 1, "upsample2x": 5,
                                     "bias_act_pool": 10, head: 1}
    assert mask.shape == (batch, 64, 64, 1) and pred.shape == (batch,)
    assert bool(((mask > 0) & (mask < 1)).all())
    ops = _device_ops(lambda: pipe.run_device(frames))
    assert any("upsample_cat" in k for k in ops) and not _concats(ops), ops
    with mock.patch.object(pipeline_mod, "normalize_u8",
                           normalize_u8_plain), \
            mock.patch.object(upsample_mod, "upcat_fwd", upcat_plain), \
            mock.patch.object(epilogue_mod, "bias_act_pool",
                              bias_act_pool_plain), \
            _recording_heads(plain_heads, plain=True):
        ppred, pmask, _ = pipe.run_device(frames)
    assert torch.equal(mask[..., 0], heads[0][1])
    assert torch.equal(pmask[..., 0], plain_heads[0][1])
    _heads_within_twice_the_plain_gap(heads, plain_heads)
    torch.testing.assert_close(pred, ppred, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_convnext_pair_on_the_card_against_the_cpu(dev, monkeypatch):
    """The ConvNeXt-T pair's eval forward on the card (the epilogue
    route, the decoder's skipless 32x32 join through the join kernel with
    no skip channels, cuBLAS's projections, TF32 off) against the same
    pipeline on the CPU: scores and masks within 1e-4 of their largest
    value (the card's and oneDNN's sums run in other orders; the f32
    forward's own gap against float64 is ~1e-6 of it). One ingest, 5
    joins, 5 epilogues and 1 whole mask head a batch, every port kernel in
    the trace, no concat kernel."""
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.build import build_pair
    from cgs_tpu_torch.models.interop import init_torch_default
    from cgs_tpu_torch.pipeline import MaskPipeline

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    critic, masker = build_pair(Config(critic_arch="convnext_t"))
    gen = torch.Generator().manual_seed(11)
    for mod in (critic, masker):
        init_torch_default(mod, gen)
    with torch.no_grad():       # blocks that are no identity (gamma 1e-6)
        for name, t in critic.named_parameters():
            if name.endswith("layer_scale") or ".block.2." in name:
                t.uniform_(0.5, 1.5, generator=gen)
    params = {"critic": critic.state_dict(), "masker": masker.state_dict()}
    frames = torch.randint(0, 256, (64, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(12))
    want = MaskPipeline(critic, masker, params, batch_size=64,
                        device="cpu").run_device(frames)
    pipe = MaskPipeline(critic, masker, params, batch_size=64, device=dev)
    _build.launches.clear()
    got = pipe.run_device(frames.to(dev))
    assert dict(_build.launches) == {"normalize_u8": 1, "upsample2x": 5,
                                     "bias_act_pool": 5, "conv_mask_head": 1}
    for g, w in zip(got[:2], want[:2]):
        w = w.double()
        assert float((g.cpu().double() - w).abs().max()) \
            <= 1e-4 * float(w.abs().max())
    ops = _device_ops(lambda: pipe.run_device(frames.to(dev)))
    assert any("upsample_cat" in k for k in ops) and not _concats(ops), ops


@pytest.mark.cuda
def test_swin_fused_attention_against_the_reference(dev, monkeypatch):
    """The Swin V2-T pair's eval forward on the card at batch 64, its 12
    attention layers on the fused route (`models/swin.py:attend_fused`,
    PyTorch's memory-efficient attention, f32, TF32 off), against the
    benchmark's plain reference on the benchmark's seeded weights: the
    score, the taps and the mask within 2e-5 of their largest value (on
    the card the f32 forward of either route is ~1.5e-6 of it from
    float64; the reference sums in another order). A forward launches
    exactly 12 `fmha_cutlassF` kernels, one a layer, and no softmax
    kernel of the math path; the plain route (the scores written out)
    agrees with the fused one as closely."""
    import sys
    from pathlib import Path

    import cgs_tpu_torch.models.swin as swin
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.build import build_pair
    from cgs_tpu_torch.pipeline import MaskPipeline

    root = str(Path(__file__).resolve().parent.parent)
    if root not in sys.path:
        sys.path.insert(0, root)
    from portbench.lib import shapes_swin_v2_t
    from portbench.lib.manifest import load_json
    from portbench.reference import swin_v2_t as ref

    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    cfg = load_json(Path(root) / "portbench/configs/swin_v2_t.json")
    params = shapes_swin_v2_t.seeded_params(cfg, 2 ** 31 + 77, dev)
    critic, masker = build_pair(Config(critic_arch="swin_v2_t"))
    pipe = MaskPipeline(critic, masker, params, batch_size=64, device=dev)
    frames = torch.randint(0, 256, (64, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(13)
                           ).to(dev)
    pred, mask, _ = pipe.run_device(frames)
    want_pred, want_mask = ref.forward_masks(params, frames)

    def rel(a, b):
        a, b = a.double(), b.double()
        return float((a - b).abs().max() / b.abs().max())

    assert rel(pred, want_pred) <= 2e-5
    assert rel(mask[..., 0], want_mask) <= 2e-5
    x = frames.permute(0, 3, 1, 2).float() / 255.0
    model = pipe._members[0]["critic"]      # the pipeline's device copy
    xcl = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        _, taps = model(xcl, collect=True)
        with mock.patch.object(swin, "fused_route", lambda q: False):
            _, plain = model(xcl, collect=True)
    _, want_taps = ref.critic(params["critic"], x)
    for t, p, w in zip(taps[1:], plain[1:], want_taps[1:]):
        assert rel(t, w) <= 2e-5 and rel(p, w) <= 2e-5
    ops = _device_ops(lambda: pipe.run_device(frames))
    attn = {k: n for k, n in ops.items() if "fmha_cutlassF" in k}
    assert sum(attn.values()) == 12, ops
    assert not [k for k in ops if "softmax" in k.lower()], ops


def _staged_and_per_batch(pipe, frames):
    """(run's outputs, run_device's on each zero-padded batch, the
    outputs concatenated and cut to N), in one order: preds, masks or
    masks_u8, saliency, hard."""
    n, bs = frames.shape[0], pipe.batch
    out = pipe.run(frames)
    got = [out.preds, out.masks if pipe.wire == "f32" else out.masks_u8,
           out.saliency, out.hard]
    per = []
    for lo in range(0, n, bs):
        chunk = torch.zeros((bs,) + frames.shape[1:], dtype=torch.uint8)
        chunk[:min(bs, n - lo)] = torch.from_numpy(frames[lo:lo + bs])
        per.append(pipe.run_device(pipe.place_input(chunk.numpy())))
    want = [None if per[0][k] is None
            else torch.cat([p[k] for p in per])[:n].cpu().numpy()
            for k in range(3)]
    want.append(torch.cat([p[3] for p in per])[:n].cpu().numpy()
                if len(per[0]) > 3 else None)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{"wire": "u8", "hard_threshold": 0.5},
                                {"salience": True}])
def test_pipeline_staging_ring_on_the_card(dev, kw):
    """`run` streams 7 full batches and a ragged eighth through the
    ring's pinned slots and its copy streams: bit-equal to `run_device`
    on each padded batch, every batch counted as staged."""
    import numpy as np

    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.pipeline import MaskPipeline
    from cgs_tpu_torch.utils.profiling import counts

    critic, masker = Critic(dropout=0.0), UnetDecoder()
    params = {"critic": critic.state_dict(), "masker": masker.state_dict()}
    pipe = MaskPipeline(critic, masker, params, batch_size=1024, **kw)
    frames = torch.randint(0, 256, (7 * 1024 + 5, 64, 64, 3),
                           dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(6)
                           ).numpy()
    before = counts["pipeline.staged_batches"]
    got, want = _staged_and_per_batch(pipe, frames)
    assert counts["pipeline.staged_batches"] - before == 8
    for slot in pipe._ring.slots:
        assert slot.frames.is_pinned()
        assert slot.frames_dev.device == pipe.device
        assert all(o.is_pinned() for o in slot.outs if o is not None)
    for a, b in zip(got, want):
        assert (a is None) == (b is None)
        if a is not None:
            assert np.array_equal(a, b)

    # a forward that raises mid-call leaves the pipeline usable
    forward, calls = pipe.run_device, {"n": 0}

    def failing(u8):
        calls["n"] += 1
        if calls["n"] == 4:
            raise RuntimeError("forward failed")
        return forward(u8)

    pipe.run_device = failing
    with pytest.raises(RuntimeError, match="forward failed"):
        pipe.run(frames)
    del pipe.run_device
    again, _ = _staged_and_per_batch(pipe, frames)
    for a, b in zip(again, got):
        if a is not None:
            assert np.array_equal(a, b)


@pytest.mark.cuda
def test_pipeline_run_spans_wait_on_the_card(dev):
    """Under a profiler on the card, a 3-batch call blocks on the card
    at least once a batch (`cgs.pipeline.wait`: on a slot's upload before
    it is refilled, on its read-back before it is unstaged) and opens
    `cgs.pipeline.lead` and `cgs.pipeline.tail` once each."""
    from torch.profiler import ProfilerActivity, profile

    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.pipeline import MaskPipeline
    from cgs_tpu_torch.utils import profiling

    critic, masker = Critic(chfak=1, dropout=0.0), UnetDecoder(chfak=1)
    pipe = MaskPipeline(critic, masker, {"critic": critic.state_dict(),
                                         "masker": masker.state_dict()},
                        batch_size=256, wire="u8", hard_threshold=0.5)
    frames = torch.randint(0, 256, (2 * 256 + 100, 64, 64, 3),
                           dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(7)
                           ).numpy()
    pipe.run(frames)
    names = ["cgs.pipeline." + k for k in ("run", "lead", "forward",
                                           "tail", "wait")]
    before = {k: profiling.span_calls[k] for k in names}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pipe.run(frames)
    got = {k[13:]: profiling.span_calls[k] - before[k] for k in names}
    assert got["wait"] >= 3, got
    assert {k: got[k] for k in ("run", "lead", "forward", "tail")} == {
        "run": 1, "lead": 1, "forward": 3, "tail": 1}


def _ensemble_masks(dev, salience=False, heads=None):
    """(kernel-path outputs, plain-path outputs, launches per batch) of a
    3-member chfak-1 ensemble on 40 frames at batch 32 (2 batches). With
    `heads` = ([], []) the plain path runs the mask head's plain version
    too, and each path's mask head calls are recorded there; else both
    paths run the head's kernel."""
    import cgs_tpu_torch.models.epilogue as epilogue_mod
    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.pipeline as pipeline_mod
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.models.interop import init_torch_default
    from cgs_tpu_torch.pipeline import MaskPipeline

    critic, masker = Critic(dropout=0.0), UnetDecoder()
    gen = torch.Generator().manual_seed(3)
    members = [{name: {k: v.clone() for k, v in
                       init_torch_default(mod, gen).state_dict().items()}
                for name, mod in (("critic", critic), ("masker", masker))}
               for _ in range(3)]
    pipe = MaskPipeline(critic, masker, members, batch_size=32,
                        salience=salience, ensemble=True)
    frames = torch.randint(0, 256, (40, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(4))
    kernel_heads = plain_heads = contextlib.nullcontext()
    if heads is not None:
        kernel_heads = _recording_heads(heads[0])
        plain_heads = _recording_heads(heads[1], plain=True)
    _build.launches.clear()
    with kernel_heads:
        out = pipe.run(frames.numpy())
    per_batch = {k: v / 2 for k, v in _build.launches.items()}
    with mock.patch.object(pipeline_mod, "normalize_u8",
                           normalize_u8_plain), \
            mock.patch.object(upsample_mod, "upcat_fwd", upcat_plain), \
            mock.patch.object(epilogue_mod, "bias_act_pool",
                              bias_act_pool_plain), \
            plain_heads:
        plain = pipe.run(frames.numpy())
    return out, plain, per_batch, frames.numpy()


def _ensemble_mean(calls, members, n):
    """The masks an ensemble pipeline makes from its recorded head calls:
    each batch's members summed in order in f32, divided by their count,
    the batches joined and cut to n rows, NHWC."""
    means = []
    for lo in range(0, len(calls), members):
        mean = calls[lo][1].clone()
        for _, mask in calls[lo + 1:lo + members]:
            mean.add_(mask)
        means.append(mean.div_(float(members)))
    return torch.cat(means)[:n, ..., None].cpu().numpy()


@pytest.mark.cuda
def test_ensemble_kernel_path_equals_plain_path(dev):
    """Preds and saliency bit-equal to the plain path's; each member's
    mask head within twice `conv_mask_head_plain`'s gap to float64, and the
    masks the mean of the members' heads on either path."""
    import numpy as np

    heads = ([], [])
    out, plain, per_batch, _ = _ensemble_masks(dev, salience=True,
                                               heads=heads)
    # the saliency's critic records its input gradient: each member's
    # decoder alone takes the fused epilogues and the mask head
    assert per_batch == {"normalize_u8": 1, "upsample2x": 15,
                         "bias_act_pool": 15, "conv_mask_head": 3}
    assert (out.preds == plain.preds).all()
    assert (out.saliency == plain.saliency).all()
    assert len(heads[0]) == 6
    _heads_within_twice_the_plain_gap(*heads)
    for got, calls in ((out.masks, heads[0]), (plain.masks, heads[1])):
        assert np.array_equal(got, _ensemble_mean(calls, 3, len(got)))


@pytest.mark.cuda
def test_densecrf_on_kernel_masks_equals_plain(dev):
    from cgs_tpu_torch.eval.crf import DenseCRF

    out, plain, _, frames = _ensemble_masks(dev)
    crf = DenseCRF()
    refined = crf(frames, out.masks)
    assert refined.shape == (40, 64, 64)
    assert (refined == crf(frames, plain.masks)).all()


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
    gradient in both memory formats; at batch 8192 too."""
    for n, h, w in [(0, 64, 64), (7, 5, 9), (64, 64, 64), (3, 64, 65),
                    (BATCH, 64, 64)]:
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
    """The fused pair at every join, the ragged shapes, Cs = 0 and N = 0,
    at N = 3 (inputs and gradient also off a 16-byte boundary) and 128,
    with the concat gradient in both memory formats cuDNN's dgrad may
    hand over, with and without the skip's gradient; the decoder joins'
    forward at the masker step's batch and at the serve batch."""
    for cs, cu, h, w, f in JOINS:
        for n in (3, 0, 128):
            skip = torch.rand((n, f * h, f * w, cs), device=dev).to(dtype)
            x = torch.rand((n, h, w, cu), device=dev).to(dtype)
            ins = [(skip, x)]
            if n == 3:
                ins.append((_unaligned(skip), _unaligned(x)))
            _build.launches.clear()
            for sk, xx in ins:
                assert _same([upcat_fwd(sk, xx, f)],
                             [upcat_plain(sk, xx, f)]), (cs, cu, h, w, f, n)
            g = torch.rand((n, f * h, f * w, cs + cu), device=dev).to(dtype)
            nchw = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            grads = [g, nchw] + ([_unaligned(g)] if n == 3 else [])
            for gg in grads:
                for need in (True, False):
                    got = upcat_bwd(gg, cs, f, need)
                    want = upcat_bwd_plain(gg, cs, f, need)
                    assert (got[0] is None) == (want[0] is None)
                    assert _same([t for t in got if t is not None],
                                 [t for t in want if t is not None]), (
                        cs, cu, h, w, f, n, gg.stride(), need)
            assert dict(_build.launches) == (
                {"upsample2x": len(ins), "upsample2x_bwd": 2 * len(grads)}
                if n else {})
    for n in (MASKER_N, BATCH):
        for cs, cu, h, w, f in DECODER_JOINS:
            skip = torch.rand((n, f * h, f * w, cs), device=dev).to(dtype)
            x = torch.rand((n, h, w, cu), device=dev).to(dtype)
            assert _same([upcat_fwd(skip, x, f)],
                         [upcat_plain(skip, x, f)]), (cs, cu, h, w, f, n)
            del skip, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_up_first_upcat_and_bwd_bit_equal(dev, dtype):
    """The up-first join of the zoo U-Nets, cat([up_f(x), skip]), at
    zoo.Unet's chfak-5 joins (N = 3, the masker step's 64 and the serve
    batch) and the ragged shapes, forward and backward (both memory
    formats of the gradient, and at N = 3 one off a 16-byte boundary,
    with and without the skip's gradient), bit-equal to its plain
    version."""
    cases = [(n, *j) for n in (3, MASKER_N, BATCH) for j in UNET_JOINS]
    cases += [(3, *j) for j in RAGGED_JOINS]
    for n, cs, cu, h, w, f in cases:
        skip = torch.rand((n, f * h, f * w, cs), device=dev).to(dtype)
        x = torch.rand((n, h, w, cu), device=dev).to(dtype)
        _build.launches.clear()
        assert _same([upcat_fwd(skip, x, f, up_first=True)],
                     [upcat_plain(skip, x, f, up_first=True)])
        del skip, x
        g = torch.rand((n, f * h, f * w, cs + cu), device=dev).to(dtype)
        nchw = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        grads = [g, nchw] + ([_unaligned(g)] if n == 3 else [])
        for gg in grads:
            for need in (True, False):
                got = upcat_bwd(gg, cs, f, need, up_first=True)
                want = upcat_bwd_plain(gg, cs, f, need, up_first=True)
                assert (got[0] is None) == (want[0] is None)
                assert _same([t for t in got if t is not None],
                             [t for t in want if t is not None]), (
                    n, cs, cu, h, w, f, gg.stride(), need)
                del got, want
        del g, nchw, grads
        assert dict(_build.launches) == {"upsample2x": 1,
                                         "upsample2x_bwd": 4 + 2 * (n == 3)}


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


def _handed_layout(t, nhwc=False):
    """Whether a gradient a kernel is handed is dense in one of the two
    memory formats its card test covers (NCHW or channels_last; for an
    NHWC view, its NCHW permutation)."""
    nchw = t.permute(0, 3, 1, 2) if nhwc else t
    return nchw.is_contiguous() or nchw.is_contiguous(
        memory_format=torch.channels_last)


@pytest.mark.cuda
@pytest.mark.parametrize("chfak, k, dropout", [(1, 8, 0.0), (5, 32, 0.5)])
def test_masker_step_kernel_path_equals_plain_path(dev, monkeypatch, chfak,
                                                   k, dropout):
    """One masker step (`train/steps.py:masker_step`, default flags live
    and inject, frames gathered from uint8 banks by index and shifted),
    at the reference's width and at the paper's with K = 32 (2K = 64),
    its loss terms and gradients, kernel path against the plain
    versions patched in, bit-equal under deterministic cuDNN (the
    kernels are bit-equal to their plain versions; both runs draw the
    same dropout masks); the terms finite; one ingest launch for the
    step's frames and labels, the plain path launching nothing;
    `merge_pair_bwd` asked for dz alone (the frames need no gradient);
    every gradient handed to `merge_pair_bwd` and the joins' backward
    in a layout their card tests cover; every decoder gradient non-zero
    (an upsample without a gradient would zero them). The optimizer has
    lr 0, so both runs start from the same weights and the gradients
    stay in .grad."""
    import cgs_tpu_torch.ops.merge as merge_mod
    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.train.losses as losses_mod
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.train.steps import StepRng, masker_step

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = Config(chfak=chfak, dropout=dropout).derive()
    assert cfg.live and cfg.inject
    models = {"critic": Critic(chfak=chfak, dropout=dropout),
              "masker": UnetDecoder(chfak=chfak)}
    for m in models.values():
        m.to(dev, memory_format=torch.channels_last)
    opt = torch.optim.SGD([p for m in models.values()
                           for p in m.parameters()], lr=0.0)
    xpos, xneg = (torch.randint(0, 256, (24, 64, 64, 3), dtype=torch.uint8,
                                device=dev) for _ in range(2))
    ypos, yneg = torch.rand(24, device=dev), torch.rand(24, device=dev)
    h, l, c = (torch.randint(0, 24, (n,), device=dev) for n in (k, k, 2 * k))
    a = [Segment(xpos, h, labels=ypos), Segment(xneg, l, labels=yneg)]

    def run():
        terms = masker_step(cfg, models, opt, a, Segment(xneg, c),
                            StepRng.seeded(0, dev))
        return ([float(t) for t in terms],
                [p.grad.clone() for m in models.values()
                 for p in m.parameters()])

    needs, layouts = [], []

    def spy_mbwd(a, b, z, g, need):
        needs.append(tuple(need))
        layouts.append(_handed_layout(g))
        return merge_pair_bwd(a, b, z, g, need)

    def spy_ubwd(g, cs, factor=2, need_skip=True, up_first=False):
        layouts.append(_handed_layout(g, nhwc=True))
        return upcat_bwd(g, cs, factor, need_skip, up_first)

    _build.launches.clear()
    with mock.patch.object(merge_mod, "merge_pair_bwd", spy_mbwd), \
            mock.patch.object(upsample_mod, "upcat_bwd", spy_ubwd):
        terms, grads = run()
    assert dict(_build.launches) == {
        "normalize_u8": 1, "merge_pair": 1, "merge_pair_bwd": 1,
        "upsample2x": 5, "upsample2x_bwd": 5}
    assert needs == [(False, False, True)]
    assert len(layouts) == 6 and all(layouts), layouts
    assert all(math.isfinite(t) for t in terms), terms
    _build.launches.clear()
    with mock.patch.object(losses_mod, "gather_normalize_u8",
                           gather_normalize_u8_plain), \
            mock.patch.object(merge_mod, "merge_pair", merge_pair_plain), \
            mock.patch.object(merge_mod, "merge_pair_bwd",
                              merge_pair_bwd_plain), \
            mock.patch.object(upsample_mod, "upcat_fwd", upcat_plain), \
            mock.patch.object(upsample_mod, "upcat_bwd", upcat_bwd_plain):
        p_terms, p_grads = run()
    assert not _build.launches
    assert terms == p_terms
    for g, pg in zip(grads, p_grads):
        assert torch.equal(_bits(g), _bits(pg))
    for name, p in models["masker"].named_parameters():
        assert bool(p.grad.abs().sum() > 0), name


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_train_chunks_finite_and_steps_run_no_concat(dev, dtype):
    """At the paper's width (dropout 0.5): a few `critic_chunk` and
    `masker_chunk` steps (the masker's through its captured graph) give
    finite losses, and one `critic_step` and one `masker_step` run no
    concat kernel (the ingest writes the critic's joined batch, the
    merges the joined merge batch, the joins their concat)."""
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.train.contrastive import sample_index_stacks
    from cgs_tpu_torch.train.loops import critic_chunk, masker_chunk
    from cgs_tpu_torch.train.steps import (
        StepRng, critic_step, make_optimizer, masker_step,
    )

    cfg = Config(chfak=5, dropout=0.5).derive()
    models = {"critic": Critic(chfak=5, dropout=0.5, compute_dtype=dtype),
              "masker": UnetDecoder(chfak=5, compute_dtype=dtype)}
    for m in models.values():
        m.to(dev, memory_format=torch.channels_last).train()
    bank = torch.randint(0, 256, (256, 64, 64, 3), dtype=torch.uint8,
                         device=dev)
    y = torch.rand(256, device=dev)
    nrng, rng = np.random.default_rng(0), StepRng.seeded(0, dev)

    copt = make_optimizer({"critic": models["critic"]})
    idx = nrng.integers(0, 256, (3, MASKER_N))
    losses = critic_chunk(cfg, models["critic"], copt, bank, y, idx, rng)
    assert bool(torch.isfinite(losses).all()), losses
    x = Segment(bank, torch.from_numpy(idx[0]).to(dev), labels=y)
    ops = _device_ops(lambda: critic_step(cfg, models["critic"], copt, x,
                                          rng))
    assert any("ingest_" in k for k in ops) and not _concats(ops), ops

    mopt = make_optimizer(models)
    xa, ya, xb, yb = bank[:128], y[:128], bank[128:], y[128:]
    h, l, c = sample_index_stacks(nrng, 128, 128, 3, MASKER_N // 2)
    terms = masker_chunk(cfg, models, mopt, xa, ya, xb, yb, h, l, c, rng)
    assert bool(torch.isfinite(terms).all()), terms
    h0, l0, c0 = (torch.from_numpy(i[0].astype(np.int64)).to(dev)
                  for i in (h, l, c))
    a = [Segment(xa, h0, labels=ya), Segment(xb, l0, labels=yb)]
    ops = _device_ops(lambda: masker_step(cfg, models, mopt, a,
                                          Segment(xb, c0), rng))
    assert any("upsample_cat" in k for k in ops) and not _concats(ops), ops


@pytest.fixture
def two_cards():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices: a launch with the current "
                    "device set to another card than its tensors'")
    return torch.device("cuda", 1)


@pytest.mark.cuda
def test_launch_lands_on_the_tensors_card(two_cards):
    """Each wrapper launches on its tensors' card whatever the calling
    thread's current device is (cuda:0 here, tensors on cuda:1), as a
    rank whose current device was never set, or the serve completion
    thread, calls them."""
    d1 = two_cards
    gen = torch.Generator().manual_seed(0)
    x = torch.randint(0, 256, (8, 64, 64, 3), dtype=torch.uint8,
                      generator=gen)
    a, b = (torch.rand(4, 3, 64, 64, generator=gen).to(
        memory_format=torch.channels_last) for _ in range(2))
    z = torch.rand(4, 1, 64, 64, generator=gen)
    g = torch.rand(8, 3, 64, 64, generator=gen)
    up = torch.rand(2, 4, 4, 8, generator=gen)
    gup = torch.rand(2, 8, 8, 8, generator=gen)
    masks = torch.rand(8, 4096, generator=gen)
    gt = torch.rand(8, 4096, generator=gen) > 0.5
    with torch.cuda.device(0):
        got = {
            "normalize_u8": normalize_u8(x.to(d1)),
            "merge_pair": merge_pair(a.to(d1), b.to(d1), z.to(d1)),
            "merge_pair_bwd": merge_pair_bwd(a.to(d1), b.to(d1), z.to(d1),
                                             g.to(d1))[2],
            "upsample2x": upsample2x(up.to(d1)),
            "upsample2x_bwd": upsample2x_bwd(gup.to(d1)),
            "threshold_iou": torch.stack(threshold_iou(
                masks.to(d1), gt.to(d1), 0.5)),
        }
        torch.cuda.synchronize(d1)
    want = {
        "normalize_u8": normalize_u8_plain(x),
        "merge_pair": merge_pair_plain(a, b, z),
        "merge_pair_bwd": merge_pair_bwd_plain(a, b, z, g)[2],
        "upsample2x": upsample2x_plain(up),
        "upsample2x_bwd": upsample2x_bwd_plain(gup),
        "threshold_iou": torch.stack(threshold_iou_plain(masks, gt, 0.5)),
    }
    for name, t in got.items():
        assert t.device == d1, name
        assert torch.equal(t.cpu(), want[name]), name
