"""PyTorch port on the card: each CUDA kernel against its plain
version, the pipeline's and the masker step's kernel path against
their plain paths, and the upsample gradient through a `torch.cat`.

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
    merge_pair, merge_pair_bwd, merge_pair_bwd_plain, merge_pair_plain,
    normalize_u8, normalize_u8_plain, threshold_iou, threshold_iou_plain,
)
from cgs_tpu_torch.ops.upsample import (
    upsample2x, upsample2x_bwd, upsample2x_bwd_plain, upsample2x_plain,
)

STEPS = [(1, 1, 160), (2, 2, 160), (4, 4, 80), (8, 8, 40), (16, 16, 40),
         (32, 32, 40), (1, 1, 32), (2, 2, 32), (4, 4, 16), (8, 8, 8),
         (16, 16, 8), (32, 32, 8), (3, 5, 7), (5, 9, 3)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


@pytest.mark.cuda
def test_normalize_u8_bit_equal(dev):
    for shape in [(0, 12288), (7, 12288), (1001, 12288), (3, 4097)]:
        u8 = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev)
        assert torch.equal(_bits(normalize_u8(u8)),
                           _bits(normalize_u8_plain(u8))), shape
    # a buffer that is not 16-byte aligned takes the scalar path
    u8 = torch.randint(0, 256, (4099,), dtype=torch.uint8, device=dev)[3:]
    assert torch.equal(normalize_u8(u8), normalize_u8_plain(u8))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_upsample2x_bit_equal(dev, dtype):
    for h, w, c in STEPS:
        x = torch.rand((3, h, w, c), device=dev).to(dtype)
        assert torch.equal(_bits(upsample2x(x)),
                           _bits(upsample2x_plain(x))), (h, w, c)


@pytest.mark.cuda
def test_threshold_iou_exact(dev):
    for shape in [(0, 4096), (5, 4096), (2450, 4096), (3, 4095)]:
        m = torch.rand(shape, device=dev)
        g = torch.rand(shape, device=dev) > 0.7
        got = [int(v) for v in threshold_iou(m, g, 0.05)]
        assert got == [int(v) for v in threshold_iou_plain(m, g, 0.05)]


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
    import cgs_tpu_torch.models.decoder as decoder_mod
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
    assert dict(_build.launches) == {"normalize_u8": 1, "upsample2x": 6}
    with mock.patch.object(pipeline_mod, "normalize_u8",
                           normalize_u8_plain), \
            mock.patch.object(decoder_mod, "upsample2x", upsample2x_plain):
        ppred, pmask, _ = pipe.run_device(frames)
    torch.testing.assert_close(mask, pmask, atol=1e-5, rtol=0)
    torch.testing.assert_close(pred, ppred, atol=1e-5, rtol=0)


def _frames(dev, n, h=64, w=64, c=3):
    """NCHW float32 stored channels_last, as the critic takes frames."""
    return torch.rand((n, h, w, c), device=dev).permute(0, 3, 1, 2)


def _same(got, want):
    return all(g.shape == w.shape and torch.equal(_bits(g), _bits(w))
               for g, w in zip(got, want))


@pytest.mark.cuda
def test_merge_pair_and_bwd_bit_equal(dev):
    for n, h, w in [(0, 64, 64), (7, 5, 9), (64, 64, 64)]:
        a, b, z = _frames(dev, n, h, w), _frames(dev, n, h, w), \
            _frames(dev, n, h, w, 1)
        _build.launches.clear()
        assert _same(merge_pair(a, b, z), merge_pair_plain(a, b, z))
        gr, gi = _frames(dev, n, h, w), _frames(dev, n, h, w)
        for fmt in (torch.channels_last, torch.contiguous_format):
            g_r = gr.contiguous(memory_format=fmt)
            g_i = gi.contiguous(memory_format=fmt)
            assert _same(merge_pair_bwd(a, b, z, g_r, g_i),
                         merge_pair_bwd_plain(a, b, z, g_r, g_i)), (n, fmt)
        launched = 1 if n else 0
        assert dict(_build.launches) == (
            {"merge_pair": 1, "merge_pair_bwd": 2} if launched else {})
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
def test_up2_gradient_through_cat_equals_plain(dev, dtype):
    """A decoder up-step as the masker step runs it: up2, torch.cat
    with a skip feature, a conv. The kernel path's input gradient
    against autograd of the plain version (repeat_interleave's own
    backward sums in another order, and in bf16 rounds after each of
    its two pair sums where the kernel rounds once: 1e-6 in f32, two
    bf16 ulps in bf16)."""
    from cgs_tpu_torch.models.decoder import up2

    torch.manual_seed(0)
    conv = torch.nn.Conv2d(80, 40, 3, padding=1).to(
        dev, dtype, memory_format=torch.channels_last)
    skip = torch.rand(4, 40, 32, 32, device=dev, dtype=dtype).contiguous(
        memory_format=torch.channels_last)
    x0 = torch.rand(4, 40, 16, 16, device=dev, dtype=dtype).contiguous(
        memory_format=torch.channels_last)

    def grad(up):
        x = x0.clone().requires_grad_()
        y = conv(torch.cat([skip, up(x)], dim=1))
        y.float().square().sum().backward()
        return y.detach(), x.grad

    _build.launches.clear()
    y_k, g_k = grad(up2)
    assert dict(_build.launches) == {"upsample2x": 1, "upsample2x_bwd": 1}
    y_p, g_p = grad(lambda t: upsample2x_plain(
        t.permute(0, 2, 3, 1)).permute(0, 3, 1, 2))
    assert torch.equal(y_k, y_p)
    tol = 1e-6 if dtype == torch.float32 else 2 ** -6
    torch.testing.assert_close(g_k.float(), g_p.float(), atol=tol,
                               rtol=tol)
    assert bool(g_k.abs().sum() > 0)


@pytest.mark.cuda
def test_masker_step_kernel_path_equals_plain_path(dev, monkeypatch):
    """One masker step's loss terms and gradients, kernel path against
    the plain versions patched in, bit-equal under deterministic cuDNN
    (the kernels are bit-equal to their plain versions); every decoder
    gradient is non-zero (an upsample without a gradient would zero
    them)."""
    import cgs_tpu_torch.ops.merge as merge_mod
    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.train.losses as losses_mod
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    cfg = Config(dropout=0.0, shift=0).derive()
    models = {"critic": Critic(dropout=0.0), "masker": UnetDecoder()}
    for m in models.values():
        m.to(dev, memory_format=torch.channels_last)
    a_u8, b_u8 = (torch.randint(0, 256, (16, 64, 64, 3), dtype=torch.uint8,
                                device=dev) for _ in range(2))
    y = torch.rand(16, device=dev)

    def run():
        for m in models.values():
            m.zero_grad(set_to_none=True)
        loss, aux = losses_mod.build_masker_loss(cfg)(
            models, losses_mod.ingest(a_u8), y, losses_mod.ingest(b_u8))
        loss.backward()
        return ([float(aux[t].detach()) for t in
                 ("loss", "replace", "inject", "norm", "critic")],
                [p.grad.clone() for m in models.values()
                 for p in m.parameters()])

    _build.launches.clear()
    terms, grads = run()
    assert dict(_build.launches) == {
        "normalize_u8": 2, "merge_pair": 1, "merge_pair_bwd": 1,
        "upsample2x": 6, "upsample2x_bwd": 6}
    with mock.patch.object(losses_mod, "normalize_u8", normalize_u8_plain), \
            mock.patch.object(merge_mod, "merge_pair", merge_pair_plain), \
            mock.patch.object(merge_mod, "merge_pair_bwd",
                              merge_pair_bwd_plain), \
            mock.patch.object(upsample_mod, "upsample2x_fwd",
                              upsample2x_plain), \
            mock.patch.object(upsample_mod, "upsample2x_bwd",
                              upsample2x_bwd_plain):
        p_terms, p_grads = run()
    assert terms == p_terms
    for g, pg in zip(grads, p_grads):
        assert torch.equal(_bits(g), _bits(pg))
    for name, p in models["masker"].named_parameters():
        assert bool(p.grad.abs().sum() > 0), name
