"""PyTorch port on the card: each CUDA kernel against its plain
version, and the pipeline's kernel path against its plain path.

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
    normalize_u8, normalize_u8_plain, threshold_iou, threshold_iou_plain,
)
from cgs_tpu_torch.ops.upsample import upsample2x, upsample2x_plain

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
