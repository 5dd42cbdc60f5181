"""PyTorch port: the kernel modules (`ops/kernels.py`, `ops/upsample.py`).

On the CPU each wrapper runs its plain version, which is held here
against the JAX function (the Pallas kernels in interpret mode, as the
JAX package's own tests run them): bit-equal for the ingest and the
upsample, exactly equal counts for threshold_iou. The CUDA kernels
themselves are held against the plain versions on the card by
tests/test_torch_port_cuda.py (marked `cuda`, skipped without a card).
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from cgs_tpu.models.decoder import upsample2x as jnp_upsample2x
from cgs_tpu.ops.pallas_kernels import normalize_u8 as jax_normalize_u8
from cgs_tpu.ops.pallas_kernels import threshold_iou as jax_threshold_iou
from cgs_tpu.ops.pallas_upsample import (
    supports_pallas_upsample, upsample2x_pallas,
)
from cgs_tpu_torch.ops import _build
from cgs_tpu_torch.ops.kernels import (
    INV255, IOU_MAX_BLOCKS, MAX_SEEDS, MAX_SEGMENTS, normalize_u8, normalize_u8_plain, threshold_iou,
    threshold_iou_plain,
)
from cgs_tpu_torch.ops.upsample import upsample2x, upsample2x_plain

# the decoder's six up-steps (B, H, W, C) at chfak 5 and chfak 1
CHFAK5_STEPS = [(1, 1, 160), (2, 2, 160), (4, 4, 80), (8, 8, 40),
                (16, 16, 40), (32, 32, 40)]
CHFAK1_STEPS = [(1, 1, 32), (2, 2, 32), (4, 4, 16), (8, 8, 8),
                (16, 16, 8), (32, 32, 8)]


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32).view(np.uint32)


# -- normalize_u8 --------------------------------------------------------

def test_inv255_is_the_f32_reciprocal():
    assert np.float32(INV255).view(np.uint32) == 0x3B808081


@pytest.mark.parametrize("shape,block_n", [((16, 12288), 128),
                                           ((130, 128), 64),   # ragged N
                                           ((0, 128), 128)])
def test_normalize_u8_bit_equal_to_jax(shape, block_n):
    x = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    ref = np.asarray(jax_normalize_u8(jnp.asarray(x), block_n=block_n))
    out = normalize_u8(torch.from_numpy(x)).numpy()
    assert out.shape == ref.shape and out.dtype == np.float32
    np.testing.assert_array_equal(_bits(out), _bits(ref))


def test_normalize_u8_every_byte_value_any_shape():
    x = torch.arange(256, dtype=torch.uint8).reshape(2, 2, 64)
    out = normalize_u8(x)
    ref = np.arange(256, dtype=np.uint8).astype(np.float32) * np.float32(
        1 / 255)
    np.testing.assert_array_equal(_bits(out.numpy().ravel()), _bits(ref))
    assert out.shape == x.shape
    with pytest.raises(ValueError, match="uint8"):
        normalize_u8(x.float())


# -- upsample2x ----------------------------------------------------------

@pytest.mark.parametrize("shape", [(4, 32, 32, 8), (3, 16, 16, 8),
                                   (2, 8, 8, 16), (2, 4, 64, 2)])
def test_upsample_bit_equal_to_pallas(shape):
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    assert supports_pallas_upsample(jnp.asarray(x))
    ref = np.asarray(upsample2x_pallas(jnp.asarray(x)))
    np.testing.assert_array_equal(upsample2x(torch.from_numpy(x)).numpy(),
                                  ref)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("step", CHFAK5_STEPS + CHFAK1_STEPS)
def test_upsample_bit_equal_to_jnp_path(step, dtype):
    """Every decoder step at both widths; the chfak-5 ones are shapes
    the Pallas kernel does not take (W*C % 128 or W*C > 512)."""
    x = np.random.default_rng(1).random((2,) + step, dtype=np.float32)
    jx = jnp.asarray(x, dtype=jnp.dtype(dtype))
    ref = np.asarray(jnp_upsample2x(jx).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    out = upsample2x(tx)
    assert out.dtype == tx.dtype and out.shape == (2, 2 * step[0],
                                                   2 * step[1], step[2])
    np.testing.assert_array_equal(out.float().numpy(), ref)


def test_upsample_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="contiguous NHWC"):
        upsample2x(torch.zeros(2, 8, 4, 4).permute(0, 2, 3, 1)
                   .contiguous().permute(0, 2, 1, 3))
    with pytest.raises(ValueError, match="dtype"):
        upsample2x(torch.zeros(2, 4, 4, 8, dtype=torch.float64))
    with pytest.raises(ValueError, match="B, H, W, C"):
        upsample2x(torch.zeros(4, 4, 8))


# -- threshold_iou -------------------------------------------------------

@pytest.mark.parametrize("gt_dtype", [bool, np.uint8])
def test_threshold_iou_equals_jax(gt_dtype):
    rng = np.random.default_rng(2)
    n, f = 300, 4096
    masks = rng.random((n, f)).astype(np.float32)
    masks[0, :64] = np.float32(0.05)       # ties: strict > drops them
    gt = (rng.random((n, f)) > 0.7).astype(gt_dtype)
    ji, ju = jax_threshold_iou(jnp.asarray(masks), jnp.asarray(gt), 0.05)
    ti, tu = threshold_iou(torch.from_numpy(masks), torch.from_numpy(gt),
                           0.05)
    assert (int(ti), int(tu)) == (int(ji), int(ju))
    hard = masks > np.float32(0.05)
    g = gt > 0
    assert (int(ti), int(tu)) == (int(np.sum(hard & g)),
                                  int(np.sum(hard | g)))
    assert ti.dtype == torch.int64


def test_threshold_iou_empty_and_bad_inputs():
    e = torch.zeros(0, 128)
    ji, ju = jax_threshold_iou(jnp.zeros((0, 128)), jnp.zeros((0, 128),
                                                              bool), 0.5)
    ti, tu = threshold_iou(e, torch.zeros(0, 128, dtype=torch.bool), 0.5)
    assert (int(ti), int(tu)) == (int(ji), int(ju)) == (0, 0)
    with pytest.raises(ValueError, match="shape"):
        threshold_iou(torch.zeros(2, 4), torch.zeros(2, 5, dtype=torch.bool),
                      0.5)
    with pytest.raises(ValueError, match="float32"):
        threshold_iou(torch.zeros(2, 4, dtype=torch.float64),
                      torch.zeros(2, 4, dtype=torch.bool), 0.5)


def test_cpu_calls_run_the_plain_versions_and_launch_nothing():
    _build.launches.clear()
    x = torch.randint(0, 256, (4, 48), dtype=torch.uint8)
    assert torch.equal(normalize_u8(x), normalize_u8_plain(x))
    y = torch.rand(2, 4, 4, 8)
    assert torch.equal(upsample2x(y), upsample2x_plain(y))
    m, g = torch.rand(4, 16), torch.rand(4, 16) > 0.5
    assert [int(v) for v in threshold_iou(m, g, 0.3)] == [
        int(v) for v in threshold_iou_plain(m, g, 0.3)]
    assert sum(_build.launches.values()) == 0


# -- the build and binding ----------------------------------------------

@pytest.mark.parametrize("name", sorted(_build.SIGNATURES))
def test_binding_matches_the_c_entry_points(name):
    """Each ctypes signature names an `extern "C"` entry of its source
    with as many parameters; a pointer bound as an int would be cut."""
    src = (_build.CSRC / f"{name}.cu").read_text()
    for fn, argtypes in _build.SIGNATURES[name].items():
        m = re.search(r'extern "C" int ' + fn + r"\(([^)]*)\)", src)
        assert m, f"{fn} missing from {name}.cu"
        params = [p.strip() for p in m.group(1).split(",")]
        assert len(params) == len(argtypes)
        for p, t in zip(params, argtypes):
            want = "void*" if t is _build.ctypes.c_void_p else {
                _build.ctypes.c_int64: "int64_t",
                _build.ctypes.c_float: "float"}[t]
            assert p.replace("const ", "").startswith(want), (fn, p, want)
    if name == "normalize_u8":     # the segments one launch takes
        assert int(re.search(r"kMaxSeg = (\d+);", src).group(1)) == \
            MAX_SEGMENTS
        assert int(re.search(r"kMaxSeeds = (\d+);", src).group(1)) == \
            MAX_SEEDS
    if name == "threshold_iou":    # the slots of the wrapper's scratch
        assert int(re.search(r"kMaxBlocks = (\d+);", src).group(1)) == \
            IOU_MAX_BLOCKS
    assert "-gencode" in _build.NVCC_FLAGS and \
        "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS

