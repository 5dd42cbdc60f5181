"""PyTorch port: the decoder's fused upsample-into-concat
(`ops/upsample.py`: `upcat_plain`, `upcat_bwd_plain`, `UpCat`,
`up_cat`) against the JAX decoder's join
`jnp.concatenate([skip, upsample2x(x)], -1)` and its `jax.vjp`, and the
up-first join of the zoo U-Nets (`cgs_tpu/models/zoo.py:316-322`),
`jnp.concatenate([upsample2x(u), skip], -1)`, and its `jax.vjp`.
`upsample2x` is `cgs_tpu/models/decoder.py:upsample2x`, applied twice
for the x4 join, or `upsample2x_pallas` in interpret mode where
`supports_pallas_upsample` takes the shape.

Inputs are made from numpy seeds at batch 2, at the five joins of
chfak 1 and of chfak 5, in f32 and bf16. On the CPU the wrappers run
the plain versions; the CUDA kernels are held to them on the card by
tests/test_torch_port_cuda.py.

Tolerances: the forward and the skip's gradient are copies, so they are
exact. dx is a sum of 4 (x2) or 16 (x4) terms: within 1e-6 of JAX in
f32 (JAX may add in another order), and in bf16 within 2**-7 relative
of JAX's f32 gradient of the same bf16 values (the port rounds to bf16
once per x2 level: two roundings of at most 2**-9 each, on positive
terms). Against the port's own plain version it is exact.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cgs_tpu.models.decoder import upsample2x as jnp_upsample2x
from cgs_tpu.ops.pallas_upsample import (
    supports_pallas_upsample, upsample2x_pallas,
)
import cgs_tpu_torch.ops.upsample as upsample_mod
from cgs_tpu_torch.ops import _build
from cgs_tpu_torch.ops.upsample import (
    LEVELS, up_cat, upcat_bwd, upcat_bwd_plain, upcat_fwd, upcat_plain,
    upsample2x, upsample2x_bwd,
)

# the decoder's skip joins: (skip channels Cs, upsampled channels Cu,
# input H = W, factor), from the decoder's widths
JOINS = {
    "chfak5": {"in3": (80, 160, 1, 4), "in2": (40, 80, 4, 2),
               "in1": (40, 40, 8, 2), "in0": (40, 40, 16, 2),
               "head": (3, 40, 32, 2)},
    "chfak1": {"in3": (16, 32, 1, 4), "in2": (8, 16, 4, 2),
               "in1": (8, 8, 8, 2), "in0": (8, 8, 16, 2),
               "head": (3, 8, 32, 2)},
}
CASES = [(w, j) for w in JOINS for j in JOINS[w]]
# zoo.Unet's joins at chfak 5, upsampled channels first: (skip channels
# Cs, upsampled channels Cu, input H = W, factor); the last is the
# quirk join cat([up(u0), up(u0)]), its skip the upsampled u0
UNET_JOINS = {"dec3": (80, 80, 4, 2), "dec2": (40, 40, 8, 2),
              "dec1": (40, 40, 16, 2), "dec0": (40, 40, 32, 2)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_join(skip, x, factor):
    for _ in range(LEVELS[factor]):
        x = (upsample2x_pallas(x) if supports_pallas_upsample(x)
             else jnp_upsample2x(x))
    return jnp.concatenate([skip, x], -1)


def _inputs(width, join, dtype, seed):
    """skip, x and the output's gradient g, NHWC numpy f32 holding
    values of `dtype`."""
    cs, cu, h, f = (UNET_JOINS if width == "unet5" else JOINS[width])[join]
    rng = np.random.default_rng(seed)
    out = []
    for shape in [(2, f * h, f * h, cs), (2, h, h, cu),
                  (2, f * h, f * h, cs + cu)]:
        v = torch.from_numpy(rng.random(shape, dtype=np.float32))
        out.append(v.to(TORCH[dtype]).float().numpy())
    return out, f


def _nchw(v, dtype):
    """numpy NHWC -> NCHW stored channels_last, in `dtype`."""
    return torch.from_numpy(v).to(TORCH[dtype]).permute(0, 3, 1, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,join", CASES)
def test_upcat_forward_equals_jax(width, join, dtype):
    (skip, x, _), f = _inputs(width, join, dtype, seed=0)
    ref = np.asarray(_jax_join(jnp.asarray(skip, dtype),
                               jnp.asarray(x, dtype), f).astype(jnp.float32))
    ts, tx = (torch.from_numpy(v).to(TORCH[dtype]) for v in (skip, x))
    out = upcat_plain(ts, tx, f)
    assert out.dtype == TORCH[dtype] and out.is_contiguous()
    np.testing.assert_array_equal(out.float().numpy(), ref)
    nc = up_cat(_nchw(skip, dtype), _nchw(x, dtype), f)
    assert nc.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(nc.permute(0, 2, 3, 1), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("width,join", CASES)
def test_upcat_backward_equals_jax_vjp(width, join, dtype):
    (skip, x, g), f = _inputs(width, join, dtype, seed=1)
    _, vjp = jax.vjp(lambda s, v: _jax_join(s, v, f), jnp.asarray(skip),
                     jnp.asarray(x))
    jds, jdx = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    ts, tx = (_nchw(v, dtype).requires_grad_() for v in (skip, x))
    tg = _nchw(g, dtype)
    up_cat(ts, tx, f).backward(tg)
    ds, dx = (t.grad.permute(0, 2, 3, 1) for t in (ts, tx))
    np.testing.assert_array_equal(ds.float().numpy(), jds)
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), jdx, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(dx.float().numpy(), jdx, rtol=2 ** -7,
                                   atol=0)
    want_ds, want_dx = upcat_bwd_plain(tg.permute(0, 2, 3, 1),
                                       skip.shape[3], f)
    assert torch.equal(ds, want_ds) and torch.equal(dx, want_dx)


def test_upcat_x4_backward_bf16_rounds_between_levels():
    """The x4 join's gradient is two chained x2 sum-pools, as the
    unfused decoder ran them: each level sums in f32 and rounds to bf16
    once, so the first level's sums are rounded before the second."""
    rng = np.random.default_rng(3)
    g = torch.from_numpy(rng.random((3, 16, 16, 12), dtype=np.float32)
                         * 3).to(torch.bfloat16)

    def pool(t):
        return ((t[:, 0::2, 0::2] + t[:, 0::2, 1::2])
                + (t[:, 1::2, 0::2] + t[:, 1::2, 1::2]))

    f = g[..., 5:].float()
    rounded = pool(pool(f).to(torch.bfloat16).float()).to(torch.bfloat16)
    dskip, dx = upcat_bwd_plain(g, 5, 4)
    assert dx.dtype == torch.bfloat16 and dx.is_contiguous()
    assert torch.equal(dx, rounded) and torch.equal(dskip, g[..., :5])
    assert torch.equal(upcat_bwd(g, 5, 4)[1], rounded)
    # one rounding at the very end differs somewhere
    assert not torch.equal(dx, pool(pool(f)).to(torch.bfloat16))


def test_upcat_with_no_skip_channels_is_upsample2x():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.random((2, 4, 6, 5), dtype=np.float32))
    g = torch.from_numpy(rng.random((2, 8, 12, 5), dtype=np.float32))
    up = upsample2x(x)
    assert torch.equal(upcat_fwd(None, x), up)
    assert torch.equal(upcat_fwd(torch.zeros(2, 8, 12, 0), x), up)
    assert torch.equal(upcat_plain(torch.zeros(2, 8, 12, 0), x), up)
    dskip, dx = upcat_bwd(g, 0)
    assert dskip.shape == (2, 8, 12, 0)
    assert torch.equal(dx, upsample2x_bwd(g))
    assert upcat_bwd(g, 0, need_skip=False)[0] is None


def test_up_cat_asks_for_the_skip_gradient_only_when_needed(monkeypatch):
    asked = []
    real = upsample_mod.upcat_bwd
    monkeypatch.setattr(upsample_mod, "upcat_bwd",
                        lambda g, cs, f, need_skip, **k: asked.append(
                            need_skip) or real(g, cs, f, need_skip, **k))
    s = torch.rand(2, 3, 8, 8).contiguous(memory_format=torch.channels_last)
    x = torch.rand(2, 4, 4, 4).contiguous(memory_format=torch.channels_last)
    up_cat(s, x.requires_grad_()).sum().backward()
    up_cat(s.requires_grad_(), x).sum().backward()
    assert asked == [False, True]
    assert s.grad is not None and torch.equal(s.grad, torch.ones_like(s))
    assert torch.equal(x.grad, torch.full_like(x, 8.0))


def test_upcat_rejects_what_the_kernel_does_not_take():
    cl = torch.channels_last
    s = torch.zeros(2, 3, 8, 8).contiguous(memory_format=cl)
    x = torch.zeros(2, 4, 4, 4).contiguous(memory_format=cl)
    _build.launches.clear()
    with pytest.raises(ValueError, match="contiguous NHWC"):
        up_cat(torch.zeros(2, 3, 8, 8), x)              # NCHW-dense skip
    with pytest.raises(ValueError, match="contiguous NHWC"):
        up_cat(s, torch.zeros(2, 4, 4, 4))              # NCHW-dense x
    with pytest.raises(ValueError, match="does not match"):
        up_cat(s, x, 4)                                 # 8 != 4 * 4
    with pytest.raises(ValueError, match="does not match"):
        up_cat(s.to(torch.bfloat16), x)
    with pytest.raises(ValueError, match="factor"):
        up_cat(s, x, 3)
    with pytest.raises(ValueError, match="multiples of 4"):
        upcat_bwd(torch.zeros(2, 6, 8, 7), 3, 4)
    with pytest.raises(ValueError, match="skip channels"):
        upcat_bwd(torch.zeros(2, 8, 8, 7), 8)
    assert sum(_build.launches.values()) == 0          # CPU: plain only


def _jax_up_first(skip, x, f):
    for _ in range(LEVELS[f]):
        x = (upsample2x_pallas(x) if supports_pallas_upsample(x)
             else jnp_upsample2x(x))
    return jnp.concatenate([x, skip], -1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("join", sorted(UNET_JOINS))
def test_up_first_join_forward_equals_jax(join, dtype):
    (skip, x, _), f = _inputs("unet5", join, dtype, seed=5)
    ref = np.asarray(_jax_up_first(jnp.asarray(skip, dtype),
                                   jnp.asarray(x, dtype), f)
                     .astype(jnp.float32))
    ts, tx = (torch.from_numpy(v).to(TORCH[dtype]) for v in (skip, x))
    out = upcat_plain(ts, tx, f, up_first=True)
    assert out.dtype == TORCH[dtype] and out.is_contiguous()
    np.testing.assert_array_equal(out.float().numpy(), ref)
    assert torch.equal(upcat_fwd(ts, tx, f, up_first=True), out)
    nc = up_cat(_nchw(skip, dtype), _nchw(x, dtype), f, up_first=True)
    assert nc.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(nc.permute(0, 2, 3, 1), out)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("join", sorted(UNET_JOINS))
def test_up_first_join_backward_equals_jax_vjp(join, dtype):
    (skip, x, g), f = _inputs("unet5", join, dtype, seed=6)
    _, vjp = jax.vjp(lambda s, v: _jax_up_first(s, v, f),
                     jnp.asarray(skip), jnp.asarray(x))
    jds, jdx = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    ts, tx = (_nchw(v, dtype).requires_grad_() for v in (skip, x))
    tg = _nchw(g, dtype)
    up_cat(ts, tx, f, up_first=True).backward(tg)
    ds, dx = (t.grad.permute(0, 2, 3, 1) for t in (ts, tx))
    np.testing.assert_array_equal(ds.float().numpy(), jds)
    if dtype == "float32":
        np.testing.assert_allclose(dx.numpy(), jdx, atol=1e-6, rtol=0)
    else:
        np.testing.assert_allclose(dx.float().numpy(), jdx, rtol=2 ** -7,
                                   atol=0)
    g_nhwc = tg.permute(0, 2, 3, 1)
    want = upcat_bwd_plain(g_nhwc, skip.shape[3], f, up_first=True)
    assert torch.equal(ds, want[0]) and torch.equal(dx, want[1])
    got = upcat_bwd(g_nhwc, skip.shape[3], f, need_skip=False,
                    up_first=True)
    assert got[0] is None and torch.equal(got[1], dx)


def test_up_first_swaps_the_channel_offsets():
    """Both orders hold the same channels, rotated: the up-first join
    is the skip-first one with its two blocks swapped, and so is its
    gradient's read."""
    rng = np.random.default_rng(7)
    skip = torch.from_numpy(rng.random((2, 8, 8, 3), dtype=np.float32))
    x = torch.from_numpy(rng.random((2, 2, 2, 5), dtype=np.float32))
    a, b = upcat_plain(skip, x, 4), upcat_plain(skip, x, 4, up_first=True)
    assert torch.equal(b, torch.cat([a[..., 3:], a[..., :3]], -1))
    g = torch.from_numpy(rng.random((2, 8, 8, 8), dtype=np.float32))
    ds, dx = upcat_bwd_plain(g, 3, 4, up_first=True)
    ds2, dx2 = upcat_bwd_plain(torch.cat([g[..., 5:], g[..., :5]], -1), 3, 4)
    assert torch.equal(ds, ds2) and torch.equal(dx, dx2)
