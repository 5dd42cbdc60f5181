"""PyTorch port: the merge gradient that writes only what autograd asks
for, and the threshold + IoU counts, on the CPU.

`merge_pair_bwd(a, b, z, g, need)` takes the joined (2N, C, H, W)
gradient of `merge_pair`'s output and returns None for an output that
`need` does not ask for; `MergeBoth.backward` passes
`ctx.needs_input_grad`. On the CPU each wrapper runs its plain version,
held here against the JAX package (the Pallas kernels in interpret
mode, as the JAX package's own tests run them): dz within 1e-6 of the
JAX VJP (the port sums the channels in the kernel, ((d0 + d1) + d2);
JAX sums them after its kernel, in XLA's order), the counts exactly.
The CUDA kernels are held against the plain versions on the card by
tests/test_torch_port_cuda.py and chip_smoke.py.
"""

import itertools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cgs_tpu.ops.merge import merge_both as jax_merge_both
from cgs_tpu.ops.pallas_kernels import threshold_iou as jax_threshold_iou
import cgs_tpu_torch.ops.merge as merge_mod
from cgs_tpu_torch.ops import _build
from cgs_tpu_torch.ops.kernels import (
    merge_pair_bwd, merge_pair_bwd_plain, threshold_iou,
)
from cgs_tpu_torch.ops.merge import merge_both
from torch_port_common import nchw, nhwc

NEEDS = list(itertools.product((False, True), repeat=3))


def _merge_case(seed, n=3, h=8, w=8):
    """a, b (N, 3, H, W) channels_last, z (N, 1, H, W) and the joined
    (2N, 3, H, W) gradient, from a numpy seed (NHWC arrays too)."""
    rng = np.random.default_rng(seed)
    a, b = (rng.random((n, h, w, 3), dtype=np.float32) for _ in range(2))
    z = rng.random((n, h, w, 1), dtype=np.float32)
    g = rng.random((2 * n, h, w, 3), dtype=np.float32)
    return (a, b, z, g), tuple(nchw(v) for v in (a, b, z, g))


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.parametrize("need", NEEDS,
                         ids=["".join("TF"[not x] for x in n) for n in NEEDS])
def test_merge_pair_bwd_plain_gives_only_what_is_asked(need):
    """None where `need` says no; elsewhere the same bits as the full
    call. The CPU wrapper is the plain version and launches nothing."""
    _, (a, b, z, g) = _merge_case(1)
    full = merge_pair_bwd_plain(a, b, z, g)
    assert all(t is not None for t in full)
    _build.launches.clear()
    for fn in (merge_pair_bwd_plain, merge_pair_bwd):
        got = fn(a, b, z, g, need)
        for want, t, asked in zip(full, got, need):
            if not asked:
                assert t is None
            else:
                assert t.shape == want.shape
                assert torch.equal(_bits(t), _bits(want))
    assert sum(_build.launches.values()) == 0


@pytest.mark.parametrize("fmt", ["channels_last", "nchw"])
def test_merge_pair_bwd_dz_matches_the_jax_vjp(fmt):
    """dz for the joined gradient in both memory formats against the
    JAX `merge_both` VJP (Pallas in interpret mode), within 1e-6: the
    channel sum is taken in another order. da and db too, when asked."""
    (a_np, b_np, z_np, g_np), (a, b, z, g) = _merge_case(2, n=4, h=16,
                                                        w=16)
    if fmt == "nchw":
        g = g.contiguous()
    assert g.is_contiguous() == (fmt == "nchw")
    n = a.shape[0]
    _, vjp = jax.vjp(jax_merge_both, *(jnp.asarray(v)
                                       for v in (a_np, b_np, z_np)))
    jda, jdb, jdz = (np.asarray(v) for v in vjp((jnp.asarray(g_np[:n]),
                                                 jnp.asarray(g_np[n:]))))
    da, db, dz = merge_pair_bwd(a, b, z, g, (False, False, True))
    assert da is None and db is None and dz.shape == z.shape
    np.testing.assert_allclose(nhwc(dz), jdz, atol=1e-6, rtol=0)
    da, db, dz2 = merge_pair_bwd(a, b, z, g)
    assert torch.equal(dz, dz2)
    np.testing.assert_allclose(nhwc(da), jda, atol=1e-6, rtol=0)
    np.testing.assert_allclose(nhwc(db), jdb, atol=1e-6, rtol=0)


@pytest.mark.parametrize("frames_grad", [False, True])
def test_merge_both_backward_passes_needs_input_grad(frames_grad,
                                                     monkeypatch):
    """`MergeBoth.backward` hands `ctx.needs_input_grad` to the kernel's
    wrapper: frames without requires_grad (the masker step) ask for dz
    alone, frames with it for all three; the gradients autograd
    delivers are the wrapper's."""
    calls = []
    real = merge_mod.merge_pair_bwd

    def spy(a, b, z, g, need):
        calls.append((tuple(g.shape), tuple(need)))
        return real(a, b, z, g, need)

    monkeypatch.setattr(merge_mod, "merge_pair_bwd", spy)
    _, (a, b, z, g) = _merge_case(3)
    a, b = (t.clone().requires_grad_(frames_grad) for t in (a, b))
    z = z.clone().requires_grad_()
    merge_both(a, b, z).backward(g)
    want = (frames_grad, frames_grad, True)
    assert calls == [(tuple(g.shape), want)]
    da, db, dz = merge_pair_bwd_plain(a.detach(), b.detach(), z.detach(), g,
                                      want)
    assert torch.equal(z.grad, dz)
    if frames_grad:
        assert torch.equal(a.grad, da) and torch.equal(b.grad, db)
    else:
        assert a.grad is None and b.grad is None


@pytest.mark.parametrize("shape,thresh", [((300, 4096), 0.05),
                                          ((37, 256), 0.5),
                                          ((3, 128), 0.0),
                                          ((0, 4096), 0.05)])
def test_threshold_iou_equals_jax_with_ties(shape, thresh):
    """Counts equal the JAX kernel's (interpret mode) and numpy's,
    with masks exactly at the threshold (strict > leaves them out),
    ties where gt is set, and N = 0."""
    rng = np.random.default_rng(int(1000 * thresh) + shape[0])
    masks = rng.random(shape, dtype=np.float32)
    gt = rng.random(shape) > 0.6
    if shape[0]:
        masks[0, :64] = np.float32(thresh)          # ties
        gt[0, :32] = True                           # half of them in gt
    ji, ju = jax_threshold_iou(jnp.asarray(masks), jnp.asarray(gt), thresh)
    ti, tu = threshold_iou(torch.from_numpy(masks), torch.from_numpy(gt),
                           thresh)
    hard = masks > np.float32(thresh)
    want = (int(np.sum(hard & gt)), int(np.sum(hard | gt)))
    assert (int(ti), int(tu)) == (int(ji), int(ju)) == want
    assert ti.dtype == tu.dtype == torch.int64
