"""PyTorch port: the legacy merge training over the zoo's U-Net
(`cgs_tpu_torch/sandbox/merge_variants.py`) against
`cgs_tpu.sandbox.merge_variants`, and `ops/augment.py:gaussian_blur`
against the JAX blur.

Both steps run two Adam steps from the same weights (zoo.Unet at chfak 1,
carried across by `models/interop.py`) on the same seeded frames; the
single-net step takes the negatives JAX's step draws in-graph (its
`jax.random.categorical` on the same key and logits), since torch cannot
replay it. Tolerance: the loss terms within 1e-5, the parameters after
two steps within 1e-5 (Adam steps each weight by about lr = 2e-4 times
the sign of its gradient, so a weight whose gradient the two packages
round to opposite signs would part by 4e-4: none does here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from cgs_tpu.models.zoo import Unet as JUnet
from cgs_tpu.ops.augment import gaussian_blur as jax_blur
from cgs_tpu.sandbox import merge_variants as jmv
from cgs_tpu_torch.models.interop import zoo_state_dict_from_flax
from cgs_tpu_torch.models.zoo import Unet
from cgs_tpu_torch.ops.augment import gaussian_blur
from cgs_tpu_torch.sandbox import merge_variants as mv
from torch_port_common import nchw, nhwc, one_torch_thread  # noqa: F401

LR = 2e-4
TOL = 1e-5
N = 4


def _frames(seed, n=N, c=3):
    return np.random.default_rng(seed).random((n, 64, 64, c),
                                              dtype=np.float32)


def _setup(colorchs=3, seed=0):
    """(JAX Unet, its numpy params, the port's Unet with them, its Adam)."""
    ju = JUnet(colorchs=colorchs)
    params = jax.tree.map(np.asarray, ju.init(
        jax.random.PRNGKey(seed), jnp.zeros((2, 64, 64, colorchs)))["params"])
    pu = Unet(colorchs=colorchs).to(memory_format=torch.channels_last)
    pu.load_state_dict(zoo_state_dict_from_flax(pu, params))
    return ju, params, pu, torch.optim.Adam(pu.parameters(), lr=LR)


def _same_params(pu, jparams, atol=TOL):
    want = zoo_state_dict_from_flax(pu, jax.tree.map(np.asarray, jparams))
    for k, v in pu.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)


def _same_terms(got, want, keys):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), atol=TOL,
                                   rtol=0, err_msg=k)


@pytest.mark.parametrize("mode", [
    {"l1": 0.1, "live": True},
    {"l1": 0.1, "live": True, "use_copy": True, "distnorm": True},
    {"l2": 0.5, "live": False, "staticnorm": True},
    {"l1": 0.1, "live": True, "inject": False},
])
def test_pair_merge_step_equals_jax(mode, one_torch_thread):
    ju, params, pu, opt = _setup()
    tx = optax.adam(LR)
    jstep = jmv.make_pair_merge_step(ju, tx, **mode)
    pstep = mv.make_pair_merge_step(pu, opt, **mode)
    a, b = _frames(1), _frames(2)
    y = np.linspace(0, 1, N).astype(np.float32)
    jp, st = params, tx.init(params)
    frozen = {k: v.detach().clone() for k, v in pu.named_parameters()}
    head = {k: v.clone() for k, v in frozen.items() if k.startswith("crit")}
    for _ in range(2):
        jp, st, jm = jstep(jp, st, jnp.asarray(a), jnp.asarray(y),
                           jnp.asarray(b),
                           None if mode["live"] else params)
        pm = pstep(nchw(a), torch.from_numpy(y), nchw(b),
                   None if mode["live"] else frozen)
        _same_terms(pm, jm, ("loss", "replace", "inject", "norm", "critic"))
    _same_params(pu, jp)
    if not mode["live"]:
        # scored by the frozen snapshot alone: the head has no gradient
        for k, v in head.items():
            assert torch.equal(dict(pu.named_parameters())[k].detach(), v)


def test_frozen_scoring_gives_the_head_no_merge_gradient(one_torch_thread):
    """use_copy: the merges are scored with the weights stopped, so the
    critic head's gradient is the live critic loss's alone; without
    use_copy the merge losses reach it too."""
    _, _, pu, _ = _setup()
    a, b = _frames(3), _frames(4)
    y = torch.linspace(0, 1, N)
    heads = [p for k, p in pu.named_parameters() if k.startswith("crit")]

    def head_grads(**mode):
        opt = torch.optim.SGD(pu.parameters(), lr=0.0)
        captured = []
        real = opt.step
        opt.step = lambda: captured.append([p.grad.clone() for p in heads]) \
            or real()
        mv.make_pair_merge_step(pu, opt, l1=0.1, live=True, **mode)(
            nchw(a), y, nchw(b))
        return captured[0]

    pu.zero_grad()
    score = pu(nchw(a), critic=True).squeeze(-1)
    torch.mean((score - y) ** 2).backward()
    critic_only = [p.grad.clone() for p in heads]
    for got, want in zip(head_grads(use_copy=True), critic_only):
        torch.testing.assert_close(got, want, atol=1e-7, rtol=1e-5)
    live = head_grads(use_copy=False)
    assert any((g - w).abs().max() > 1e-6 for g, w in zip(live, critic_only))


@pytest.mark.parametrize("mode", [
    {"threshold": 0.5, "l1": 0.1, "live": True},
    {"threshold": 0.5, "l2": 0.3, "distnorm": True},
])
def test_single_net_merge_step_equals_jax(mode, one_torch_thread):
    ju, params, pu, opt = _setup()
    tx = optax.adam(LR)
    jstep = jmv.make_single_net_merge_step(ju, tx, **mode)
    pstep = mv.make_single_net_merge_step(pu, opt, **mode)
    x = _frames(5)
    y = np.random.default_rng(6).integers(0, 2, N).astype(np.float32)
    jp, st = params, tx.init(params)
    for i in range(2):
        key = jax.random.PRNGKey(i)
        # the negatives JAX's step draws in-graph from this key
        pred = jax.nn.sigmoid(ju.apply({"params": jp}, jnp.asarray(x),
                                       critic=True).squeeze(-1))
        neg = pred < (1.0 - mode["threshold"])
        logits = jnp.where(neg, 0.0, -jnp.inf)
        logits = jnp.where(jnp.any(neg), logits, jnp.zeros_like(logits))
        negatives = np.asarray(jax.random.categorical(key, logits,
                                                      shape=(N,)))
        jp, st, jm = jstep(jp, st, jnp.asarray(x), jnp.asarray(y), key)
        pm = pstep(nchw(x), torch.from_numpy(y),
                   negatives=torch.from_numpy(negatives.astype(np.int64)))
        _same_terms(pm, jm, ("loss", "value", "norm", "critic", "n_neg"))
    _same_params(pu, jp)
    drawn = pstep(nchw(x), torch.from_numpy(y),
                  generator=torch.Generator().manual_seed(0))
    assert np.isfinite(float(drawn["loss"]))


def test_single_net_cluster_channels_equal_jax(one_torch_thread):
    k = 2
    ju, params, pu, opt = _setup(colorchs=3 + k, seed=1)
    tx = optax.adam(LR)
    x = _frames(7)
    chans = np.random.default_rng(8).integers(0, 2, (N, 64, 64, k)).astype(
        np.float32)
    y = np.zeros(N, np.float32)
    key = jax.random.PRNGKey(2)
    inp = jnp.concatenate([jnp.asarray(x), jnp.asarray(chans)], -1)
    pred = jax.nn.sigmoid(ju.apply({"params": params}, inp,
                                   critic=True).squeeze(-1))
    neg = pred < 0.5
    logits = jnp.where(jnp.any(neg), jnp.where(neg, 0.0, -jnp.inf),
                       jnp.zeros(N))
    negatives = np.asarray(jax.random.categorical(key, logits, shape=(N,)))
    _, _, jm = jmv.make_single_net_merge_step(
        ju, tx, threshold=0.5, n_cluster_channels=k)(
        params, tx.init(params), jnp.asarray(x), jnp.asarray(y), key,
        jnp.asarray(chans))
    pm = mv.make_single_net_merge_step(pu, opt, threshold=0.5,
                                       n_cluster_channels=k)(
        nchw(x), torch.from_numpy(y), channels=nchw(chans),
        negatives=torch.from_numpy(negatives.astype(np.int64)))
    _same_terms(pm, jm, ("loss", "value", "n_neg"))


def test_percentile_split_and_distnorm_equal_jax():
    preds = np.random.default_rng(9).random(100, dtype=np.float32)
    got = mv.percentile_split(torch.from_numpy(preds))
    want = jmv.percentile_split(jnp.asarray(preds))
    for k in ("high", "low", "highsel", "lowsel"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert int(got["highsel"].sum()) == 20 and int(got["lowsel"].sum()) == 21
    odd = mv.percentile_split(torch.from_numpy(preds[:37]), hi=0.75, lo=0.33)
    jodd = jmv.percentile_split(jnp.asarray(preds[:37]), hi=0.75, lo=0.33)
    assert float(odd["high"]) == float(jodd["high"])
    assert float(odd["low"]) == float(jodd["low"])

    z = np.random.default_rng(10).random((2, 16, 12, 1), dtype=np.float32)
    for fixed in (False, True):
        np.testing.assert_allclose(
            float(mv.distnorm_loss(nchw(z), fixed=fixed)),
            float(jmv.distnorm_loss(jnp.asarray(z), fixed=fixed)),
            rtol=1e-6)
    logits = np.random.default_rng(11).standard_normal(64).astype(np.float32)
    t = np.random.default_rng(12).random(64, dtype=np.float32)
    np.testing.assert_allclose(
        float(mv.bce_with_logits(torch.from_numpy(logits),
                                 torch.from_numpy(t))),
        float(jmv.bce_with_logits(jnp.asarray(logits), jnp.asarray(t))),
        rtol=1e-6)


@pytest.mark.parametrize("size", [3, 5, 4])
def test_gaussian_blur_equals_jax(size):
    """The binomial depthwise blur, zero-padded; a size other than 3 or
    5 is the identity."""
    x = np.random.default_rng(13).random((2, 9, 11, 3), dtype=np.float32)
    got = gaussian_blur(nchw(x), size)
    want = np.asarray(jax_blur(jnp.asarray(x), size))
    np.testing.assert_allclose(nhwc(got), want, atol=1e-6, rtol=0)
    if size == 4:
        assert torch.equal(got, nchw(x))
    cl = gaussian_blur(nchw(x).contiguous(), size)
    torch.testing.assert_close(cl, got)
