"""PyTorch port, training slice: the merge and upsample-gradient kernels'
plain versions, the losses, the optimizer and the train steps, each
against the JAX package on the same weights and inputs (made from
numpy seeds; weights through `torch_port_common.port_params`).

Tolerances: the merges and the upsample gradient are elementwise or
four-term sums, so they agree to f32 rounding (atol 1e-6; the merge
gradients 1e-5, as `tests/test_pallas_kernels.py` holds the JAX
kernel to the jnp merges). Loss terms and gradients through the
models agree within 1e-5 (f32 conv sums reorder between XLA and
PyTorch; grads use rtol 3e-5 on top, as `tests/test_training_parity.py`
explains). Trajectories: the first step within 1e-5; later steps drift
apart because Adam amplifies 1e-7 gradient noise on near-zero entries
into O(lr) steps, so they are held to the bound stated at each test.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cgs_tpu.core.config import Config as JConfig
from cgs_tpu.models.decoder import upsample2x as jnp_upsample2x
from cgs_tpu.models.torch_interop import (
    CRITIC_KEYMAP, DECODER_KEYMAP, flax_to_torch_state,
)
from cgs_tpu.ops.merge import inject_merge as jax_inject_merge
from cgs_tpu.ops.merge import merge_both as jax_merge_both
from cgs_tpu.ops.merge import replace_merge as jax_replace_merge
from cgs_tpu.ops.pallas_kernels import broadcast_mask
from cgs_tpu.ops.pallas_kernels import merge_pair as jax_merge_pair
from cgs_tpu.ops.pallas_kernels import merge_pair_bwd as jax_merge_pair_bwd
from cgs_tpu.ops.pallas_upsample import (
    supports_pallas_upsample, upsample2x_pallas,
)
from cgs_tpu.train.losses import bce as jax_bce
from cgs_tpu.train.losses import build_masker_loss as jax_masker_loss
from cgs_tpu.train.steps import init_train_state, make_critic_step
from cgs_tpu.train.steps import make_masker_step
from cgs_tpu.train.steps import make_optimizer as jax_make_optimizer
from cgs_tpu.train.steps import trained_param_keys as jax_trained_keys
import cgs_tpu_torch.ops.upsample as upsample_mod
from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.models.interop import adam_state_from_optax
from cgs_tpu_torch.ops import _build
from cgs_tpu_torch.ops.kernels import (
    Segment, merge_pair, merge_pair_bwd, merge_pair_bwd_plain,
    merge_pair_plain,
)
from cgs_tpu_torch.ops.merge import inject_merge, merge_both, replace_merge
from cgs_tpu_torch.ops.upsample import (
    up_cat, upsample2x, upsample2x_bwd, upsample2x_bwd_plain,
)
from cgs_tpu_torch.train.losses import bce, build_masker_loss
from cgs_tpu_torch.train.steps import (
    StepRng, critic_step, make_optimizer, masker_step, trained_param_keys,
)
from torch_port_common import (  # noqa: F401 (one_torch_thread: fixture)
    jax_models, nchw, nhwc, one_torch_thread, port_models, port_params,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CHFAK5_STEPS = [(1, 1, 160), (2, 2, 160), (4, 4, 80), (8, 8, 40),
                (16, 16, 40), (32, 32, 40)]
VARIANTS = {
    "default": {},                                   # live+inject+L1
    "frozen": {"frozen": True},                      # main.py:330-334
    "noinject": {"noinject": True},                  # main.py:405
    "l2_nonstatic": {"staticnorm": False, "L1": 0.0, "L2": 0.3},
    "separate": {"separate": True},                  # main.py:389-390
}
KEYMAPS = {"critic": CRITIC_KEYMAP, "sepcrit": CRITIC_KEYMAP,
           "masker": DECODER_KEYMAP}


def _cfgs(**over):
    """The same flags as the port's and the JAX package's Config."""
    over = {"dropout": 0.0, "shift": 0, **over}
    return Config(**over).derive(), JConfig(**over).derive()


def _rand(rng, shape):
    return rng.random(shape, dtype=np.float32)


# -- the merge kernels' plain versions ----------------------------------

def test_merge_both_values_and_grads_equal_jax():
    rng = np.random.default_rng(5)
    a, b, w1, w2 = (_rand(rng, (6, 64, 64, 3)) for _ in range(4))
    z = _rand(rng, (6, 64, 64, 1))
    ta, tb, tz = (nchw(v).requires_grad_() for v in (a, b, z))
    merged = merge_both(ta, tb, tz)          # replaced || injected
    assert merged.grad_fn is not None and "MergeBoth" in type(
        merged.grad_fn).__name__
    assert merged.shape == (12, 3, 64, 64) and merged.is_contiguous(
        memory_format=torch.channels_last)
    rep, inj = merged[:6], merged[6:]
    ja, jb, jz = (jnp.asarray(v) for v in (a, b, z))
    jrep, jinj = jax_merge_both(ja, jb, jz)             # Pallas, interpret
    for ours, pallas, plain in ((rep, jrep, jax_replace_merge(ja, jb, jz)),
                                (inj, jinj, jax_inject_merge(ja, jb, jz))):
        np.testing.assert_allclose(nhwc(ours), np.asarray(pallas), atol=1e-6)
        np.testing.assert_allclose(nhwc(ours), np.asarray(plain), atol=1e-6)
    ((rep * nchw(w1)).sum() + (inj * nchw(w2)).sum()).backward()

    def loss(merge):
        def f(a, b, z):
            r, i = merge(a, b, z)
            return jnp.sum(r * w1) + jnp.sum(i * w2)
        return f

    for merge in (jax_merge_both,
                  lambda a, b, z: (jax_replace_merge(a, b, z),
                                   jax_inject_merge(a, b, z))):
        grads = jax.grad(loss(merge), argnums=(0, 1, 2))(ja, jb, jz)
        for t, g in zip((ta, tb, tz), grads):
            np.testing.assert_allclose(nhwc(t.grad), np.asarray(g),
                                       atol=1e-5)


def test_merge_pair_and_bwd_plain_equal_jax_kernels():
    rng = np.random.default_rng(6)
    n = 4
    a, b, gr, gi = (_rand(rng, (n, 64, 64, 3)) for _ in range(4))
    z = _rand(rng, (n, 64, 64, 1))
    flat = [jnp.asarray(v.reshape(n, -1)) for v in (a, b)]
    zf = broadcast_mask(jnp.asarray(z))
    jrep, jinj = jax_merge_pair(*flat, zf)
    joined = merge_pair(nchw(a), nchw(b), nchw(z))
    rep, inj = joined[:n], joined[n:]
    np.testing.assert_allclose(nhwc(rep).reshape(n, -1), np.asarray(jrep),
                               atol=1e-6)
    np.testing.assert_allclose(nhwc(inj).reshape(n, -1), np.asarray(jinj),
                               atol=1e-6)
    jda, jdb, jdz3 = jax_merge_pair_bwd(
        *flat, zf, jnp.asarray(gr.reshape(n, -1)),
        jnp.asarray(gi.reshape(n, -1)))
    jdz = np.asarray(jdz3).reshape(a.shape).sum(-1, keepdims=True)
    # the joined gradient in either memory format gives the same result
    g = nchw(np.concatenate([gr, gi]))
    for fmt in (torch.channels_last, torch.contiguous_format):
        da, db, dz = merge_pair_bwd(nchw(a), nchw(b), nchw(z),
                                    g.contiguous(memory_format=fmt))
        np.testing.assert_allclose(nhwc(da).reshape(n, -1), np.asarray(jda),
                                   atol=1e-6)
        np.testing.assert_allclose(nhwc(db).reshape(n, -1), np.asarray(jdb),
                                   atol=1e-6)
        np.testing.assert_allclose(nhwc(dz), jdz, atol=1e-6)
    # the channel sum is ((d0 + d1) + d2), in that order
    d = (nchw(gr) - nchw(gi)) * (nchw(b) - nchw(a))
    _, _, dz = merge_pair_bwd_plain(nchw(a), nchw(b), nchw(z), g)
    assert torch.equal(dz, (d[:, 0:1] + d[:, 1:2]) + d[:, 2:3])
    assert torch.equal(merge_pair_plain(nchw(a), nchw(b), nchw(z)), joined)


def test_merge_wrappers_reject_what_the_kernels_do_not_take():
    a = torch.zeros(2, 3, 8, 8)
    with pytest.raises(ValueError, match="z"):
        merge_pair(a, a, torch.zeros(2, 3, 8, 8))
    with pytest.raises(ValueError, match="float32"):
        merge_pair(a.double(), a.double(), torch.zeros(2, 1, 8, 8).double())
    with pytest.raises(ValueError, match="gradient"):
        merge_pair_bwd(a, a, torch.zeros(2, 1, 8, 8), torch.zeros(4, 3, 4, 4))
    with pytest.raises(ValueError, match="joined"):     # one half only
        merge_pair_bwd(a, a, torch.zeros(2, 1, 8, 8), a)
    with pytest.raises(ValueError, match="3 flags"):
        merge_pair_bwd(a, a, torch.zeros(2, 1, 8, 8), torch.cat([a, a]),
                       (True, True))
    _build.launches.clear()
    replace_merge(a, a, torch.zeros(2, 1, 8, 8))
    inject_merge(a, a, torch.zeros(2, 1, 8, 8))
    merge_both(a, a, torch.zeros(2, 1, 8, 8))
    assert sum(_build.launches.values()) == 0          # CPU: plain only


# -- the upsample gradient ----------------------------------------------

@pytest.mark.parametrize("step", CHFAK5_STEPS)
def test_upsample_backward_equals_jax_grad(step):
    h, w, c = step
    rng = np.random.default_rng(h * 1000 + c)
    x = _rand(rng, (2, h, w, c))
    g = _rand(rng, (2, 2 * h, 2 * w, c))
    fn = (upsample2x_pallas if supports_pallas_upsample(jnp.asarray(x))
          else jnp_upsample2x)
    _, vjp = jax.vjp(fn, jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    np.testing.assert_allclose(upsample2x_bwd(torch.from_numpy(g)).numpy(),
                               want, atol=1e-6)
    tx = torch.from_numpy(x).requires_grad_()
    upsample2x(tx).backward(torch.from_numpy(g))
    np.testing.assert_allclose(tx.grad.numpy(), want, atol=1e-6)
    # a channel slice of a wider gradient (what torch.cat's backward
    # hands over) is read in place and gives the same sum
    wide = torch.from_numpy(_rand(rng, (2, 2 * h, 2 * w, c + 5)))
    wide[..., 2:2 + c] = torch.from_numpy(g)
    view = wide[..., 2:2 + c]
    assert not view.is_contiguous()
    assert torch.equal(upsample2x_bwd(view), upsample2x_bwd_plain(
        view.contiguous()))


def test_upsample_backward_bf16_sums_in_f32_and_rounds_once():
    rng = np.random.default_rng(11)
    g = torch.from_numpy(_rand(rng, (3, 16, 16, 8)) * 3).to(torch.bfloat16)
    f = g.float()
    once = ((f[:, 0::2, 0::2] + f[:, 0::2, 1::2])
            + (f[:, 1::2, 0::2] + f[:, 1::2, 1::2])).to(torch.bfloat16)
    out = upsample2x_bwd_plain(g)
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    assert torch.equal(out, once)
    # rounding after every add (a bf16 accumulator) differs somewhere
    stepwise = ((g[:, 0::2, 0::2] + g[:, 0::2, 1::2])
                + (g[:, 1::2, 0::2] + g[:, 1::2, 1::2]))
    assert not torch.equal(out, stepwise)


def test_decoder_upsteps_are_differentiable_through_the_bwd_wrapper(
        monkeypatch):
    """The fault the training slice repaired: a ctypes launch into a
    fresh tensor has no grad_fn, so the decoder's skip joins must go
    through the autograd Function, whose backward is the fused
    backward's wrapper (the kernel on the card): 5 calls per decoder
    backward, one per join."""
    calls = []
    real = upsample_mod.upcat_bwd
    monkeypatch.setattr(upsample_mod, "upcat_bwd",
                        lambda g, *a, **k: calls.append(g.shape)
                        or real(g, *a, **k))
    s, t = (torch.rand(2, c, h, h).contiguous(
        memory_format=torch.channels_last) for c, h in ((3, 8), (8, 4)))
    assert "UpCat" in type(up_cat(s, t.requires_grad_()).grad_fn
                           .next_functions[0][0]).__name__
    cfg, _ = _cfgs()
    critic, masker = port_models()
    rng = np.random.default_rng(2)
    a, b = (nchw(_rand(rng, (4, 64, 64, 3))) for _ in range(2))
    y = torch.from_numpy(_rand(rng, (4,)))
    loss, _ = build_masker_loss(cfg)({"critic": critic, "masker": masker},
                                     a, y, b)
    loss.backward()
    assert len(calls) == 5
    for name, p in masker.named_parameters():
        assert p.grad is not None and bool(p.grad.abs().sum() > 0), name


# -- losses ---------------------------------------------------------------

def test_bce_at_saturation_equals_jax():
    pred = np.asarray([0.0, 1.0, 1e-45, 1 - 1e-7, 0.5, 0.999999],
                      np.float32)
    y = np.asarray([1.0, 0.0, 1.0, 0.0, 0.3, 1.0], np.float32)
    tp = torch.from_numpy(pred).requires_grad_()
    ours = bce(tp, torch.from_numpy(y))
    ours.backward()
    want, jgrad = jax.value_and_grad(jax_bce)(jnp.asarray(pred),
                                              jnp.asarray(y))
    np.testing.assert_allclose(float(ours.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(tp.grad.numpy(), np.asarray(jgrad),
                               rtol=1e-5, atol=1e-6)
    assert torch.isfinite(tp.grad).all() and float(tp.grad[0]) == 0.0


def _port_modules(jp, chfak=1, names=("critic", "masker")):
    critic, masker = port_models(chfak=chfak)
    pp = port_params(jp)
    mods = {}
    for name in names:
        m = (masker if name == "masker" else
             (critic if name == "critic" else port_models(chfak=chfak)[0]))
        m.load_state_dict(pp[name])
        mods[name] = m.to(memory_format=torch.channels_last)
    return mods


def _grads_to_torch(jgrads):
    return {name: flax_to_torch_state(jax.tree.map(np.asarray, tree),
                                      KEYMAPS[name])
            for name, tree in jgrads.items()}


def _masker_case_inputs(n):
    rng = np.random.default_rng(7)
    a, b = _rand(rng, (n, 64, 64, 3)), _rand(rng, (n, 64, 64, 3))
    return a, _rand(rng, (n,)), b


@functools.lru_cache(maxsize=None)
def _jax_masker_loss(variant, chfak, n):
    """JAX's loss terms and gradients for one variant, computed once and
    shared by the port's three fuse modes: with dropout 0 the modes
    compute the same function (module docstring of train/losses.py)."""
    _, jcfg = _cfgs(**VARIANTS[variant])
    jc, jm, jp = jax_models(chfak=chfak)
    a, y, b = _masker_case_inputs(n)
    names = ["critic", "masker"] + (["sepcrit"] if jcfg.separate else [])
    trained = jax_trained_keys(jcfg)
    jall = {k: jp[k] for k in names}
    jtrain = {k: v for k, v in jall.items() if k in trained}
    jconst = {k: v for k, v in jall.items() if k not in trained}
    (_, jaux), jgrads = jax.jit(jax.value_and_grad(
        jax_masker_loss(jcfg, jc, jm), has_aux=True))(
        jtrain, jconst, jnp.asarray(a), jnp.asarray(y), jnp.asarray(b),
        jax.random.PRNGKey(0))
    return jaux, jgrads


def _masker_loss_case(variant, fuse, chfak, n):
    cfg, jcfg = _cfgs(**VARIANTS[variant])
    _, _, jp = jax_models(chfak=chfak)
    a, y, b = _masker_case_inputs(n)
    names = ["critic", "masker"] + (["sepcrit"] if cfg.separate else [])
    trained = jax_trained_keys(jcfg)
    assert trained == trained_param_keys(cfg)
    jaux, jgrads = _jax_masker_loss(variant, chfak, n)

    mods = _port_modules(jp, chfak, names)
    for name, m in mods.items():
        m.requires_grad_(name in trained)
    loss, aux = build_masker_loss(cfg, fuse)(
        mods, nchw(a), torch.from_numpy(y), nchw(b))
    loss.backward()
    for term in ("loss", "replace", "inject", "norm", "critic"):
        np.testing.assert_allclose(float(aux[term].detach()),
                                   float(jaux[term]),
                                   atol=1e-5, rtol=1e-5, err_msg=term)
    np.testing.assert_allclose(nhwc(aux["z"]), np.asarray(jaux["z"]),
                               atol=1e-5)
    jg = _grads_to_torch(jgrads)
    for name in names:
        for k, p in mods[name].named_parameters():
            if name not in trained:
                assert p.grad is None, (name, k)
                continue
            # a parameter outside the graph (the separate critic's head)
            # has no grad in torch and a zero one in JAX: Adam leaves
            # it where it is in both
            grad = (p.grad.numpy() if p.grad is not None
                    else np.zeros(p.shape, np.float32))
            np.testing.assert_allclose(grad, jg[name][k],
                                       atol=1e-5, rtol=3e-5,
                                       err_msg=f"{variant}/{fuse} {name}.{k}")


@pytest.mark.parametrize("fuse", ["none", "merges", "both"])
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_masker_loss_terms_and_grads_equal_jax(variant, fuse):
    _masker_loss_case(variant, fuse, chfak=1, n=4)


def test_masker_loss_equals_jax_at_the_published_width():
    _masker_loss_case("default", "both", chfak=5, n=2)


# -- optimizer and steps --------------------------------------------------

def test_critic_trajectory_tracks_make_critic_step():
    """20 steps from the same weights on the same batches. Step 0 is
    the pre-update forward (1e-5); over 20 steps the losses stay within
    1e-3 relative (Adam noise amplification, module docstring)."""
    cfg, jcfg = _cfgs()
    jc, _, jp = jax_models()
    rng = np.random.default_rng(3)
    xs = rng.integers(0, 256, (20, 16, 64, 64, 3), dtype=np.uint8)
    ys = _rand(rng, (20, 16))
    tx = jax_make_optimizer()
    state = init_train_state({"critic": jp["critic"]}, tx)
    step = make_critic_step(jcfg, jc, tx)
    jl = []
    for i in range(20):
        state, loss = step(state, jnp.asarray(xs[i]), jnp.asarray(ys[i]),
                           jax.random.PRNGKey(i))
        jl.append(float(loss))
    critic = _port_modules(jp, names=("critic",))["critic"]
    opt = make_optimizer({"critic": critic})
    srng = StepRng.seeded(0, "cpu")
    tl = [float(critic_step(cfg, critic, opt,
                            Segment(torch.from_numpy(xs[i]),
                                    labels=torch.from_numpy(ys[i])), srng))
          for i in range(20)]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    jfinal = flax_to_torch_state(jax.tree.map(np.asarray,
                                              state.params["critic"]),
                                 CRITIC_KEYMAP)
    for k, p in critic.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jfinal[k], atol=2e-4,
                                   err_msg=k)


def _masker_batches(n_steps, k=4):
    rng = np.random.default_rng(4)
    a = rng.integers(0, 256, (n_steps, 2 * k, 64, 64, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (n_steps, 2 * k, 64, 64, 3), dtype=np.uint8)
    return a, _rand(rng, (n_steps, 2 * k)), b


def _masker_step(cfg, mods, opt, a, y, b, srng) -> np.ndarray:
    """One port masker step on host batches a (2K frames, labels y) and
    b; its four loss terms."""
    terms = masker_step(cfg, mods, opt,
                        [Segment(torch.from_numpy(a),
                                 labels=torch.from_numpy(y))],
                        Segment(torch.from_numpy(b)), srng)
    return np.array([float(t) for t in terms])


def _adam_moments(opt_state):
    """(mu, nu, count) of optax.adam's state as numpy trees."""
    adam = opt_state[0]
    return (jax.tree.map(np.asarray, adam.mu),
            jax.tree.map(np.asarray, adam.nu), int(adam.count))


def test_masker_trajectory_and_mid_training_state_track_make_masker_step():
    """20 masker steps (default flags, fuse 'both') from the same
    weights on the same batches: the loss terms stay within 1e-3
    relative (2e-5 absolute for terms near zero). Then one step from
    JAX's state after 10 steps, weights and Adam moments carried
    across by `adam_state_from_optax`: the updated weights agree with
    JAX's step 11 within 1e-6."""
    cfg, jcfg = _cfgs()
    jc, jm, jp = jax_models()
    a, y, b = _masker_batches(20)
    tx = jax_make_optimizer()
    trained = jax_trained_keys(jcfg)
    state = init_train_state({"critic": jp["critic"],
                              "masker": jp["masker"]}, tx, trained)
    step = make_masker_step(jcfg, jc, jm, tx)
    jl, states = [], {}
    for i in range(20):
        if i in (10, 11):     # the step donates its state: keep copies
            states[i] = jax.tree.map(np.asarray, state)
        state, m = step(state, jnp.asarray(a[i]), jnp.asarray(y[i]),
                        jnp.asarray(b[i]), jax.random.PRNGKey(i))
        jl.append([float(m[t]) for t in ("replace", "inject", "norm",
                                         "critic")])
    mods = _port_modules(jp)
    opt = make_optimizer(mods)
    srng = StepRng.seeded(0, "cpu")
    tl = [_masker_step(cfg, mods, opt, a[i], y[i], b[i], srng)
          for i in range(20)]
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(tl), np.asarray(jl), rtol=1e-3,
                               atol=2e-5)

    # one step from JAX's mid-training state (after step 10)
    mid = jax.tree.map(np.asarray, states[10].params)
    mods = _port_modules(mid)
    opt = make_optimizer(mods)
    mu, nu, count = _adam_moments(states[10].opt_state)
    assert count == 10
    opt.load_state_dict(adam_state_from_optax(opt, mods, mu, nu, count))
    _masker_step(cfg, mods, opt, a[10], y[10], b[10], srng)
    want = _grads_to_torch(jax.tree.map(np.asarray, states[11].params))
    for name, m in mods.items():
        for k, p in m.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[name][k],
                                       atol=1e-6, err_msg=f"{name}.{k}")


def test_critic_update_scale_scales_the_critic_group_only():
    """--critic-lr-scale s: the critic's first update is s times the
    unscaled one (within 1 ulp of the update: the port scales lr, optax
    the update), the masker's is unchanged, as with JAX's
    make_optimizer(s); s = 0 leaves the critic where it was."""
    cfg, jcfg = _cfgs()
    jc, jm, jp = jax_models()
    a, y, b = _masker_batches(1)
    deltas = {}
    for s in (1.0, 0.5, 0.0):
        mods = _port_modules(jp)
        before = {n: {k: p.detach().clone() for k, p in m.named_parameters()}
                  for n, m in mods.items()}
        opt = make_optimizer(mods, critic_update_scale=s)
        assert [g["lr"] for g in opt.param_groups] == [1e-3 * s, 1e-3]
        _masker_step(cfg, mods, opt, a[0], y[0], b[0],
                     StepRng.seeded(0, "cpu"))
        deltas[s] = {n: {k: (p.detach() - before[n][k]).numpy()
                         for k, p in m.named_parameters()}
                     for n, m in mods.items()}
        if s == 0.0:
            continue
        # the same scale in the JAX package
        tx = jax_make_optimizer(s)
        st = init_train_state({"critic": jp["critic"],
                               "masker": jp["masker"]}, tx,
                              jax_trained_keys(jcfg))
        st, _ = make_masker_step(jcfg, jc, jm, tx)(
            st, jnp.asarray(a[0]), jnp.asarray(y[0]), jnp.asarray(b[0]),
            jax.random.PRNGKey(0))
        jd = _grads_to_torch(jax.tree.map(
            lambda new, old: np.asarray(new) - np.asarray(old),
            {"critic": st.params["critic"], "masker": st.params["masker"]},
            {"critic": jp["critic"], "masker": jp["masker"]}))
        for n in ("critic", "masker"):
            for k, d in deltas[s][n].items():
                np.testing.assert_allclose(d, jd[n][k], atol=2e-6,
                                           err_msg=f"s={s} {n}.{k}")
    for k, d in deltas[0.5]["critic"].items():
        np.testing.assert_allclose(d, 0.5 * deltas[1.0]["critic"][k],
                                   rtol=1e-5, atol=1e-7, err_msg=k)
        assert not np.any(deltas[0.0]["critic"][k])
    for k, d in deltas[0.5]["masker"].items():
        np.testing.assert_array_equal(d, deltas[1.0]["masker"][k])
    with pytest.warns(UserWarning, match="sepcrit"):
        make_optimizer({"sepcrit": port_models()[0]},
                       critic_update_scale=0.5)
