"""PyTorch port: the sandbox modules over the zoo and the critic
(`cgs_tpu_torch/sandbox/`: `sum_segm`, `td_critic`, `discriminator`,
`dream`, `unet_embeddings`, `trans_embeds`) against `cgs_tpu.sandbox`,
on weights the JAX modules initialised and `models/interop.py` carried
across, with seeded numpy inputs.

The critic steps run at dropout 0 and shift 0 (torch cannot replay the
JAX step's dropout and shift keys; the port's explicit shifts are held
to rolled inputs instead). Tolerances: losses within 1e-5 relative,
parameters after two Adam steps within 1e-5, the dream's frames within
1e-5 (each step divides the gradient by its largest |value|); PNG
panels within one level (the two packages' convolutions sum in other
orders); the U-Net embeds' 2-D projection within 1e-3 of JAX's, up to
the sign of each principal component (an SVD's sign is arbitrary).
"""

import importlib
import importlib.util
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from cgs_tpu.core.config import Config as JConfig
from cgs_tpu.models.critic import Critic as JCritic
from cgs_tpu.models.zoo import Unet as JUnet, VGG11Features as JVGG
from cgs_tpu.models.zoo import imagenet_normalize as jnorm
from cgs_tpu.sandbox import (
    dream as jdream, make_discriminator_step as jdisc,
    make_td_critic_step as jtd, sarsa_pairs as jsarsa,
)
from cgs_tpu.train.steps import init_train_state
from cgs_tpu.train.steps import make_optimizer as jmake_optimizer
from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.models.interop import (
    CRITIC_KEYMAP, state_dict_from_flax, vgg_state_dict_from_flax,
    zoo_state_dict_from_flax,
)
from cgs_tpu_torch.models.zoo import Unet
from cgs_tpu_torch.sandbox import (
    dream, make_discriminator_step, make_td_critic_step, sarsa_pairs,
)
from cgs_tpu_torch.train.steps import StepRng, make_optimizer
from torch_port_common import nchw, nhwc, one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
# the modules (the packages export functions of the same names)
jss, jte, jue, sum_segm, trans_embeds, unet_embeddings = (
    importlib.import_module(f"{pkg}.sandbox.{m}")
    for pkg in ("cgs_tpu", "cgs_tpu_torch")
    for m in ("sum_segm", "trans_embeds", "unet_embeddings"))


def _u8(seed, n):
    return np.random.default_rng(seed).integers(0, 256, (n, 64, 64, 3),
                                                dtype=np.uint8)


def _critics():
    """(JAX critic, its TrainState, the port's critic on its weights,
    the port's Adam)."""
    jc = JCritic(dropout=0.0)
    cp = jax.tree.map(np.asarray, jc.init(
        {"params": KEY}, jnp.zeros((2, 64, 64, 3)), collect=True)["params"])
    tx = jmake_optimizer()
    pc = Critic(dropout=0.0).to(memory_format=torch.channels_last)
    pc.load_state_dict(state_dict_from_flax(cp, CRITIC_KEYMAP))
    return jc, tx, init_train_state({"critic": cp}, tx), pc, \
        make_optimizer({"critic": pc})


def _same_critic(pc, state):
    want = state_dict_from_flax(jax.tree.map(np.asarray,
                                             state.params["critic"]),
                                CRITIC_KEYMAP)
    for k, v in pc.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   rtol=0, err_msg=k)


def test_sarsa_pairs_equal_jax():
    rng = np.random.default_rng(0)
    i = np.concatenate([np.arange(7), np.arange(5), np.arange(9)])
    y = rng.random(len(i)).astype(np.float32)
    for fskip in (1, 2):
        for g, w in zip(sarsa_pairs(i, y, i, fskip),
                        jsarsa(i, y, i, fskip)):
            np.testing.assert_array_equal(g, w)


def test_td_critic_steps_equal_jax(one_torch_thread):
    jc, tx, state, pc, opt = _critics()
    jstep = jtd(JConfig(shift=0, dropout=0.0), jc, tx, etha=0.98)
    pstep = make_td_critic_step(Config(shift=0, dropout=0.0), pc, opt,
                                etha=0.98)
    xt, xtp = _u8(1, 6), _u8(2, 6)
    r = np.random.default_rng(3).random(6).astype(np.float32)
    for i in range(2):
        state, jl = jstep(state, jnp.asarray(xt), jnp.asarray(xtp),
                          jnp.asarray(r), jax.random.PRNGKey(i))
        pl = pstep(torch.from_numpy(xt), torch.from_numpy(xtp),
                   torch.from_numpy(r))
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _same_critic(pc, state)


def test_td_critic_explicit_shifts_roll_each_batch(one_torch_thread):
    """With --shift the two batches roll by their own shifts: the step
    at shifts (5, -9) is the step at 0 on the rolled frames."""
    xt, xtp = _u8(4, 4), _u8(5, 4)
    r = torch.rand(4, generator=torch.Generator().manual_seed(0))
    losses = []
    for shifts, a, b in (((5, -9), xt, xtp),
                         ((0, 0), np.roll(xt, 5, 2), np.roll(xtp, -9, 2))):
        *_, pc, opt = _critics()
        step = make_td_critic_step(Config(shift=12, dropout=0.0), pc, opt)
        losses.append(float(step(torch.from_numpy(a), torch.from_numpy(b), r,
                                  shifts=shifts)))
    assert losses[0] == losses[1]
    *_, pc, opt = _critics()
    drawn = make_td_critic_step(Config(shift=12, dropout=0.0), pc, opt)(
        torch.from_numpy(xt), torch.from_numpy(xtp), r,
        rng=StepRng.seeded(0, "cpu"))
    assert np.isfinite(float(drawn))


def test_discriminator_steps_equal_jax(one_torch_thread):
    jc, tx, state, pc, opt = _critics()
    jstep = jdisc(jc, tx)
    pstep = make_discriminator_step(pc, opt)
    rng = np.random.default_rng(6)
    x = np.concatenate([rng.integers(0, 60, (4, 64, 64, 3)),
                        rng.integers(180, 256, (4, 64, 64, 3))]).astype(
        np.uint8)
    y = np.repeat(np.float32([0, 1]), 4)
    for i in range(2):
        state, jl = jstep(state, jnp.asarray(x), jnp.asarray(y),
                          jax.random.PRNGKey(i))
        pl = pstep(torch.from_numpy(x), torch.from_numpy(y))
        np.testing.assert_allclose(float(pl), float(jl), rtol=1e-5)
    _same_critic(pc, state)


def test_dream_equals_jax(one_torch_thread):
    jc, _, state, pc, _ = _critics()
    x0 = np.random.default_rng(7).random((2, 64, 64, 3), dtype=np.float32)
    jf, jtraj, jpreds = jdream(jc, state.params["critic"], jnp.asarray(x0),
                               steps=6, lr=0.1, collect_every=4)
    pc.train()
    f, traj, preds = dream(pc, nchw(x0), steps=6, lr=0.1, collect_every=4)
    assert pc.training
    np.testing.assert_allclose(nhwc(f), np.asarray(jf), atol=1e-5)
    assert traj.shape == (1, 2, 3, 64, 64) and jtraj.shape[0] == 1
    np.testing.assert_allclose(nhwc(traj[0]), np.asarray(jtraj[0]),
                               atol=1e-5)
    np.testing.assert_allclose(preds.numpy(), np.asarray(jpreds), atol=1e-5)


def _unets(seed=0):
    ju = JUnet()
    params = jax.tree.map(np.asarray, ju.init(
        jax.random.PRNGKey(seed), jnp.zeros((2, 64, 64, 3)))["params"])
    pu = Unet()
    pu.load_state_dict(zoo_state_dict_from_flax(pu, params))
    return ju, params, pu


def test_sum_segm_equals_jax(one_torch_thread):
    m = np.full((2, 8, 8, 1), 0.2, np.float32)
    assert float(sum_segm.sum_segm_loss(nchw(m))) == pytest.approx(
        float(jss.sum_segm_loss(jnp.asarray(m))), rel=1e-5)
    ju, params, pu = _unets()
    x = _u8(8, 6)
    jp, jl = jss.train_sum_segm(ju, params, x, steps=3, batch=2,
                                rng=np.random.default_rng(0), chunk_steps=2)
    pu, pl = sum_segm.train_sum_segm(pu, x, steps=3, batch=2,
                                     rng=np.random.default_rng(0),
                                     chunk_steps=2, device="cpu")
    np.testing.assert_allclose(pl, jl, rtol=1e-5)
    want = zoo_state_dict_from_flax(pu, jax.tree.map(np.asarray, jp))
    for k, v in pu.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=1e-5,
                                   err_msg=k)


def _png_levels(path):
    return np.asarray(Image.open(path)).astype(np.int16)


def test_unet_embeddings_projection_and_panels_equal_jax(tmp_path,
                                                         one_torch_thread):
    ju, params, pu = _unets(seed=1)
    rng = np.random.default_rng(9)
    frames = rng.random((6, 64, 64, 3), dtype=np.float32) * 255
    tree_x = rng.random((2, 64, 64, 3), dtype=np.float32) * 255
    tree_y = rng.integers(0, 3, (2, 64, 64))
    jout = jue.vis_unet_embeddings(ju, params, frames, tree_x, tree_y,
                                   str(tmp_path / "jax"), n_samples=3)
    pout = unet_embeddings.vis_unet_embeddings(
        pu, frames, tree_x, tree_y, str(tmp_path / "port"), n_samples=3,
        plot=False)
    assert pout["plot"] is None and os.path.exists(jout["plot"])
    sidx = np.random.default_rng(42).choice(np.arange(6), 3)
    proj = unet_embeddings.project_embeddings(pu, frames[sidx], tree_x,
                                              tree_y)
    jproj = jue._PCAProjector()
    _, jemb = ju.apply({"params": params}, jnp.asarray(frames[sidx]),
                       embeds=True)
    want = jproj.fit_transform(np.asarray(jemb).reshape(
        -1, jemb.shape[-1]))
    got = proj["standard"]
    for c in range(2):
        sign = np.sign(np.dot(got[:, c], want[:, c]))
        np.testing.assert_allclose(sign * got[:, c], want[:, c], atol=1e-3)
    # both packages' CPU SVDs are LAPACK's, whose signs agree here; where
    # they did not, the half-plane x > its 90th percentile would differ
    if np.dot(got[:, 0], want[:, 0]) > 0:
        np.testing.assert_array_equal(pout["selection"], jout["selection"])
        for a, b in zip(pout["frames"], jout["frames"]):
            assert np.abs(_png_levels(a) - _png_levels(b)).max() <= 1


def test_pca_projector_runs_on_cuda_unless_asked():
    """`PCAProjector` and `make_projector` default to the card, as every
    entry point does: without one they raise rather than fall back."""
    assert unet_embeddings.PCAProjector("cpu").device.type == "cpu"
    if torch.cuda.is_available():
        assert unet_embeddings.PCAProjector().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            unet_embeddings.PCAProjector()
        if importlib.util.find_spec("umap") is None:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                unet_embeddings.make_projector()


def test_trans_embeds_similarity_maps_equal_jax(tmp_path):
    """The VGG strip on carried-across weights: the same PNG within one
    level; the maps themselves within 1e-4."""
    frames = np.random.default_rng(10).random((5, 64, 64, 3),
                                              dtype=np.float32)
    from cgs_tpu_torch.utils.colors import hsv_to_rgb
    rgb = hsv_to_rgb(frames)
    params = jax.tree.map(np.asarray, JVGG(collect_embeds=True).init(
        KEY, jnorm(jnp.asarray(rgb)))["params"])
    sd = vgg_state_dict_from_flax(params)
    jpath = jte.trans_embeds(frames, str(tmp_path / "jax"), params=params,
                             max_scopes=2)
    ppath = trans_embeds.trans_embeds(frames, str(tmp_path / "port"),
                                      params=sd, max_scopes=2, device="cpu")
    assert os.path.basename(ppath) == os.path.basename(jpath)
    a, b = _png_levels(ppath), _png_levels(jpath)
    assert a.shape == b.shape and np.abs(a - b).max() <= 1
    model = trans_embeds.VGG11Features(collect_embeds=True)
    model.load_state_dict(sd)
    maps = trans_embeds.similarity_maps(
        model.eval(), nchw(rgb), [(0, 128)], trans_embeds.DEFAULT_TARGETS,
        0.5)
    assert maps.shape == (6, 5, 64, 64)
    _, emb = JVGG(collect_embeds=True).apply({"params": params},
                                             jnorm(jnp.asarray(rgb)))
    e = np.asarray(emb)[..., :128]
    t = e[4, 32, 32]
    want = (e @ t) / np.maximum(np.linalg.norm(e, axis=-1)
                                * max(np.linalg.norm(t), 1e-12), 1e-12)
    np.testing.assert_allclose(maps[0].numpy(), want, atol=1e-4)
