"""PyTorch port: the model zoo (`cgs_tpu_torch/models/zoo.py`) against
`cgs_tpu.models.zoo`, module by module, on weights the JAX module
initialised and `models/interop.py` carried across; the VGG / ResNet
`.pt` loaders against `tests/test_zoo_interop.py`'s torchvision-layout
replicas.

Inputs from numpy seeds, batch 2, chfak 1. Tolerance: atol 1e-5 in f32
(the two packages' convolutions sum in other orders); the VGG and ResNet
towers in float64 within 1e-9, as tests/test_zoo_interop.py holds the
JAX converters (in f32 the 8-deep 512-channel stacks amplify the order
noise to ~1% at the near-zero head).
"""

import io

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cgs_tpu.models import zoo as jzoo
from cgs_tpu_torch.models import zoo
from cgs_tpu_torch.models.interop import (
    flattened_head_weight, load_pt_resnet_critic, load_pt_vgg_critic,
    resnet_state_dict_from_flax, vgg_state_dict_from_flax,
    zoo_state_dict_from_flax,
)
from cgs_tpu_torch.ops import _build
from test_zoo_interop import (
    TorchResNetCritic, TorchVGGCritic, _randomize_bn_stats,
    make_torch_resnet18_features, make_torch_vgg11_features,
)
from torch_port_common import nchw, nhwc, one_torch_thread  # noqa: F401

ATOL = 1e-5
KEY = jax.random.PRNGKey(0)


def _frames(shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).random(shape, dtype=np.float32)
            * scale)


def _jax(model, *args, **kwargs):
    """(numpy params, the JAX output) of `model` initialised from KEY."""
    variables = model.init({"params": KEY}, *args, **kwargs)
    out = model.apply(variables, *args, **kwargs)
    return jax.tree.map(np.asarray, variables["params"]), out


def _port(module, params):
    module.load_state_dict(zoo_state_dict_from_flax(module, params))
    return module


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("name,jmodel,pmodel,shape", [
    ("legacy_max", jzoo.LegacyCritic(), zoo.LegacyCritic(), (2, 64, 64, 3)),
    ("legacy_stride", jzoo.LegacyCritic(pool="stride"),
     zoo.LegacyCritic(pool="stride"), (2, 64, 64, 3)),
    ("small", jzoo.SmallCritic(), zoo.SmallCritic(), (2, 16, 16, 3)),
    ("noscale", jzoo.NoScaleCritic(), zoo.NoScaleCritic(), (2, 16, 16, 3)),
    ("small_unet", jzoo.SmallUnet(), zoo.SmallUnet(), (2, 64, 64, 3)),
    ("grounded_unet", jzoo.GroundedUnet(), zoo.GroundedUnet(),
     (2, 64, 64, 3)),
])
def test_conv_modules_equal_jax(name, jmodel, pmodel, shape):
    """The conv critics (flax SAME padding at stride 2 is asymmetric)
    and the two U-Nets whose joins are up-first `up_cat`s."""
    x = _frames(shape, seed=1)
    params, want = _jax(jmodel, jnp.asarray(x))
    got = _port(pmodel, params)(nchw(x))
    _close(nhwc(got), want)


def test_unet_mask_critic_and_embeds_equal_jax(one_torch_thread):
    """zoo.Unet: the mask (its four up-first joins, the last the quirk
    cat(up(u0), up(u0))), the critic head and the u0 embeds; the critic
    path launches no join, and its parameters are the full tree."""
    x = _frames((2, 64, 64, 3), seed=2)
    jm = jzoo.Unet()
    params, want = _jax(jm, jnp.asarray(x))
    jscore = jm.apply({"params": params}, jnp.asarray(x), critic=True)
    jy, ju0 = jm.apply({"params": params}, jnp.asarray(x), embeds=True)
    pm = _port(zoo.Unet(), params)
    assert set(pm.state_dict()) == {f"{k}.{w}" for k in params
                                    for w in ("weight", "bias")}
    _close(nhwc(pm(nchw(x))), want)
    _close(pm(nchw(x), critic=True).detach(), jscore)
    y, u0 = pm(nchw(x), embeds=True)
    _close(nhwc(y), jy)
    _close(nhwc(u0), ju0)


def test_unet_gradients_equal_jax(one_torch_thread):
    """The U-Net's parameter gradients of a loss through the mask: the
    up-first joins' backward (the quirk join's two halves summed)
    against `jax.grad`."""
    x = _frames((2, 64, 64, 3), seed=3)
    jm = jzoo.Unet()
    params = jax.tree.map(np.asarray, jm.init(
        {"params": KEY}, jnp.asarray(x))["params"])
    w = _frames((2, 64, 64, 1), seed=4)
    jg = jax.grad(lambda p: jnp.sum(jm.apply({"params": p},
                                              jnp.asarray(x)) * w))(params)
    pm = _port(zoo.Unet(), params)
    (pm(nchw(x)) * nchw(w)).sum().backward()
    want = zoo_state_dict_from_flax(zoo.Unet(), jax.tree.map(np.asarray, jg))
    for k, p in pm.named_parameters():
        if k.startswith("crit"):
            assert p.grad is None
            continue
        scale = float(want[k].abs().max())
        _close(p.grad / scale, want[k] / scale, atol=1e-4)


def test_autoencoder_and_vae_equal_jax():
    x = _frames((2, 64, 64, 3), seed=5)
    params, (recon, enc) = _jax(jzoo.AutoEncoder(enc_dim=4), jnp.asarray(x))
    p_recon, p_enc = _port(zoo.AutoEncoder(enc_dim=4), params)(nchw(x))
    _close(nhwc(p_recon), recon)
    _close(p_enc.detach(), enc)

    jv = jzoo.VAE(enc_dim=4)
    key = jax.random.PRNGKey(1)
    vp = jax.tree.map(np.asarray, jv.init({"params": KEY}, jnp.asarray(x),
                                          key=key)["params"])
    want = jv.apply({"params": vp}, jnp.asarray(x), key=key)
    noise = np.asarray(jax.random.normal(key, (2, 4)))
    pv = _port(zoo.VAE(enc_dim=4), vp)
    got = pv(nchw(x), noise=torch.from_numpy(noise.copy()))
    _close(nhwc(got[0]), want[0])
    for g, w in zip(got[1:], want[1:]):
        _close(g.detach(), w)
    np.testing.assert_allclose(
        float(zoo.vae_loss(got[0], nchw(x), got[1], got[2]).detach()),
        float(jzoo.vae_loss(*want[:1], jnp.asarray(x), *want[1:])),
        rtol=1e-5)
    det = jv.apply({"params": vp}, jnp.asarray(x), deterministic=True)
    _close(nhwc(pv(nchw(x), deterministic=True)[0]), det[0])
    with pytest.raises(ValueError, match="generator"):
        pv(nchw(x))
    drawn = pv(nchw(x), generator=torch.Generator().manual_seed(0))
    assert drawn[0].shape == (2, 3, 64, 64)


def test_conv_encoder_decoder_and_policy_equal_jax():
    x = _frames((2, 64, 64, 3), seed=6)
    je = jzoo.ConvEncoder64x64(enc_dim=4)
    params = jax.tree.map(np.asarray, je.init(
        {"params": KEY}, jnp.asarray(x))["params"])
    jx, jem = je.apply({"params": params}, jnp.asarray(x), embed=True)
    pe = _port(zoo.ConvEncoder64x64(enc_dim=4), params)
    px, pem = pe(nchw(x), embed=True)
    _close(nhwc(px), jx)
    _close(nhwc(pem), jem)

    z = _frames((2, 1, 1, 4), seed=7)
    dparams, want = _jax(jzoo.ConvDecoder64x64(enc_dim=4), jnp.asarray(z))
    _build.launches.clear()
    got = _port(zoo.ConvDecoder64x64(enc_dim=4), dparams)(nchw(z))
    _close(nhwc(got), want)

    obs = _frames((2, 64, 64, 6), seed=8)
    pparams, want = _jax(jzoo.PolicyNet(enc_dim=16, out_chs=5),
                         jnp.asarray(obs))
    logits = _port(zoo.PolicyNet(enc_dim=16, out_chs=5), pparams)(nchw(obs))
    _close(logits.detach(), want)
    assert torch.equal(zoo.PolicyNet.greedy_action(logits),
                       torch.from_numpy(np.asarray(
                           jzoo.PolicyNet.greedy_action(want))))


def test_flexible_unet_equal_jax():
    """The transposed convs at k = 4, stride 2 (flax SAME = torch
    padding 1) hold value by value, kernels flipped by the converter;
    with dropout on and deterministic=True the same."""
    x = _frames((2, 32, 32, 3), seed=9)
    for drop in (False, True):
        jm = jzoo.FlexibleUnet(wid=32, hidfac=0.5, dropout=drop, neck=2)
        params, want = _jax(jm, jnp.asarray(x))
        pm = _port(zoo.FlexibleUnet(wid=32, hidfac=0.5, dropout=drop,
                                    neck=2), params)
        got = pm(nchw(x))
        assert got.shape == (2, 1, 32, 32)
        _close(nhwc(got), want)
    live = pm(nchw(x), deterministic=False,
              generator=torch.Generator().manual_seed(1))
    assert live.shape == got.shape and not torch.equal(live, got)


def test_vgg_critic_equal_jax():
    """float64: the VGG tower and head (its flattened input permuted
    from NHWC to NCHW order); resize 128 is a nearest x2 first."""
    x = _frames((2, 64, 64, 3), seed=10)
    with jax.enable_x64(True):
        for resize in (64, 128):
            jm = jzoo.VGGCritic(resize=resize)
            params, want = _jax(jm, jnp.asarray(x, jnp.float64))
            pm = zoo.VGGCritic(resize=resize).double()
            pm.load_state_dict(vgg_state_dict_from_flax(params))
            got = pm(nchw(x).double()).detach()
            _close(got, want, atol=1e-9)


def test_vgg_features_embeds_equal_jax():
    x = _frames((1, 64, 64, 3), seed=11)
    with jax.enable_x64(True):
        jm = jzoo.VGG11Features(collect_embeds=True)
        params, (jx, jem) = _jax(jm, jnp.asarray(x, jnp.float64))
        pm = zoo.VGG11Features(collect_embeds=True).double()
        pm.load_state_dict(vgg_state_dict_from_flax(params))
        px, pem = pm(nchw(x).double())
        _close(nhwc(px), jx, atol=1e-9)
        # jax.image.resize weighs its taps in float32 even on float64
        # input: the embeds agree to ~6e-8, not to float64's ~1e-15
        _close(nhwc(pem), jem, atol=1e-6)
        assert pem.shape[1] == 2752


def test_resnet_critic_and_running_stats_equal_jax():
    """float64, eval mode on the JAX module's batch_stats, then one
    train-mode pass: the output and every running mean and variance
    (flax momentum 0.9 = torch 0.1, the biased batch variance kept)."""
    x = _frames((2, 64, 64, 3), seed=12)
    with jax.enable_x64(True):
        jm = jzoo.ResNetCritic()
        xj = jnp.asarray(x, jnp.float64)
        v = jm.init({"params": KEY}, xj)
        params = jax.tree.map(np.asarray, v["params"])
        stats = jax.tree.map(lambda a: np.asarray(a) + 0.1, v["batch_stats"])
        want = jm.apply({"params": params, "batch_stats": stats}, xj)
        pm = zoo.ResNetCritic().double()
        pm.load_state_dict(resnet_state_dict_from_flax(params, stats))
        pm.eval()
        _close(pm(nchw(x).double()).detach(), want, atol=1e-9)
        jt, upd = jm.apply({"params": params, "batch_stats": stats}, xj,
                           train=True, mutable=["batch_stats"])
        pm.train()
        _close(pm(nchw(x).double()).detach(), jt, atol=1e-9)
        new = resnet_state_dict_from_flax(
            params, jax.tree.map(np.asarray, upd["batch_stats"]))
        # flax keeps batch_stats in float32 (its param dtype), so the JAX
        # update rounds to float32: within 1e-7 relative, not 1e-15
        for k, t in pm.state_dict().items():
            if k.endswith(("running_mean", "running_var")):
                _close(t, new[k], atol=1e-6)
                assert not torch.equal(t, resnet_state_dict_from_flax(
                    params, stats)[k].double())


def test_printer_and_pass_are_identities(capsys):
    x = torch.rand(2, 3, 4, 4)
    assert zoo.Printer()(x) is x and zoo.Pass()(x) is x
    assert "(2, 3, 4, 4)" in capsys.readouterr().out
    np.testing.assert_allclose(
        zoo.imagenet_normalize(nchw(_frames((1, 4, 4, 3)))).numpy(),
        np.transpose(np.asarray(jzoo.imagenet_normalize(
            jnp.asarray(_frames((1, 4, 4, 3))))), (0, 3, 1, 2)), atol=1e-6)


# -- the .pt loaders, against tests/test_zoo_interop.py's replicas --------

def _pt(state) -> str:
    buf = io.BytesIO()
    torch.save(state, buf)
    buf.seek(0)
    return buf


def test_load_pt_vgg_critic_runs_the_reference_weights():
    torch.manual_seed(0)
    tm = TorchVGGCritic().double().eval()
    x = torch.from_numpy(_frames((2, 64, 64, 3), seed=13)).permute(
        0, 3, 1, 2).double()
    pm = zoo.VGGCritic().double()
    pm.load_state_dict(load_pt_vgg_critic(_pt(tm.state_dict())))
    with torch.no_grad():
        _close(pm(x), tm(x), atol=1e-10)
    feats = make_torch_vgg11_features()
    with pytest.raises(ValueError, match="head=False"):
        load_pt_vgg_critic(_pt({f"features.{k}": v for k, v in
                                feats.state_dict().items()}))
    sd = load_pt_vgg_critic(_pt({f"model.{k}": v for k, v in
                                 feats.state_dict().items()}), head=False,
                            features_prefix="model")
    zoo.VGG11Features().load_state_dict(sd)


def test_load_pt_resnet_critic_both_grammars():
    torch.manual_seed(2)
    tm = TorchResNetCritic().double().eval()
    _randomize_bn_stats(tm, np.random.default_rng(3))
    x = torch.from_numpy(_frames((2, 64, 64, 3), seed=14)).permute(
        0, 3, 1, 2).double()
    pm = zoo.ResNetCritic().double().eval()
    pm.load_state_dict(load_pt_resnet_critic(_pt(tm.state_dict())))
    with torch.no_grad():
        _close(pm(x), tm(x), atol=1e-9)
    idx_to_name = {"0": "conv1", "1": "bn1", "4": "layer1", "5": "layer2",
                   "6": "layer3", "7": "layer4"}
    raw = {}
    for k, v in make_torch_resnet18_features().state_dict().items():
        idx, rest = k.split(".", 1)
        raw[f"{idx_to_name[idx]}.{rest}"] = v
    raw["fc.weight"], raw["fc.bias"] = torch.zeros(1000, 512), torch.zeros(
        1000)
    with pytest.raises(ValueError, match="head=False"):
        load_pt_resnet_critic(_pt(raw))
    sd = load_pt_resnet_critic(_pt(raw), head=False)
    assert "resnet.0.weight" in sd and not any(k.startswith(("fc", "head"))
                                               for k in sd)
    missing, unexpected = zoo.ResNetCritic().load_state_dict(sd,
                                                             strict=False)
    assert not unexpected and all(k.startswith("head.") for k in missing)


def test_flattened_head_weight_infers_the_geometry():
    """A head built for resize 128 eats 512 x 4 x 4: the converter
    reads the side from the width and permutes (h, w, c) -> (c, h, w)."""
    rng = np.random.default_rng(11)
    k = rng.standard_normal((512 * 16, 256)).astype(np.float32)
    w = flattened_head_weight(k, 512)
    assert w.shape == (256, 8192)
    c, h, wx = 37, 3, 1
    np.testing.assert_array_equal(w[:, c * 16 + h * 4 + wx],
                                  k[h * 4 * 512 + wx * 512 + c])
    with pytest.raises(ValueError, match="head geometry"):
        flattened_head_weight(k[:2040], 512)
