"""PyTorch port: models and checkpoints against the JAX package.

Same weights (JAX init -> `state_dict_from_flax`) and the same seeded
frames go through both. f32 tolerances: 1e-5 at chfak 1; 1e-4 at
chfak 5, whose wider sums reorder between XLA and PyTorch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cgs_tpu.models.torch_interop import flax_to_torch_state
from cgs_tpu.train.checkpoints import load_model_pt as jax_load_pt
from cgs_tpu.train.checkpoints import save_model_pt as jax_save_pt
from cgs_tpu_torch.models.critic import dropout
from cgs_tpu_torch.models.interop import (
    CRITIC_KEYMAP, DECODER_KEYMAP, init_torch_default, num_params,
)
from cgs_tpu_torch.train.checkpoints import load_model_pt, save_model_pt
from torch_port_common import jax_models, nchw, nhwc, port_models, \
    port_params


def _jax_count(tree):
    return sum(int(np.prod(a.shape)) for a in jax.tree.leaves(tree))


@pytest.mark.parametrize("chfak", [1, 5])
def test_param_counts(chfak):
    _, _, jp = jax_models(chfak=chfak)
    critic, masker = port_models(chfak=chfak)
    assert num_params(critic) == _jax_count(jp["critic"])
    assert num_params(masker) == _jax_count(jp["masker"])
    if chfak == 1:   # PARITY.md:40-41
        assert (num_params(critic), num_params(masker)) == (11873, 13785)


def test_state_dict_keys_match_reference_layout():
    critic, masker = port_models()
    _, _, jp = jax_models()
    assert set(critic.state_dict()) == set(
        flax_to_torch_state(jp["critic"], CRITIC_KEYMAP))
    assert set(masker.state_dict()) == set(
        flax_to_torch_state(jp["masker"], DECODER_KEYMAP))


@pytest.mark.parametrize("chfak,atol,batch", [(1, 1e-5, 4), (5, 1e-4, 2)])
def test_forward_parity(chfak, atol, batch):
    jc, jm, jp = jax_models(chfak=chfak)
    frames = np.random.default_rng(chfak).random(
        (batch, 64, 64, 3)).astype(np.float32)
    jpred, jembeds = jc.apply({"params": jp["critic"]}, jnp.asarray(frames),
                              collect=True)
    jmask = jm.apply({"params": jp["masker"]}, jnp.asarray(frames), jembeds)

    critic, masker = port_models(chfak=chfak)
    sd = port_params(jp)
    critic.load_state_dict(sd["critic"])
    masker.load_state_dict(sd["masker"])
    critic.eval()
    with torch.no_grad():
        x = nchw(frames)
        pred, embeds = critic(x, collect=True)
        mask = masker(x, embeds)
    np.testing.assert_allclose(pred.numpy(), np.asarray(jpred), atol=atol)
    assert len(embeds) == len(jembeds) == 5
    for e, je in zip(embeds, jembeds):
        np.testing.assert_allclose(nhwc(e), np.asarray(je), atol=atol)
    np.testing.assert_allclose(nhwc(mask), np.asarray(jmask), atol=atol)


def test_decoder_refuses_non_channels_last_activations():
    """The NHWC upsample takes a permuted view of a channels_last
    activation; an NCHW-contiguous one would need a silent copy, so the
    wrapper raises instead (on the CPU too, so this layout is tested
    here)."""
    critic, masker = port_models()
    x = torch.rand(2, 3, 64, 64)             # NCHW contiguous
    with torch.no_grad():
        _, embeds = critic.eval()(x, collect=True)
        with pytest.raises(ValueError, match="contiguous NHWC"):
            masker(x, embeds)


def test_jax_pt_loads_into_port_and_back(tmp_path):
    jc, _, jp = jax_models()
    path = str(tmp_path / "critic.pt")
    jax_save_pt(jp["critic"], "critic", path)
    state = load_model_pt("critic", path)
    critic, _ = port_models()
    critic.load_state_dict(state)            # plain load_state_dict
    frames = np.random.default_rng(3).random((2, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        pred = critic.eval()(nchw(frames))
    np.testing.assert_allclose(
        pred.numpy(),
        np.asarray(jc.apply({"params": jp["critic"]}, jnp.asarray(frames))),
        atol=1e-5)

    # port -> .pt -> JAX is exact
    back = str(tmp_path / "critic-port.pt")
    save_model_pt(critic.state_dict(), "critic", back)
    tree = jax_load_pt("critic", back)
    for name, leaf in jp["critic"].items():
        np.testing.assert_array_equal(np.asarray(tree[name]["kernel"]),
                                      leaf["kernel"])
        np.testing.assert_array_equal(np.asarray(tree[name]["bias"]),
                                      leaf["bias"])
    assert load_model_pt("masker", str(tmp_path / "absent.pt")) is None
    with pytest.raises(KeyError):
        load_model_pt("masker", back)        # a critic is no masker


def test_default_init_is_seeded_and_torch_shaped():
    a, _ = port_models()
    b, _ = port_models()
    init_torch_default(a, torch.Generator().manual_seed(5))
    init_torch_default(b, torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.features[3].weight.detach()        # fan_in 8*3*3
    bound = 1.0 / np.sqrt(72)
    assert float(w.abs().max()) <= bound and float(w.abs().max()) > 0.8 * bound


def test_dropout_draws_from_generator_and_keeps_layout():
    x = torch.ones(64, 16, 8, 8).to(memory_format=torch.channels_last)
    y1 = dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    y2 = dropout(x, 0.3, True, torch.Generator().manual_seed(1))
    y3 = dropout(x, 0.3, True, torch.Generator().manual_seed(2))
    assert torch.equal(y1, y2) and not torch.equal(y1, y3)
    assert y1.is_contiguous(memory_format=torch.channels_last)
    kept = y1 != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.02
    np.testing.assert_allclose(y1[kept].numpy(), 1 / 0.7, rtol=1e-6)
    assert torch.equal(dropout(x, 0.3, False, None), x)


def test_noevalmode_critic_distribution():
    """Live dropout (-noevalmode) cannot replay jax.random: check that
    train-mode preds scatter around the eval-mode pred."""
    _, _, jp = jax_models()
    critic, _ = port_models(dropout=0.3)
    critic.load_state_dict(port_params(jp)["critic"])
    x = nchw(np.random.default_rng(4).random((1, 64, 64, 3)).astype(
        np.float32)).expand(256, -1, -1, -1).contiguous(
            memory_format=torch.channels_last)
    with torch.no_grad():
        det = critic.eval()(x)
        live = critic.train()(x, generator=torch.Generator().manual_seed(0))
    assert torch.allclose(det, det[0].expand_as(det))
    assert float(live.std()) > 0                # dropout is live
    assert abs(float(live.mean() - det[0])) < 0.1
