"""PyTorch port: the seeded runner against the JAX package's vmapped one
(`cgs_tpu_torch/sandbox/seed_parallel.py`, `models/interop.py`
`stack_seeds` / `unstack_seed`).

On the CPU, at chfak 1, from the JAX package's `init_seed_params`
weights (R = 2, with a sepcrit) converted with `stack_seeds`: the
seeded critic chunk against `make_seeded_critic_chunk` on the same
index stacks (batch 8, 3 steps, shift 0, dropout 0; params within
2e-4, losses within rtol 1e-3, as the serial critic chunk is held,
`tests/test_torch_port_train.py`), and the stacking round trip.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cgs_tpu.core.config import Config as JConfig
from cgs_tpu.sandbox import seed_parallel as jsp
from cgs_tpu.train.steps import make_optimizer as jax_make_optimizer
from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.models.interop import (
    CRITIC_KEYMAP, DECODER_KEYMAP, stack_seeds, stack_state_dicts,
    state_dict_from_flax, unstack_seed,
)
from cgs_tpu_torch.models.seeded import SeededCritic, SeededDecoder
from cgs_tpu_torch.sandbox import seed_parallel as sp
from cgs_tpu_torch.train.steps import make_optimizer
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

R = 2
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def jax_seeds():
    """(JAX critic, keys, numpy params) of `init_seed_params` for seeds
    0 and 1 with a sepcrit (jitted: one compile)."""
    jcritic, jmasker = jsp._build_models(
        JConfig(dropout=0.0).derive())
    keys = jax.vmap(jax.random.PRNGKey)(np.arange(R, dtype=np.uint32))
    params = jax.jit(lambda k: jsp.init_seed_params(
        jcritic, jmasker, k, separate=True))(keys)
    return jcritic, keys, jax.tree.map(np.asarray, params)


@pytest.fixture(scope="module")
def bank():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (32, 64, 64, 3), dtype=np.uint8)
    y = rng.random(32).astype(np.float32)
    return x, y


def test_seeded_critic_chunk_matches_jax(jax_seeds, bank, one_torch_thread):
    x, y = bank
    jcritic, keys, params = jax_seeds
    jcfg = JConfig(shift=0, dropout=0.0, batch_size=8).derive()
    idx = np.random.default_rng(1).integers(0, 32, (R, 3, 8)).astype(
        np.int32)
    tx = jax_make_optimizer()
    state = jsp.init_seed_state({"critic": params["critic"]}, tx)
    chunk = jsp.make_seeded_critic_chunk(jcfg, jcritic, tx)
    state, jlosses = chunk(state, jnp.asarray(x), jnp.asarray(y),
                           np.ones(3, bool), idx, keys)
    jparams = jax.tree.map(np.asarray, state.params["critic"])

    cfg = Config(shift=0, dropout=0.0, batch_size=8, device="cpu").derive()
    critic = SeededCritic(R, dropout=0.0)
    critic.load_state_dict(stack_seeds(params["critic"], CRITIC_KEYMAP))
    critic = critic.to(memory_format=torch.channels_last).train()
    opt = make_optimizer({"critic": critic})
    losses = sp.seeded_critic_chunk(
        cfg, critic, opt, torch.from_numpy(x), torch.from_numpy(y), idx,
        sp.SeedRng.seeded([0, 1], CPU))
    assert losses.shape == (R, 3)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                               rtol=1e-3)
    for r in range(R):
        got = unstack_seed(critic.state_dict(), r, R)
        want = state_dict_from_flax(
            jax.tree.map(lambda a: a[r], jparams), CRITIC_KEYMAP)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       atol=2e-4, err_msg=f"seed {r} {k}")


def test_stack_seeds_round_trip(jax_seeds):
    """JAX `init_seed_params` trees -> the seeded modules -> each seed's
    reference-layout state_dict, exactly; and back through
    `stack_state_dicts`."""
    params = jax_seeds[2]
    for name, keymap, cls in (("critic", CRITIC_KEYMAP, SeededCritic),
                              ("masker", DECODER_KEYMAP, SeededDecoder),
                              ("sepcrit", CRITIC_KEYMAP, SeededCritic)):
        stacked = stack_seeds(params[name], keymap)
        cls(R).load_state_dict(stacked)           # strict: every key fits
        per = [unstack_seed(stacked, r, R) for r in range(R)]
        for r in range(R):
            want = state_dict_from_flax(
                jax.tree.map(lambda a: a[r], params[name]), keymap)
            assert per[r].keys() == want.keys()
            for k in want:
                assert torch.equal(per[r][k], want[k]), (name, r, k)
        again = stack_state_dicts(per)
        assert all(torch.equal(again[k], stacked[k]) for k in stacked)
