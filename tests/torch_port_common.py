"""Shared set-up of the PyTorch port's parity tests: one set of JAX
weights, made from a seed, handed to both packages."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from cgs_tpu.models.critic import Critic as JCritic
from cgs_tpu.models.decoder import UnetDecoder as JDecoder
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.models.interop import (
    CRITIC_KEYMAP, DECODER_KEYMAP, state_dict_from_flax,
)


@pytest.fixture
def one_torch_thread():
    """Run the test's PyTorch ops on one thread. The suite runs in
    several processes on a few cores; a multi-threaded training loop of
    many small ops then waits at every op's thread barrier, and runs
    many times slower than on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_models(chfak=1, dropout=0.0, bf16=False, seed=0):
    """(JAX critic, JAX masker, params as numpy trees, with a 'sepcrit'
    of its own) at `chfak`. Cached: callers must not mutate."""
    return _jax_models(chfak, dropout, bf16, seed)


@functools.lru_cache(maxsize=None)
def _jax_models(chfak, dropout, bf16, seed):
    cdt = jnp.bfloat16 if bf16 else jnp.float32
    critic = JCritic(chfak=chfak, dropout=dropout, compute_dtype=cdt)
    masker = JDecoder(chfak=chfak, compute_dtype=cdt)
    x0 = jnp.zeros((2, 64, 64, 3))

    @jax.jit
    def init(key):
        k1, k2, k3 = jax.random.split(key, 3)
        cp = critic.init({"params": k1}, x0, collect=True)["params"]
        _, em = critic.apply({"params": cp}, x0, collect=True)
        mp = masker.init({"params": k2}, x0, em)["params"]
        sp = critic.init({"params": k3}, x0, collect=True)["params"]
        return {"critic": cp, "masker": mp, "sepcrit": sp}

    params = init(jax.random.PRNGKey(seed))
    return critic, masker, jax.tree.map(np.asarray, params)


def port_params(jparams):
    """The JAX param trees as the port's state_dicts."""
    return {name: state_dict_from_flax(
        tree, DECODER_KEYMAP if name == "masker" else CRITIC_KEYMAP)
        for name, tree in jparams.items()}


def port_models(chfak=1, dropout=0.0, bf16=False):
    cdt = torch.bfloat16 if bf16 else torch.float32
    return (Critic(chfak=chfak, dropout=dropout, compute_dtype=cdt),
            UnetDecoder(chfak=chfak, compute_dtype=cdt))


def nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    """NHWC numpy frames -> NCHW channels_last view (no copy)."""
    return torch.from_numpy(np.ascontiguousarray(x_nhwc)).permute(0, 3, 1, 2)


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().permute(0, 2, 3, 1).numpy()
