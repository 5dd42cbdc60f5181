"""PyTorch port, training slice: augmentation, labels, data and the
contrastive split, against the JAX package on the same numpy seeds.

Exact where the code is a copy (frames, indices, splits, samplers);
labels within 1e-6 (the same float32 recursion, evaluated by numpy
here and by XLA there); the contrastive sweep's preds within 1e-5 (f32
conv sums reorder between XLA and PyTorch).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from cgs_tpu.core.config import Config as JConfig
from cgs_tpu.data.collect import collect_data as jax_collect_data
from cgs_tpu.data.collect import load_cache as jax_load_cache
from cgs_tpu.data.collect import save_cache as jax_save_cache
from cgs_tpu.data.loader import DataBundle as JBundle
from cgs_tpu.data.loader import EpochLoader as JLoader
from cgs_tpu.data.synthetic import synthetic_dataset as jax_synthetic_dataset
from cgs_tpu.ops.augment import shift_batch as jax_shift_batch
from cgs_tpu.ops.discount import build_label_matrix as jax_label_matrix
from cgs_tpu.train.contrastive import (
    extract_contrastive_sets as jax_extract_sets,
)
from cgs_tpu.train.contrastive import sample_index_stacks as jax_sample
from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.data.collect import (
    begin_filter, collect_data, load_cache, save_cache, trunk_filter,
)
from cgs_tpu_torch.data.loader import DataBundle, EpochLoader
from cgs_tpu_torch.data.synthetic import synthetic_dataset
from cgs_tpu_torch.ops.augment import draw_shift, shift_batch, shift_batch_by
from cgs_tpu_torch.ops.discount import build_label_matrix, discount_rewards
from cgs_tpu_torch.train.contrastive import (
    critic_sweep, extract_contrastive_sets, sample_index_stacks,
)
from torch_port_common import (  # noqa: F401 (one_torch_thread: fixture)
    jax_models, one_torch_thread, port_models, port_params,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_shift_batch_by_equals_jnp_roll():
    x = np.random.default_rng(0).integers(0, 256, (3, 8, 16, 3),
                                          dtype=np.uint8)
    for off in range(-12, 13):
        np.testing.assert_array_equal(
            shift_batch_by(torch.from_numpy(x), off).numpy(),
            np.asarray(jnp.roll(jnp.asarray(x), off, axis=2)))


def test_shift_batch_draws_the_reference_distribution():
    """One signed offset floor(12 U) with a random sign per batch: 0
    with probability 1/12, each of +-1..+-11 with 1/24 (main.py:585).
    The JAX package's draws have the same support."""
    gen = torch.Generator().manual_seed(0)
    n = 12000
    draws = np.asarray([draw_shift(12, gen) for _ in range(n)])
    values, counts = np.unique(draws, return_counts=True)
    assert set(values) == set(range(-11, 12))
    want = np.where(values == 0, n / 12, n / 24)
    # 5 sigma of a binomial count
    assert np.all(np.abs(counts - want) < 5 * np.sqrt(want))
    x = torch.arange(16, dtype=torch.uint8).reshape(1, 1, 16, 1)
    gen = torch.Generator().manual_seed(1)
    rolled = shift_batch(x, 12, gen)
    off = draw_shift(12, torch.Generator().manual_seed(1))
    assert torch.equal(rolled, torch.roll(x, off, dims=2))

    @jax.jit
    def jax_offset(key):
        y = jax_shift_batch(key, jnp.arange(16).reshape(1, 1, 16, 1), 12)
        return (y[0, 0, 0, 0] * -1) % 16           # the roll applied
    keys = jax.random.split(jax.random.PRNGKey(0), 600)
    jd = np.asarray(jax.vmap(jax_offset)(keys))
    assert set(np.unique(jd)) <= set(np.unique(draws % 16))


def test_label_matrix_equals_jax():
    rng = np.random.default_rng(1)
    reward = (rng.random(600) > 0.97).astype(np.float32)
    reward[-1] = 1.0
    gammas = (0.98, 0.97, 0.96, 0.95)
    ours = build_label_matrix(reward, gammas)
    theirs = np.asarray(jax_label_matrix(jnp.asarray(reward), gammas))
    assert ours.shape == theirs.shape == (7, 600) and ours.dtype == np.float32
    np.testing.assert_allclose(ours, theirs, atol=1e-6)
    assert np.all(ours <= 1.0) and not np.any(ours[5:])
    np.testing.assert_array_equal(discount_rewards(reward, 0.98), ours[1])


@pytest.mark.parametrize("variant", ["easy", "hard"])
def test_synthetic_dataset_equals_jax(variant):
    x, y, i = synthetic_dataset(600, seed=3, variant=variant)
    jx, jy, ji = jax_synthetic_dataset(600, seed=3, variant=variant)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(i, ji)
    np.testing.assert_allclose(y, jy, atol=1e-6)


def test_collect_caches_load_in_either_package(tmp_path):
    cfg = Config(synthetic_data=True, datasize=700, testsize=100).derive()
    jcfg = JConfig(synthetic_data=True, datasize=700,
                   testsize=100).derive()
    x, y, i = collect_data(cfg, datadir=str(tmp_path))
    jx, jy, ji = jax_collect_data(jcfg, datadir=str(tmp_path))  # our cache
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(i, ji)
    path = str(tmp_path / "theirs.pickle")
    jax_save_cache(path, x[:5], y[:, :5], i[:5])
    for got, want in zip(load_cache(path), (x[:5], y[:, :5], i[:5])):
        np.testing.assert_array_equal(got, want)
    path = str(tmp_path / "ours.pickle")
    save_cache(path, x[:5], y[:, :5], i[:5])
    for got, want in zip(jax_load_cache(path), (x[:5], y[:, :5], i[:5])):
        np.testing.assert_array_equal(got, want)
    with open(path + ".sha256", "w") as fp:     # a corrupted cache
        fp.write("0" * 64)
    with pytest.raises(RuntimeError, match="corrupted"):
        load_cache(path)
    # write=False collects without a cache
    cfg.datasize = 300
    collect_data(cfg, datadir=str(tmp_path / "nowrite"), write=False)
    assert not (tmp_path / "nowrite").exists()


def test_trajectory_filters_are_the_jax_ones():
    from cgs_tpu.data.collect import begin_filter as jb, trunk_filter as jt
    rng = np.random.default_rng(2)
    pov = rng.integers(0, 256, (300, 2, 2, 3), dtype=np.uint8)
    reward = (rng.random(300) > 0.95).astype(np.float32)
    for ours, theirs in ((trunk_filter(pov, reward), jt(pov, reward)),
                         (begin_filter(pov, reward), jb(pov, reward))):
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(a, b)


def test_bundle_and_epoch_loader_equal_jax():
    x, y, i = synthetic_dataset(700, seed=4)
    for threshrew in (0.0, 0.5):
        cfg = Config(testsize=100, threshrew=threshrew).derive()
        ours = DataBundle.from_arrays(x, y, i, cfg).to_device(cfg, "cpu")
        theirs = JBundle.from_arrays(x, y, i, JConfig(
            testsize=100, threshrew=threshrew).derive())
        for f in ("x_train", "y_train", "i_train", "x_test", "y_test",
                  "i_test"):
            np.testing.assert_array_equal(getattr(ours, f),
                                          getattr(theirs, f))
        assert ours.x_train_dev.dtype == torch.uint8
        np.testing.assert_array_equal(ours.y_train_dev.numpy(),
                                      ours.y_train[cfg.rewidx])
    for n, batch in ((600, 64), (30, 64), (640, 64)):
        a = EpochLoader(n, batch, np.random.default_rng(9))
        b = JLoader(n, batch, np.random.default_rng(9))
        for ca, cb in zip(list(a.chunks(4)) * 1, list(b.chunks(4))):
            np.testing.assert_array_equal(ca, cb)
    h, l, c = sample_index_stacks(np.random.default_rng(3), 50, 70, 9, 32)
    jh, jl, jc = jax_sample(np.random.default_rng(3), 50, 70, 9, 32)
    for a, b in ((h, jh), (l, jl), (c, jc)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == np.int32


def test_contrastive_sweep_and_split_equal_jax():
    jc, _, jp = jax_models()
    critic, _ = port_models()
    critic.load_state_dict(port_params(jp)["critic"])
    critic = critic.to(memory_format=torch.channels_last)
    x, y, _ = synthetic_dataset(300, seed=5)
    preds = critic_sweep(critic, torch.from_numpy(x), batch=128)
    assert critic.training                     # the mode is restored
    jpreds = np.asarray(jc.apply({"params": jp["critic"]},
                                 jnp.asarray(x, jnp.float32)
                                 * np.float32(1 / 255),
                                 deterministic=True)).squeeze(-1)
    np.testing.assert_allclose(preds, jpreds, atol=1e-5)
    # thresholds at the JAX preds' quantiles, away from any pred
    hi, lo = np.quantile(jpreds, [0.7, 0.3])
    over = dict(high_rew_thresh=float(hi), low_rew_thresh=float(lo))
    for random_split in (False, True):
        flags = dict(over, critic=not random_split, cload=not random_split)
        cfg, jcfg = Config(**flags).derive(), JConfig(**flags).derive()
        ours = extract_contrastive_sets(
            cfg, critic, torch.from_numpy(x), y[1],
            np.random.default_rng(6), min_count=10)
        theirs = jax_extract_sets(
            jcfg, jc, jp["critic"], jnp.asarray(x), y[1],
            np.random.default_rng(6), min_count=10)
        np.testing.assert_array_equal(ours.pos_mask, theirs.pos_mask)
        np.testing.assert_array_equal(ours.neg_mask, theirs.neg_mask)
        np.testing.assert_array_equal(ours.xpos.numpy(),
                                      np.asarray(theirs.xpos))
        np.testing.assert_array_equal(ours.yneg.numpy(),
                                      np.asarray(theirs.yneg))
        assert ours.n_pos == theirs.n_pos and ours.n_neg == theirs.n_neg
    cfg = dataclasses.replace(Config(**over).derive(), high_rew_thresh=0.99)
    with pytest.raises(AssertionError, match="contrastive split"):
        extract_contrastive_sets(cfg, critic, torch.from_numpy(x), y[1],
                                 np.random.default_rng(6), min_count=10)
