"""PyTorch port: data parallelism over ranks with torch.distributed
(`cgs_tpu_torch/parallel/`), two gloo ranks on the CPU.

The ranks are started by the port's launcher (`parallel.multihost.
launch`: this process is rank 0, rank 1 a spawned process that imports
only the port) and run the port's probes (`parallel/probes.py`). Each
launch has its own `file://` rendezvous, a timeout on every collective
and a limit on every join.

Against the JAX package's meshed steps (`make_*_step(..., mesh=
make_mesh(n_data=2))` on this process's virtual CPU devices), with the
same weights and numpy inputs, and JAX's own DP-vs-single tolerances
(`tests/test_distributed.py:56-112`): loss rtol 1e-5, parameters atol
1e-6. World size 1 through the DP code is bit-equal to the unmeshed
chunk; a batch that does not divide runs whole on every rank and equals
the unmeshed step bit for bit (rank 0's gradient is broadcast).
"""

import time

import jax
import numpy as np
import pytest
import torch

from cgs_tpu.core.config import Config as JConfig
from cgs_tpu.parallel.mesh import data_sharding, make_mesh, \
    replicated_sharding
from cgs_tpu.pipeline import MaskPipeline as JPipeline
from cgs_tpu.train.steps import (
    init_train_state, make_critic_step, make_masker_step,
    make_optimizer as jax_optimizer,
)
from cgs_tpu_torch.parallel import multihost, probes
from cgs_tpu_torch.parallel.mesh import (
    Mesh, ensemble_mesh_or_none, pad_to_multiple, seed_shard_tree,
)
from cgs_tpu_torch.train.steps import StepRng
from torch_port_common import (  # noqa: F401 (fixture)
    jax_models, one_torch_thread, port_params,
)

KEY = jax.random.PRNGKey(0)
CPU = torch.device("cpu")


def _launch(fn, args, world=2, gather=True, timeout_s=120.0):
    return multihost.launch(fn, world, args, device="cpu", gather=gather,
                            timeout_s=timeout_s, join_s=60.0)


def _batch(n):
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    b = rng.integers(0, 256, (n, 64, 64, 3), dtype=np.uint8)
    return a, rng.random(n).astype(np.float32), b


TIMINGS = ("critic_s", "masker_s", "allreduce_ms", "allreduce_bytes")


def _same(x, y):
    """Equal, bit for bit (a probe's timings aside)."""
    if isinstance(x, dict):
        keys = set(x) - set(TIMINGS)
        return keys == set(y) - set(TIMINGS) and all(
            _same(x[k], y[k]) for k in keys)
    if isinstance(x, torch.Tensor):
        return torch.equal(x, y)
    return np.array_equal(x, y)


def _params():
    _, _, jp = jax_models()
    return jp, port_params({"critic": jp["critic"], "masker": jp["masker"]})


def _assert_params_close(port_state, jax_tree, atol):
    ours = port_params(jax.tree.map(np.asarray, jax_tree))
    for name, state in ours.items():
        for k, v in state.items():
            np.testing.assert_allclose(port_state[name][k].numpy(),
                                       v.numpy(), atol=atol,
                                       err_msg=f"{name} {k}")


def test_rank_rows_follow_index_sharding():
    """The rule of `cgs_tpu/parallel/mesh.py:index_sharding`, as
    `tests/test_dp_product.py:199` pins it for 8 devices: 32 and 64
    split, 30 and 4 run whole on every rank."""
    for world in (2, 8):
        meshes = [Mesh(rank=r, world=world, device=CPU)
                  for r in range(world)]
        for n in (32, 64):
            rows = [m.rows(n) for m in meshes]
            assert all(m.divides(n) for m in meshes)
            assert [(s.start, s.stop) for s in rows] == [
                (r * n // world, (r + 1) * n // world)
                for r in range(world)]
        for n in (30, 4) if world == 8 else (15,):
            assert all(m.rows(n) == slice(0, n) and not m.divides(n)
                       for m in meshes)
    assert pad_to_multiple(37, 8) == 40 and pad_to_multiple(40, 8) == 40
    assert Mesh(rank=1, world=2, device=CPU).shape == {"data": 2}
    m1 = Mesh(rank=1, world=2, device=CPU)
    assert seed_shard_tree(m1, list("abcd")) == ["c", "d"]
    with pytest.raises(ValueError, match="R % ranks"):
        seed_shard_tree(m1, list("abc"))
    assert ensemble_mesh_or_none(m1, 4) is m1
    assert ensemble_mesh_or_none(m1, 3) is None
    assert ensemble_mesh_or_none(None, 3) is None


def test_mesh_collectives():
    """max, mean, broadcast, assembled rows and gathered objects over two
    ranks (rank r holds values * (r + 1))."""
    got = _launch(probes.collectives, ([3.0, 1.0, 2.0, 4.0],))
    for r in got:
        assert r["max"] == 6
        np.testing.assert_array_equal(r["mean"], [4.5, 1.5, 3.0, 6.0])
        np.testing.assert_array_equal(r["bcast"], [3.0, 1.0, 2.0, 4.0])
        np.testing.assert_array_equal(r["whole"], [3.0, 1.0, 4.0, 8.0])
    assert got[0]["gathered"] == [0, 1] and got[1]["gathered"] is None


def test_world_one_is_bit_equal_to_unmeshed(one_torch_thread):
    """An all_reduce over one rank and a division by 1.0 are exact: the
    critic and masker chunks through the DP code equal the unmeshed
    ones bit for bit (in this process, no spawn)."""
    _, pp = _params()
    a, y, b = _batch(16)
    ref = probes.steps(pp, a, y, b, meshed=False, device="cpu")
    dp = _launch(probes.steps, (pp, a, y, b), world=1, gather=False)
    assert _same(ref, dp)


def test_two_ranks_match_jax_meshed_steps(one_torch_thread):
    """One critic step and one masker step (dropout 0, shift 0) on two
    gloo ranks against the JAX package's steps over a 2-device mesh, and
    both ranks hold the same parameters afterwards."""
    jp, pp = _params()
    critic, masker, _ = jax_models()
    a, y, b = _batch(16)
    ours = _launch(probes.steps, (pp, a, y, b))
    assert _same(ours[0], ours[1])
    ours = ours[0]

    mesh = make_mesh(n_data=2)
    sh, repl = data_sharding(mesh), replicated_sharding(mesh)
    tx = jax_optimizer()
    cfg = JConfig(shift=0, dropout=0.0)
    state = init_train_state(jax.device_put({"critic": jp["critic"]}, repl),
                             tx)
    state, loss = make_critic_step(cfg, critic, tx, mesh=mesh)(
        state, jax.device_put(a, sh), jax.device_put(y, sh), KEY)
    np.testing.assert_allclose(ours["critic_loss"][0], float(loss),
                               rtol=1e-5)
    _assert_params_close({"critic": ours["critic"]}, state.params, 1e-6)

    cfg = JConfig(shift=0, dropout=0.0).derive()
    state = init_train_state(
        jax.device_put({"critic": jp["critic"], "masker": jp["masker"]},
                       repl), tx, ["masker", "critic"])
    state, metrics = make_masker_step(cfg, critic, masker, tx, mesh=mesh)(
        state, jax.device_put(a, sh), jax.device_put(y, sh),
        jax.device_put(b, sh), KEY)
    for i, key in enumerate(("replace", "inject", "norm", "critic")):
        np.testing.assert_allclose(ours["masker_terms"][i],
                                   float(metrics[key]), rtol=1e-5,
                                   atol=1e-9, err_msg=key)
    _assert_params_close(ours["masker"], state.params, 1e-6)


def test_batch_that_does_not_divide_runs_whole(one_torch_thread):
    """15 rows over 2 ranks (and a masker K of 7): every rank runs the
    whole batch and rank 0's gradient is broadcast, so the result is
    the unmeshed step's, bit for bit
    (`tests/test_distributed.py:114` for the JAX package)."""
    _, pp = _params()
    a, y, b = _batch(15)
    ref = probes.steps(pp, a, y, b, meshed=False, device="cpu")
    ours = _launch(probes.steps, (pp, a, y, b))
    assert _same(ours[0], ref) and _same(ours[1], ref)


def test_reduced_iou_counts_equal_the_host(one_torch_thread):
    """The eval's `threshold_iou` counts of each rank's rows, summed over
    the ranks, give the host numpy IoU (`tests/test_distributed.py:140`);
    a set that does not divide is counted whole on every rank."""
    rng = np.random.default_rng(0)
    for n in (16, 15):
        masks = rng.random((n, 64, 64), dtype=np.float32)
        gt = rng.random((n, 64, 64)) > 0.5
        host = (((masks > 0.5) & gt).sum() / ((masks > 0.5) | gt).sum())
        got = _launch(probes.iou, (masks, gt, 0.5))
        for r in got:
            assert r["kernel"] == r["host"] == round(float(host), 3)


def test_dropout_streams_per_rank():
    """Rank 0 draws the serial stream (world 1 is the serial run); rank 1
    draws another."""
    draws = _launch(probes.dropout_draws, (7,))
    serial = torch.rand(64, generator=StepRng.seeded(7, CPU).dropout)
    np.testing.assert_array_equal(draws[0], serial.numpy())
    assert not np.array_equal(draws[0], draws[1])


def test_pipeline_over_two_ranks_matches_jax(one_torch_thread):
    """MaskPipeline over two ranks (batch 16 padded even, a ragged tail
    of 40 frames) against the JAX package's plain pipeline
    (`tests/test_dp_product.py:171`, atol 1e-5); every rank gets the
    whole output. The seed-sharded ensemble (R = 2 over 2 ranks) equals
    the unmeshed ensemble bit for bit; R = 3 runs unmeshed."""
    critic, masker, jp = jax_models()
    _, pp = _params()
    frames = np.random.default_rng(4).integers(0, 256, (40, 64, 64, 3),
                                               dtype=np.uint8)
    want = JPipeline(critic, masker, {"critic": jp["critic"],
                                      "masker": jp["masker"]},
                     batch_size=16).run(frames)
    got = _launch(probes.pipeline, (pp, frames, 16))
    assert _same(got[0], got[1])
    np.testing.assert_allclose(got[0]["preds"], np.asarray(want.preds),
                               atol=1e-5)
    np.testing.assert_allclose(got[0]["masks"], np.asarray(want.masks),
                               atol=1e-5)

    _, _, jp2 = jax_models(seed=1)
    _, _, jp3 = jax_models(seed=2)
    members = [pp] + [port_params({"critic": j["critic"],
                                   "masker": j["masker"]})
                      for j in (jp2, jp3)]
    for r in (2, 3):
        ref = probes.pipeline(members[:r], frames, 16, ensemble=True,
                              meshed=False, device="cpu")
        got = _launch(probes.pipeline, (members[:r], frames, 16, 1, True))
        assert _same(got[0], ref) and _same(got[1], ref), r


def test_a_dead_rank_fails_the_run_without_hanging():
    """Rank 1 raises while rank 0 waits in a collective: rank 0 raises
    too, well inside the collective timeout."""
    t0 = time.perf_counter()
    with pytest.raises(Exception):
        multihost.launch(probes.fail_on_rank, 2, (1, 1.0), device="cpu",
                         timeout_s=60.0, join_s=30.0)
    assert time.perf_counter() - t0 < 55.0
    assert not multihost.joined()
