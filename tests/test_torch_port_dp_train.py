"""PyTorch port, data parallelism over two gloo ranks on the CPU: what
comes from disk and what goes to it (`handler.py`, `train/
checkpoints.py`), and the seed-parallel runner with its seeds sharded
over the ranks (`sandbox/seed_parallel.py:run_parallel(mesh=...)`).

Each rank runs in a directory of its own, so what a rank reads and
writes shows: rank 0's disk decides every load, only rank 0 writes, and
an -orbax run broken on both ranks and resumed ends with the parameters
of an uninterrupted run, each rank's dropout stream restored.
"""

import numpy as np
import pytest
import torch

from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.parallel import multihost, probes
from cgs_tpu_torch.train.checkpoints import checkpoint_paths, save_model_pt
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

SP_TOL = 2e-4     # the seed-parallel runner's tolerance (chip_smoke.py)


def _launch(fn, args):
    return multihost.launch(fn, 2, args, device="cpu", gather=True,
                            timeout_s=120.0, join_s=60.0)


def _dirs(tmp_path):
    dirs = [tmp_path / f"rank{r}" for r in range(2)]
    for d in dirs:
        d.mkdir()
    return [str(d) for d in dirs]


def _equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_rank0_disk_decides_every_load(tmp_path, one_torch_thread):
    """Only rank 0's directory holds the critic: both ranks load it. A
    load that fails part-way (no masker file) is False on both ranks,
    which both hold rank 0's partly loaded params."""
    dirs = _dirs(tmp_path)
    cfg = Config(model="ld", device="cpu").derive()
    state = Critic().state_dict()
    torch.manual_seed(5)
    state = {k: torch.randn_like(v) for k, v in state.items()}
    save_model_pt(state, "critic",
                  f"{dirs[0]}/{checkpoint_paths(cfg)['critic']}")
    for names, ok in ((("critic",), True), (("critic", "masker"), False)):
        got = _launch(probes.load_models, (cfg, dirs, names))
        for r in got:
            assert r["ok"] is ok
            _equal(r["params"]["critic"], state)
        if not ok:
            _equal(got[0]["params"]["masker"], got[1]["params"]["masker"])


def test_orbax_resume_over_two_ranks_and_only_rank0_writes(
        tmp_path, one_torch_thread):
    """-orbax at world 2, dropout 0.5 and shift 4: the critic phase
    broken in epoch 2 on both ranks and resumed equals the uninterrupted
    run on both ranks, bit for bit; rank 0 alone wrote the train states
    (each rank's dropout state inside), rank 1's directory stays
    empty."""
    dirs = _dirs(tmp_path)
    cfg = Config(train=True, synthetic_data=True, datasize=1100,
                 testsize=100, cepochs=3, mepochs=0, dropout=0.5, shift=4,
                 orbax=True, device="cpu").derive()
    got = _launch(probes.resume, (cfg, dirs))
    for r in got:
        _equal(r["res"]["critic"], r["ref"]["critic"])
        assert r["rows"] == 2 * 18      # epochs 2 and 3 only
    _equal(got[0]["res"]["critic"], got[1]["res"]["critic"])
    assert got[0]["saved"] == [1]
    assert got[1]["files"] == []
    assert any(f.startswith("res/saves/orbax-critic/step-")
               for f in got[0]["files"])
    state = torch.load(f"{dirs[0]}/res/saves/orbax-critic/step-3.pt",
                       weights_only=True)
    assert len(state["dropout_ranks"]) == 2
    assert not torch.equal(*state["dropout_ranks"])


def test_run_parallel_seeds_over_two_ranks(tmp_path, monkeypatch,
                                           one_torch_thread):
    """R = 2 over 2 ranks, one seed each (one critic epoch, two masker
    steps; a split at 0.0 / 1.0 keeps every frame on both sides). Rank r
    runs exactly seed r's unmeshed R = 1 run: its losses and params are
    those, bit for bit, and rank 0 gathers both seeds'. Against the
    unmeshed R = 2 run, every loss within SP_TOL, step by step (a
    seed's convolutions at R = 1 and at R = 2 round apart; Adam steps
    by ~lr on a gradient near 0, so the params' gap is not held to it,
    as `chip_smoke.py` only logs Adam's gap)."""
    from cgs_tpu_torch.data.synthetic import (
        synthetic_dataset, synthetic_eval_set,
    )
    from cgs_tpu_torch.models.interop import unstack_seed

    monkeypatch.chdir(tmp_path)
    cfg = Config(shift=4, dropout=0.0, batch_size=32, cepochs=1,
                 mepochs=1, testsize=100, high_rew_thresh=0.0,
                 low_rew_thresh=1.0, contrastive_min=5, model="sp",
                 device="cpu").derive()
    x, y, _ = synthetic_dataset(n_frames=1200, seed=0)
    xe, gt = synthetic_eval_set(n_frames=40, seed=99)
    kw = dict(masker_steps=2)
    ref = probes.run_parallel(cfg, x, y, 2, 3, xe, gt, meshed=False, **kw)
    singles = [probes.run_parallel(cfg, x, y, 1, s, xe, gt, meshed=False,
                                   **kw) for s in (3, 4)]
    got = _launch(probes.run_parallel, (cfg, x, y, 2, 3, xe, gt, True, 2))
    out = got[0]
    assert out["steps"] == ref["steps"] == {"critic": 35, "masker": 2}
    assert got[1]["seeds"] == [4] and out["seeds"] == [3, 4]
    assert out["contrastive"] == ref["contrastive"]
    for r, single in enumerate(singles):
        for key in ("critic_losses", "masker_losses"):
            np.testing.assert_array_equal(out[key][r:r + 1], single[key])
        for name, state in single["params"].items():
            _equal(unstack_seed(out["params"][name], r, 2),
                   unstack_seed(state, 0, 1))
        assert out["ious"][r] == single["ious"][0]
    for key in ("critic_losses", "masker_losses"):
        np.testing.assert_allclose(out[key], ref[key], atol=SP_TOL,
                                   err_msg=key)
    np.testing.assert_allclose(out["ious"], ref["ious"], atol=0.01)
    assert abs(out["ensemble_iou"] - ref["ensemble_iou"]) < 0.01


def test_run_parallel_refuses_seeds_that_do_not_divide():
    from cgs_tpu_torch.parallel.mesh import Mesh
    from cgs_tpu_torch.sandbox import seed_parallel as sp

    with pytest.raises(ValueError, match="divide"):
        sp.run_parallel(Config(device="cpu").derive(), None, None, 3,
                        mesh=Mesh(rank=0, world=2,
                                  device=torch.device("cpu")))
