"""PyTorch port: `-orbax` train-state resume (`handler.py`,
`train/checkpoints.py:TrainStateManager`; the JAX package's
`OrbaxManager`, `cgs_tpu/train/checkpoints.py:66-103`, and
`cgs_tpu/handler.py:260-330,414-490`).

A phase broken at a save point and resumed in a fresh Handler ends
with exactly the parameters of a run that was not broken, with dropout
and the shift augmentation on: the critic phase resumes at the saved
epoch, the masker phase mid-epoch at the saved chunk (the break comes
through the metrics writer, as `tests/test_orbax_resume_e2e.py` breaks
the JAX package's). The port also restores the critic phase's batch
order (`self.rng`), which the JAX package does not save.
"""

import numpy as np
import pytest
import torch

from cgs_tpu_torch import cli
from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.handler import CRITIC, MASKER, Handler
from cgs_tpu_torch.train.checkpoints import TrainStateManager
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)


def _cfg(model, **kw):
    base = dict(train=True, synthetic_data=True, datasize=1100,
                testsize=100, cepochs=3, mepochs=2, visevery=3,
                dropout=0.5, shift=4, orbax=True, high_rew_thresh=0.55,
                low_rew_thresh=0.45, contrastive_min=5, model=model,
                device="cpu")
    base.update(kw)
    return Config(**base).derive()


def _break_after(handler, kind, n):
    """Make the n-th metrics row of `kind` raise, as a crash would."""
    real, seen = handler.metrics.write, {"n": 0}

    def write(k, **kw):
        real(k, **kw)
        if k == kind:
            seen["n"] += 1
            if seen["n"] == n:
                raise KeyboardInterrupt("simulated crash")

    handler.metrics.write = write


def _equal(a, b, what):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(),
                                      err_msg=f"{what} {k}")


@pytest.fixture()
def workdir(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    return tmp_path


def test_critic_resume_equals_uninterrupted(workdir, capsys,
                                            one_torch_thread):
    ref = Handler(_cfg("cref", mepochs=0), primary=False)
    ref.load_data()
    ref.critic_pipe()
    want = ref.params[CRITIC]

    h1 = Handler(_cfg("cres", mepochs=0), primary=False)
    h1.load_data()
    _break_after(h1, "critic_loss", 2)    # in epoch 2: epoch 1 is saved
    with pytest.raises(KeyboardInterrupt):
        h1.critic_pipe()
    assert TrainStateManager("cres/saves/orbax-critic").steps() == [1]

    h2 = Handler(_cfg("cres", mepochs=0), primary=False)
    h2.load_data()
    h2.critic_pipe()
    assert "orbax resume: critic epoch 1" in capsys.readouterr().out
    assert h2.loss_log[CRITIC].shape == (2 * 18,)   # epochs 2 and 3 only
    _equal(h2.params[CRITIC], want, "critic")
    # the batch order continues too: the next draw of self.rng agrees
    assert h2.rng.integers(1 << 30) == ref.rng.integers(1 << 30)


def test_masker_resume_mid_epoch_equals_uninterrupted(workdir, capsys,
                                                      one_torch_thread):
    kw = dict(cepochs=6, batch_size=32, visevery=2)
    ref = Handler(_cfg("mref", **kw), primary=False)
    ref.load_data()
    ref.critic_pipe()
    ref.segmentation_training()
    steps_per_epoch = -(-ref.contrastive.n_pos // 32)
    assert steps_per_epoch > 4, "want several chunks per masker epoch"

    h1 = Handler(_cfg("mres", **kw), primary=False)
    h1.load_data()
    h1.critic_pipe()
    _break_after(h1, "masker_loss", 3)    # chunks 1 and 2 are saved
    with pytest.raises(KeyboardInterrupt):
        h1.segmentation_training()
    ckpt = TrainStateManager("mres/saves/orbax-masker")
    assert ckpt.steps() == [2, 4]

    h2 = Handler(_cfg("mres", **kw), primary=False)
    h2.load_data()
    h2.critic_pipe()
    h2.segmentation_training()
    out = capsys.readouterr().out
    assert "orbax resume: critic epoch 6" in out
    assert "orbax resume: masker epoch 0 step 4" in out
    assert h2.loss_log[MASKER].shape[0] == 2 * steps_per_epoch - 4
    for name in (MASKER, CRITIC):
        _equal(h2.params[name], ref.params[name], name)
    # the newest 3 saves are kept, keyed by the global step
    assert ckpt.steps()[-1] == 2 * steps_per_epoch
    assert len(ckpt.steps()) == 3


def test_train_state_manager_keeps_newest_and_restores(tmp_path):
    mgr = TrainStateManager(str(tmp_path / "ts"), max_to_keep=3)
    assert mgr.latest_step() is None and mgr.restore() is None
    gen = torch.Generator().manual_seed(1)
    nrng = np.random.default_rng(2)
    for step in (4, 8, 12, 16):
        mgr.save(step, {"w": torch.full((2,), float(step)),
                        "gen": gen.get_state(),
                        "np": nrng.bit_generator.state})
    assert mgr.steps() == [8, 12, 16] and mgr.latest_step() == 16
    step, state = mgr.restore()
    assert step == 16 and state["step"] == 16
    assert torch.equal(state["w"], torch.full((2,), 16.0))
    g2 = torch.Generator()
    g2.set_state(state["gen"])
    assert torch.equal(torch.rand(3, generator=g2),
                       torch.rand(3, generator=gen))
    n2 = np.random.default_rng(0)
    n2.bit_generator.state = state["np"]
    assert n2.random() == nrng.random()
    assert len(mgr.save_seconds) == 4


def test_orbax_no_longer_raises(workdir):
    handler = cli.main(["-orbax", "--device", "cpu", "-synthetic_data"],
                       primary=False)
    assert isinstance(handler, Handler) and handler.cfg.orbax
