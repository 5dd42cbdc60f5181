"""PyTorch port: each seed of the seed-parallel runner draws its dropout
masks from a generator of its own (`sandbox/seed_parallel.py:SeedRng`,
`models/seeded.py:seeded_dropout`).

On the CPU, at chfak 1 and dropout 0.5, with the shifts drawn (--shift
4): R = 3 seeded masker and critic steps against the serial
`masker_step` / `critic_step` of each seed with `StepRng.seeded(seed)`,
which draws the same shifts and, since repair, the same dropout masks;
and seed 2 trained at R = 1 against its slot at R = 3. Loss terms and
parameters within 1e-5, as `test_torch_port_seed_parallel.py` holds the
dropout-0 steps (a grouped convolution sums as the R single ones do, up
to the order of a few float32 sums).
"""

import numpy as np
import pytest
import torch

from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.models.critic import Critic, dropout
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.models.interop import unstack_seed
from cgs_tpu_torch.models.seeded import (
    SeededCritic, SeededDecoder, seeded_dropout,
)
from cgs_tpu_torch.ops.kernels import Segment
from cgs_tpu_torch.sandbox import seed_parallel as sp
from cgs_tpu_torch.train.steps import (
    StepRng, critic_step, make_optimizer, masker_step,
)
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

CPU = torch.device("cpu")
P = 0.5
SEEDS = [0, 1, 2]
TOL = 1e-5


@pytest.fixture(scope="module")
def bank():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (32, 64, 64, 3), dtype=np.uint8)
    y = rng.random(32).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.fixture(scope="module")
def cfg():
    return Config(shift=4, dropout=P, device="cpu").derive()


def _seeded_models(seeds, init):
    r = len(seeds)
    critic, masker = SeededCritic(r, dropout=P), SeededDecoder(r)
    critic.load_state_dict(init["critic"])
    masker.load_state_dict(init["masker"])
    return {n: m.to(memory_format=torch.channels_last).train()
            for n, m in (("critic", critic), ("masker", masker))}


def _serial_models(init, r, seeds):
    out = {}
    for name in ("critic", "masker"):
        m = UnetDecoder() if name == "masker" else Critic(dropout=P)
        m.load_state_dict(unstack_seed(init[name], r, seeds))
        out[name] = m.to(memory_format=torch.channels_last).train()
    return out


def _rows(seeds, s):
    """Each seed's (S, K), (S, K), (S, 2K) masker rows, drawn from its
    seed, so a seed's rows do not depend on the other seeds."""
    h, l, c = [], [], []
    for seed in seeds:
        g = np.random.default_rng(100 + seed)
        h.append(g.integers(0, 32, (s, 32)))
        l.append(g.integers(0, 32, (s, 32)))
        c.append(g.integers(0, 32, (s, 64)))
    return np.stack(h), np.stack(l), np.stack(c)


def _seeded_masker(cfg, bank, seeds, steps=2):
    x, y = bank
    init = sp.init_seed_params(Critic(), UnetDecoder(), seeds)
    models = _seeded_models(seeds, init)
    opt = make_optimizer({"masker": models["masker"]})
    models["critic"].requires_grad_(False)
    h, l, c = _rows(seeds, steps)
    terms = sp.seeded_masker_chunk(cfg, models, opt, x, y, h, l, c,
                                   sp.SeedRng.seeded(seeds, CPU))
    return init, models, terms, (h, l, c)


def test_seeded_dropout_is_each_seeds_serial_mask():
    """The grouped activation's seed r channels and the head's row r
    hold the mask the serial dropout draws from seed r's generator on
    that seed's activation alone."""
    g = torch.Generator().manual_seed(3)
    x = torch.rand((6, 3 * 4, 5, 7), generator=g).contiguous(
        memory_format=torch.channels_last)
    got = seeded_dropout(x, P, True, [torch.Generator().manual_seed(s)
                                      for s in SEEDS])
    assert got.is_contiguous(memory_format=torch.channels_last)
    for r, s in enumerate(SEEDS):
        xr = x[:, 4 * r:4 * (r + 1)].contiguous(
            memory_format=torch.channels_last)
        want = dropout(xr, P, True, torch.Generator().manual_seed(s))
        assert torch.equal(got[:, 4 * r:4 * (r + 1)], want)
    h = torch.rand((3, 6, 8), generator=g)
    got = seeded_dropout(h, P, True, [torch.Generator().manual_seed(s)
                                      for s in SEEDS])
    for r, s in enumerate(SEEDS):
        assert torch.equal(got[r], dropout(h[r], P, True,
                                           torch.Generator().manual_seed(s)))
    with pytest.raises(ValueError, match="generator per seed"):
        seeded_dropout(h, P, True, None)


def test_seeded_masker_steps_match_serial_per_seed(cfg, bank,
                                                   one_torch_thread):
    """R = 3, dropout 0.5, shifts drawn: each seed's terms and trained
    decoder equal its serial steps' (seeded with its seed)."""
    x, y = bank
    init, models, terms, (h, l, c) = _seeded_masker(cfg, bank, SEEDS)
    assert terms.shape == (3, 2, 4)
    assert float(terms[..., 0].std()) > 0      # the seeds differ
    for r, seed in enumerate(SEEDS):
        smodels = _serial_models(init, r, 3)
        smodels["critic"].requires_grad_(False)
        sopt = make_optimizer({"masker": smodels["masker"]})
        rng = StepRng.seeded(seed, CPU)
        for s in range(2):
            a = [Segment(x, torch.from_numpy(h[r, s]), labels=y),
                 Segment(x, torch.from_numpy(l[r, s]), labels=y)]
            want = masker_step(cfg, smodels, sopt, a,
                               Segment(x, torch.from_numpy(c[r, s])), rng)
            np.testing.assert_allclose(terms[r, s].numpy(),
                                       torch.stack(want).numpy(), atol=TOL,
                                       err_msg=f"seed {seed} step {s}")
        got = unstack_seed(models["masker"].state_dict(), r, 3)
        for k, v in smodels["masker"].state_dict().items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=TOL,
                                       err_msg=f"seed {seed} masker.{k}")


def test_seeded_critic_steps_match_serial_per_seed(cfg, bank,
                                                   one_torch_thread):
    x, y = bank
    init = sp.init_seed_params(Critic(), UnetDecoder(), SEEDS)
    critic = _seeded_models(SEEDS, init)["critic"]
    opt = make_optimizer({"critic": critic})
    idx = np.stack([np.random.default_rng(200 + s).integers(0, 32, (3, 16))
                    for s in SEEDS])                      # (R, S, B)
    losses = sp.seeded_critic_chunk(cfg, critic, opt, x, y, idx,
                                    sp.SeedRng.seeded(SEEDS, CPU))
    for r, seed in enumerate(SEEDS):
        scritic = _serial_models(init, r, 3)["critic"]
        sopt = make_optimizer({"critic": scritic})
        rng = StepRng.seeded(seed, CPU)
        want = [float(critic_step(cfg, scritic, sopt,
                                  Segment(x, torch.from_numpy(idx[r, s]),
                                          labels=y), rng))
                for s in range(3)]
        np.testing.assert_allclose(losses[r].numpy(), want, atol=TOL,
                                   err_msg=f"seed {seed}")
        got = unstack_seed(critic.state_dict(), r, 3)
        for k, v in scritic.state_dict().items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=TOL,
                                       err_msg=f"seed {seed} critic.{k}")


def test_seed_result_does_not_depend_on_r(cfg, bank, one_torch_thread):
    """Seed 2 after 3 masker steps alone (R = 1) and in the slot of
    R = 3: the same terms and decoder."""
    _, alone, t1, _ = _seeded_masker(cfg, bank, [2], steps=3)
    _, three, t3, _ = _seeded_masker(cfg, bank, SEEDS, steps=3)
    np.testing.assert_allclose(t1[0].numpy(), t3[2].numpy(), atol=TOL)
    got = unstack_seed(three["masker"].state_dict(), 2, 3)
    for k, v in alone["masker"].state_dict().items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), atol=TOL,
                                   err_msg=f"masker.{k}")
    # and not on the base seed: seeds 1..3 hold seed 2 in slot 1
    _, _, t_b, _ = _seeded_masker(cfg, bank, [1, 2, 3], steps=3)
    np.testing.assert_allclose(t1[0].numpy(), t_b[1].numpy(), atol=TOL)
