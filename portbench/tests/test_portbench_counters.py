"""The FLOP and byte counters against counts made by hand, and the
seeded weights against the port's state-dict keys and shapes."""

import json

import pytest
import torch
from _small import ROOT

from portbench.lib import flops, shapes, weights


def config(name):
    return json.loads((ROOT / "portbench" / "configs" / f"{name}.json")
                      .read_text())


def conv(hw, cout, cin, k):
    return hw * hw * cout * cin * k * k


# by hand from nets.py's layer list: 3x3 convs with padding 1, the 4x4
# VALID bottleneck conv, two linears; the decoder's 1x1, four 3x3 over
# the joins, the mask head's 3x3 pair
HAND = {
    "chfak5": {
        "critic": conv(64, 40, 3, 3) + conv(32, 40, 40, 3)
        + conv(16, 40, 40, 3) + conv(8, 80, 40, 3) + conv(1, 160, 80, 4)
        + 160 * 160 + 160,
        "decoder": conv(1, 160, 160, 1) + conv(4, 80, 240, 3)
        + conv(8, 40, 120, 3) + conv(16, 40, 80, 3) + conv(32, 40, 80, 3)
        + conv(64, 16, 43, 3) + conv(64, 1, 16, 3),
        # elements a frame of the five joins: skip + x + joined
        "joins": (80 * 16 + 160 + 240 * 16) + (40 * 64 + 80 * 16 + 120 * 64)
        + (40 * 256 + 40 * 64 + 80 * 256)
        + (40 * 1024 + 40 * 256 + 80 * 1024)
        + (3 * 4096 + 40 * 1024 + 43 * 4096),
    },
    "chfak1": {
        "critic": conv(64, 8, 3, 3) + conv(32, 8, 8, 3) + conv(16, 8, 8, 3)
        + conv(8, 16, 8, 3) + conv(1, 32, 16, 4) + 32 * 32 + 32,
        "decoder": conv(1, 32, 32, 1) + conv(4, 16, 48, 3)
        + conv(8, 8, 24, 3) + conv(16, 8, 16, 3) + conv(32, 8, 16, 3)
        + conv(64, 16, 11, 3) + conv(64, 1, 16, 3),
        "joins": (16 * 16 + 32 + 48 * 16) + (8 * 64 + 16 * 16 + 24 * 64)
        + (8 * 256 + 8 * 64 + 16 * 256) + (8 * 1024 + 8 * 256 + 16 * 1024)
        + (3 * 4096 + 8 * 1024 + 11 * 4096),
    },
}


@pytest.mark.parametrize("name", sorted(HAND))
def test_macs_by_hand(name):
    cfg, hand = config(name), HAND[name]
    assert flops.critic_macs(cfg) == hand["critic"]
    assert flops.decoder_macs(cfg) == hand["decoder"]
    assert flops.process_flops_per_frame(cfg) == 2 * (hand["critic"]
                                                      + hand["decoder"])


def test_published_sizes():
    # ~186 and ~21 MFLOP a frame (the issue's figures)
    assert 185e6 < flops.process_flops_per_frame(config("chfak5")) < 188e6
    assert 20e6 < flops.process_flops_per_frame(config("chfak1")) < 22e6


def test_masker_step_flops_by_hand():
    cfg, hand = config("chfak5"), HAND["chfak5"]
    n_a = 64
    dec4 = conv(1, 160, 160, 1)
    macs = (2 * n_a * hand["critic"] * 3          # fwd, fwd, dgrad (4K)
            + n_a * hand["decoder"] * 2           # fwd, wgrad (2K)
            + n_a * (hand["decoder"] - dec4))     # dgrad, not dec_model.4
    assert flops.masker_step_flops(cfg, 32) == 2 * macs


@pytest.mark.parametrize("name", sorted(HAND))
def test_bytes_by_hand(name):
    cfg = config(name)
    assert flops.ingest_bytes(8192) == 8192 * 64 * 64 * 3 * 5
    assert flops.joins_bytes(cfg, 8192) == 8192 * HAND[name]["joins"] * 4
    # the batch-8192 operands leave the 50 MB L2
    assert flops.joins_bytes(cfg, 8192) > flops.L2_BYTES
    assert flops.ingest_bytes(8192) > flops.L2_BYTES


def test_bound():
    assert flops.bound_s(nbytes=3.35e12) == pytest.approx(1.0)
    assert flops.bound_s(flops=67e12) == pytest.approx(1.0)
    assert flops.bound_s(nbytes=3.35e12, flops=134e12) == pytest.approx(2.0)


@pytest.mark.parametrize("name", sorted(HAND))
def test_seeded_weights_match_the_port(name):
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder

    cfg = config(name)
    p = weights.seeded_params(cfg, 2 ** 31 + 3, "cpu")
    critic = Critic(chfak=cfg["chfak"], dropout=cfg["dropout"])
    masker = UnetDecoder(chfak=cfg["chfak"])
    for model, mod in (("critic", critic), ("masker", masker)):
        want = {k: tuple(v.shape) for k, v in mod.state_dict().items()}
        assert {k: tuple(v.shape) for k, v in p[model].items()} == want
        mod.load_state_dict(p[model])
    for layer in shapes.critic_layers(cfg):
        w = p["critic"][layer.key + ".weight"]
        bound = 1.0 / (w[0].numel() ** 0.5)
        assert float(w.abs().max()) <= bound
    again = weights.seeded_params(cfg, 2 ** 31 + 3, "cpu")
    other = weights.seeded_params(cfg, 2 ** 31 + 4, "cpu")
    k = "features.0.weight"
    assert torch.equal(p["critic"][k], again["critic"][k])
    assert not torch.equal(p["critic"][k], other["critic"][k])
