"""PyTorch port: the convolution epilogue (`ops/kernels.py:bias_act_pool`,
`models/epilogue.py`) on the CPU.

`bias_act_pool_plain` is the modules' own chain, bit for bit, for each
activation, with and without the pool, in f32 and bf16; the wrapper
refuses what the kernel does not take. The route: a `Critic` /
`UnetDecoder` forward takes the fused epilogues only on the card with
grad mode off (the card faked here, so the CPU runs the plain version
through the route): 10 fused convolutions a chfak-1 forward, 5 a
ResNet-18 decoder forward (the mask head's two take `mask_head`,
`tests/test_torch_port_mask_head.py`), the same outputs as the eager
chain in f32; with grad on, or in a masker step, none. The kernel itself is held
against the plain version on the card (`tests/test_torch_port_cuda.py`).
This file imports neither JAX nor the JAX package.
"""

from unittest import mock

import pytest
import torch
import torch.nn.functional as F
from torch import nn
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.models import epilogue
from cgs_tpu_torch.models.build import build_pair
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.ops.kernels import (
    ACTS, bias_act_pool, bias_act_pool_plain,
)
from cgs_tpu_torch.utils.profiling import counts

FUSED, EAGER = "model.epilogue_fused", "model.epilogue_eager"
MODULES = {"none": nn.Identity(), "relu": nn.ReLU(),
           "leaky_relu": nn.LeakyReLU(0.01), "sigmoid": nn.Sigmoid()}


def _conv_out(c, dtype, n=3, h=8, w=6, seed=0):
    """A channels_last NCHW 'convolution output' with zeros and negative
    zeros among its values, and a bias, both of `dtype`."""
    g = torch.Generator().manual_seed(seed)
    y = torch.randn(n, h, w, c, generator=g)
    y[0, 0, 0] = 0.0
    y[0, 0, 1] = -0.0
    b = torch.randn(c, generator=g)
    return y.to(dtype).permute(0, 3, 1, 2), b.to(dtype)


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


@pytest.mark.parametrize("act", ACTS)
@pytest.mark.parametrize("pool", [1, 2])
@pytest.mark.parametrize("dtype,out_dtype", [
    (torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("c", [1, 16, 43])
def test_plain_equals_the_modules_chain(act, pool, dtype, out_dtype, c):
    """max_pool2d(act(y + b)) as the modules compute it on NCHW, the
    sum in y's type and the activation in the output's."""
    y, b = _conv_out(c, dtype)
    want = MODULES[act]((y + b[:, None, None]).to(out_dtype))
    if pool == 2:
        want = F.max_pool2d(want, 2)
    got = bias_act_pool_plain(y.permute(0, 2, 3, 1), b, act, pool,
                              out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.is_contiguous()
    assert torch.equal(_bits(got), _bits(want.permute(0, 2, 3, 1)))
    assert torch.equal(bias_act_pool(y.permute(0, 2, 3, 1), b, act, pool,
                                     out_dtype=out_dtype), got)


@pytest.mark.parametrize("bad,match", [
    ({"bias": torch.zeros(5)}, "bias"),
    ({"bias": torch.zeros(4, dtype=torch.bfloat16)}, "bias"),
    ({"act": "gelu"}, "act"),
    ({"pool": 3}, "pool"),
    ({"y": torch.zeros(2, 5, 4, 4)}, "pool"),
    ({"y": torch.zeros(2, 4, 4, 4, dtype=torch.float64)}, "f32 or bf16"),
    ({"out_dtype": torch.bfloat16}, "output")])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    args = {"y": torch.zeros(2, 4, 4, 4), "bias": torch.zeros(4),
            "act": "relu", "pool": 2, "out_dtype": None}
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        bias_act_pool(**args)


def _pair(dtype=torch.float32, dropout=0.0, seed=0):
    torch.manual_seed(seed)
    critic = Critic(dropout=dropout, compute_dtype=dtype)
    masker = UnetDecoder(compute_dtype=dtype)
    return critic, masker


def _frames(n=3, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 64, 64, 3, generator=g).permute(0, 3, 1, 2)


def _forward(critic, masker, x, seed=2):
    gen = torch.Generator().manual_seed(seed)
    pred, embeds = critic(x, collect=True, generator=gen)
    return pred, embeds, masker(x, embeds)


def _counted(fn):
    before = (counts[FUSED], counts[EAGER])
    out = fn()
    return out, (counts[FUSED] - before[0], counts[EAGER] - before[1])


def test_route_only_on_the_card_with_grad_off(one_torch_thread):  # noqa: F811
    critic, masker = _pair()
    x = _frames()
    with torch.no_grad():
        _, n = _counted(lambda: _forward(critic, masker, x))
    assert n == (0, 12)                 # the CPU: the eager chain
    with mock.patch.object(epilogue, "on_card", lambda t: True):
        with torch.no_grad():
            _, n = _counted(lambda: _forward(critic, masker, x))
        assert n == (10, 0)             # critic 5, decoder 5 and a head
        for frozen in (False, True):   # grad on: eager, frozen or not
            critic.requires_grad_(not frozen)
            masker.requires_grad_(not frozen)
            _, n = _counted(lambda: _forward(critic, masker, x))
            assert n == (0, 12)


@pytest.mark.parametrize("train", [False, True])
def test_routed_forward_equals_the_eager_one(train,
                                             one_torch_thread):  # noqa: F811
    """Through the route (the card faked, the plain epilogue on the CPU)
    the pred, all five embeds and the mask equal the eager chain's in
    f32, dropout live or not; the mask stays float32."""
    critic, masker = _pair(dropout=0.3)
    critic.train(train)
    x = _frames()
    with torch.no_grad():
        want = _forward(critic, masker, x)
        with mock.patch.object(epilogue, "on_card", lambda t: True):
            got = _forward(critic, masker, x)
    assert got[2].dtype == torch.float32
    assert got[2].shape == want[2].shape == (3, 1, 64, 64)
    assert torch.equal(got[0], want[0]) and torch.equal(got[2], want[2])
    assert len(got[1]) == len(want[1]) == 5
    for a, b in zip(got[1], want[1]):
        assert torch.equal(a, b)


def test_resnet18_routes_its_decoder_alone(one_torch_thread):  # noqa: F811
    critic, masker = build_pair(Config(critic_arch="resnet18").derive())
    critic.eval()
    x = _frames(n=2)
    with torch.no_grad(), \
            mock.patch.object(epilogue, "on_card", lambda t: True):
        (_, _, z), n = _counted(lambda: _forward(critic, masker, x))
    assert n == (5, 0)
    assert z.shape == (2, 1, 64, 64)


def test_masker_step_takes_no_fused_epilogue(one_torch_thread):  # noqa: F811
    """A -frozen masker chunk records the masker's graph: its critic
    passes and its decoder keep the eager chain, card or not."""
    from cgs_tpu_torch.train.loops import masker_chunk
    from cgs_tpu_torch.train.steps import (
        StepRng, make_optimizer, set_masker_modes, trained_param_keys,
    )

    cfg = Config(dropout=0.5, shift=12, frozen=True).derive()
    models = dict(zip(("critic", "masker"), build_pair(cfg)))
    set_masker_modes(cfg, models)
    opt = make_optimizer({k: models[k] for k in trained_param_keys(cfg)})
    g = torch.Generator().manual_seed(1)
    xpos, xneg = (torch.randint(0, 256, (12, 64, 64, 3), dtype=torch.uint8,
                                generator=g) for _ in range(2))
    ypos, yneg = 0.7 + 0.3 * torch.rand(12, generator=g), 0.3 * torch.rand(
        12, generator=g)
    idx = torch.randint(0, 12, (2, 4), generator=g).numpy()
    neg = torch.randint(0, 12, (2, 8), generator=g).numpy()
    with mock.patch.object(epilogue, "on_card", lambda t: True):
        terms, n = _counted(lambda: masker_chunk(
            cfg, models, opt, xpos, ypos, xneg, yneg, idx, idx, neg,
            StepRng.seeded(3, torch.device("cpu"))))
    assert terms.shape == (2, 4) and bool(torch.isfinite(terms).all())
    assert n[0] == 0 and n[1] > 0
