"""PyTorch port: the mask head after its first convolution
(`ops/kernels.py:mask_head`, `models/epilogue.py:conv_mask_head`) on the
CPU.

`mask_head_plain` is the chain it replaces, bit for bit, in f32 and
bf16: the LeakyReLU of `masker.0`'s output plus its bias, `masker.2`
over it with the frame's border padded by zeros after the activation,
its bias, the sigmoid in f32. The wrapper refuses what the kernel does
not take. The route: a `UnetDecoder` forward on the card (faked here)
with grad mode off takes one `mask_head` for the head, counted under
`model.mask_heads`, and its other convolutions' epilogues; grad mode,
a masker step or a head wider than the kernel takes keep the eager
chain. The kernel itself is held against float64 on the card
(`tests/test_torch_port_cuda.py`). This file imports neither JAX nor
the JAX package.
"""

from unittest import mock

import pytest
import torch
import torch.nn.functional as F
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.models import epilogue
from cgs_tpu_torch.models.build import build_pair
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.ops.kernels import (
    MASK_HEAD_MAX_C, mask_head, mask_head_plain, mask_head_takes,
)
from cgs_tpu_torch.utils.profiling import counts

COUNTERS = ("model.epilogue_fused", "model.epilogue_eager",
            "model.mask_heads")


def _bits(t):
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


def _head_and_input(dtype, n=3, h=9, w=7, seed=0):
    """A mask head (the decoder's `masker`) with b0 of both signs, and
    its first convolution's input, NCHW channels_last, of `dtype`."""
    torch.manual_seed(seed)
    head = UnetDecoder().masker
    with torch.no_grad():
        b0 = head[0].bias
        b0.copy_(b0.abs() + 0.05)
        b0[1::2] *= -1
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.rand(n, head[0].in_channels, h, w, generator=g)
    return head.to(dtype), x.to(dtype).contiguous(
        memory_format=torch.channels_last)


def _args(head, x):
    """mask_head's arguments: y0, masker.0's NHWC output without bias,
    and the head's parameters."""
    y0 = F.conv2d(x, head[0].weight, None, 1, 1)
    return (y0.permute(0, 2, 3, 1), head[0].bias, head[2].weight,
            head[2].bias, head[1].negative_slope)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_equals_the_chain(dtype):
    """As the card runs the head eagerly: `masker.0`'s bias added to its
    output in its type, the LeakyReLU module, `masker.2` as its
    convolution then its bias, the sigmoid in f32. In f32 that is also
    the modules' own forward bit for bit."""
    head, x = _head_and_input(dtype)
    y0, b0, w2, b2, slope = _args(head, x)
    h = head[1]((y0 + b0).permute(0, 3, 1, 2))
    want = torch.sigmoid((F.conv2d(h, w2, None, 1, 1)
                          + b2[:, None, None]).float())
    got = mask_head_plain(y0, b0, w2, b2, slope)
    assert got.dtype == torch.float32 and got.shape == (3, 9, 7)
    assert torch.equal(_bits(got), _bits(want[:, 0]))
    assert torch.equal(mask_head(y0, b0, w2, b2, slope), got)
    if dtype == torch.float32:
        assert torch.equal(_bits(got), _bits(head(x)[:, 0]))


def test_border_is_padded_with_zeros_after_the_activation():
    """The frame's border pixels read zeros around them, not leaky(b0):
    a head padded with the activation of a zero input differs on the
    border, and only there."""
    head, x = _head_and_input(torch.float32)
    y0, b0, w2, b2, slope = _args(head, x)
    assert bool((b0 > 0).any()) and bool((b0 < 0).any())
    got = mask_head_plain(y0, b0, w2, b2, slope)
    h = F.leaky_relu(y0 + b0, slope).permute(0, 3, 1, 2)
    pad = F.leaky_relu(b0, slope)[None, :, None, None].expand(
        3, -1, 11, 9).clone()
    pad[:, :, 1:-1, 1:-1] = h
    wrong = torch.sigmoid(F.conv2d(pad, w2, b2))[:, 0]
    border = torch.ones(9, 7, dtype=torch.bool)
    border[1:-1, 1:-1] = False
    assert torch.equal(got[:, ~border], wrong[:, ~border])
    assert bool((got[:, border] != wrong[:, border]).all())


@pytest.mark.parametrize("bad,match", [
    ({"y0": torch.zeros(2, 4, 4, 16, dtype=torch.float64)}, "f32 or bf16"),
    ({"y0": torch.zeros(2, 4, 4, MASK_HEAD_MAX_C + 1)}, "C <="),
    ({"y0": torch.zeros(4, 4, 16)}, "N, H, W, C"),
    ({"b0": torch.zeros(15)}, "b0"),
    ({"b0": torch.zeros(16, dtype=torch.bfloat16)}, "b0"),
    ({"w2": torch.zeros(1, 16, 5, 5)}, "w2"),
    ({"w2": torch.zeros(2, 16, 3, 3)}, "w2"),
    ({"b2": torch.zeros(2)}, "b2")])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    args = {"y0": torch.zeros(2, 4, 4, 16), "b0": torch.zeros(16),
            "w2": torch.zeros(1, 16, 3, 3), "b2": torch.zeros(1)}
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        mask_head(**args)


@pytest.mark.parametrize("dtype,c,takes", [
    (torch.float32, 16, True), (torch.bfloat16, 1, True),
    (torch.float32, MASK_HEAD_MAX_C, True),
    (torch.float32, MASK_HEAD_MAX_C + 1, False), (torch.float16, 16, False),
    (torch.float32, 0, False)])
def test_what_the_kernel_takes(dtype, c, takes):
    assert mask_head_takes(dtype, c) is takes


def _counted(fn):
    before = [counts[k] for k in COUNTERS]
    out = fn()
    return out, tuple(counts[k] - b for k, b in zip(COUNTERS, before))


def _frames(n=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 64, 64, 3, generator=g).permute(0, 3, 1, 2)


def _decode(critic, masker, x):
    _, embeds = critic(x, collect=True,
                       generator=torch.Generator().manual_seed(2))
    return masker(x, embeds)


@pytest.mark.parametrize("arch,fused", [("paper", 10), ("resnet18", 5),
                                        ("convnext_t", 5)])
def test_route_counts_one_mask_head_a_forward(arch, fused,
                                              one_torch_thread):  # noqa: F811
    """With grad mode off on the card: `model.mask_heads` + 1 and the
    other convolutions' epilogues (a paper critic's 5 and the decoder's
    5); the mask the eager chain's, bit for bit in f32 on the CPU."""
    critic, masker = build_pair(Config(critic_arch=arch, dropout=0.0)
                                .derive())
    critic.eval()
    x = _frames()
    with torch.no_grad():
        want, n = _counted(lambda: _decode(critic, masker, x))
        assert n == (0, fused + 2, 0)
        with mock.patch.object(epilogue, "on_card", lambda t: True):
            got, n = _counted(lambda: _decode(critic, masker, x))
    assert n == (fused, 0, 1)
    assert got.shape == (2, 1, 64, 64) and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_route_stays_eager_under_grad_and_for_a_wide_head(
        one_torch_thread):  # noqa: F811
    """Grad mode on (frozen or not) and a head wider than the kernel
    takes: no mask head; the wide head keeps its two epilogues."""
    critic = Critic(dropout=0.0)
    x = _frames()
    with mock.patch.object(epilogue, "on_card", lambda t: True):
        for frozen in (False, True):
            masker = UnetDecoder().requires_grad_(not frozen)
            _, n = _counted(lambda: _decode(critic, masker, x))
            assert n == (0, 12, 0)
        wide = UnetDecoder(masker_channels=MASK_HEAD_MAX_C + 1)
        with torch.no_grad():
            _, n = _counted(lambda: _decode(critic, wide, x))
        assert n == (12, 0, 0)


def test_masker_step_takes_no_mask_head(one_torch_thread):  # noqa: F811
    """A -frozen masker chunk on the card (faked) runs its head eagerly:
    the step and its captured graph record the modules' chain."""
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
    assert n[0] == 0 and n[2] == 0 and n[1] > 0
