"""PyTorch port: the whole mask head as one kernel
(`ops/kernels.py:conv_mask_head`, `models/epilogue.py:conv_mask_head`)
on the CPU.

`conv_mask_head_plain` is the chain it replaces: `masker.0` without its
bias, then `mask_head_plain`; in f32 the modules' own forward bit for
bit, and close to the head in float64, at every join width of the
configurations (C = 11, 43, 67, 99). The wrapper refuses what the kernel
does not take. The route: an f32 `UnetDecoder` forward on the card
(faked here) with grad mode off runs its head as one `conv_mask_head`,
counted under `model.mask_heads` and `model.mask_head_convs`; bf16, a
join wider than the kernel takes and grad mode do not. The kernel itself
is held against float64 on the card (`tests/test_torch_port_cuda.py`).
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
    CONV_MASK_HEAD_MAX_C, CONV_MASK_HEAD_MID, CONV_MASK_HEAD_W,
    conv_mask_head, conv_mask_head_plain, conv_mask_head_takes,
    mask_head_plain,
)
from cgs_tpu_torch.utils.profiling import counts

# the last join's width in the configurations: chfak 1, chfak 5,
# resnet18, convnext_t and swin_v2_t
JOIN_WIDTHS = (11, 43, 67, 99)
COUNTERS = ("model.mask_heads", "model.mask_head_convs")


def _head_and_input(c, n=2, h=9, seed=0):
    """The decoder's `masker` on a join of C channels, b0 of both signs,
    and the join, NHWC (the view of an NCHW channels_last tensor)."""
    torch.manual_seed(seed)
    head = UnetDecoder().masker
    head[0] = torch.nn.Conv2d(c, CONV_MASK_HEAD_MID, 3, padding=1)
    with torch.no_grad():
        b0 = head[0].bias
        b0.copy_(b0.abs() + 0.05)
        b0[1::2] *= -1
    g = torch.Generator().manual_seed(seed + 1)
    x = torch.randn(n, c, h, CONV_MASK_HEAD_W, generator=g).contiguous(
        memory_format=torch.channels_last)
    return head, x


def _args(head):
    return (head[0].weight, head[0].bias, head[2].weight, head[2].bias,
            head[1].negative_slope)


@pytest.mark.parametrize("c", JOIN_WIDTHS)
def test_plain_is_the_modules_forward_and_follows_float64(
        c, one_torch_thread):  # noqa: F811
    """Bit for bit the head's own f32 forward, its bias added after the
    convolution; within 1e-6 of the same head in float64 (the f32 chain's
    rounding, ~1e-7 of a mask in (0, 1))."""
    head, x = _head_and_input(c)
    head.requires_grad_(False)
    nhwc = x.permute(0, 2, 3, 1)
    got = conv_mask_head_plain(nhwc, *_args(head))
    assert got.dtype == torch.float32 and got.shape == (2, 9, 64)
    want = head(x)[:, 0]
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(conv_mask_head(nhwc, *_args(head)), got)
    w0, b0, w2, b2, slope = _args(head)
    exact = conv_mask_head_plain(nhwc.double(), w0.double(), b0.double(),
                                 w2.double(), b2.double(), slope)
    assert exact.dtype == torch.float64
    assert float((got.double() - exact).abs().max()) <= 1e-6


def test_plain_is_the_first_convolution_then_mask_head_plain(
        one_torch_thread):  # noqa: F811
    head, x = _head_and_input(43, h=5)
    w0, b0, w2, b2, slope = _args(head)
    y0 = F.conv2d(x, w0, None, 1, 1).permute(0, 2, 3, 1)
    got = conv_mask_head_plain(x.permute(0, 2, 3, 1), *_args(head))
    assert torch.equal(got, mask_head_plain(y0, b0, w2, b2, slope))


def test_border_is_padded_with_zeros_before_and_after_the_activation(
        one_torch_thread):
    """A join whose border pixels alone are nonzero: the first
    convolution reads zeros past the frame, and the last reads zeros
    around h, not leaky(b0)."""
    head, x = _head_and_input(11, h=8)
    inner = torch.zeros_like(x, dtype=torch.bool)
    inner[:, :, 1:-1, 1:-1] = True
    x = x.masked_fill(inner, 0.0)
    nhwc = x.permute(0, 2, 3, 1)
    got = conv_mask_head_plain(nhwc, *_args(head))
    w0, b0, w2, b2, slope = _args(head)
    h = F.leaky_relu(F.conv2d(x, w0, b0, 1, 1), slope)
    pad = F.leaky_relu(b0, slope)[None, :, None, None].expand(
        2, -1, 10, 66).clone()
    pad[:, :, 1:-1, 1:-1] = h
    wrong = torch.sigmoid(F.conv2d(pad, w2, b2))[:, 0]
    border = torch.ones(8, 64, dtype=torch.bool)
    border[1:-1, 1:-1] = False
    assert torch.equal(got[:, ~border], wrong[:, ~border])
    assert bool((got[:, border] != wrong[:, border]).all())


@pytest.mark.parametrize("bad,match", [
    ({"x": torch.zeros(2, 4, 64, 11, dtype=torch.bfloat16)}, "f32"),
    ({"x": torch.zeros(2, 4, 64, CONV_MASK_HEAD_MAX_C + 1)}, "C <="),
    ({"x": torch.zeros(2, 4, 32, 11)}, "f32 \\(N, H, 64, C\\)"),
    ({"x": torch.zeros(4, 64, 11)}, "N, H, W, C"),
    ({"x": torch.zeros(2, 11, 4, 64).permute(0, 2, 3, 1)}, "contiguous"),
    ({"w0": torch.zeros(16, 12, 3, 3)}, "w0"),
    ({"w0": torch.zeros(8, 11, 3, 3)}, "w0"),
    ({"w0": torch.zeros(16, 11, 3, 3, dtype=torch.bfloat16)}, "w0"),
    ({"b0": torch.zeros(15)}, "b0"),
    ({"w2": torch.zeros(1, 16, 5, 5)}, "w2"),
    ({"b2": torch.zeros(2)}, "b2")])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad, match):
    args = {"x": torch.zeros(2, 4, 64, 11), "w0": torch.zeros(16, 11, 3, 3),
            "b0": torch.zeros(16), "w2": torch.zeros(1, 16, 3, 3),
            "b2": torch.zeros(1)}
    args.update(bad)
    with pytest.raises(ValueError, match=match):
        conv_mask_head(**args)


@pytest.mark.parametrize("dtype,c,mid,w,takes", [
    (torch.float32, 11, 16, 64, True), (torch.float32, 1, 16, 64, True),
    (torch.float32, CONV_MASK_HEAD_MAX_C, 16, 64, True),
    (torch.float32, CONV_MASK_HEAD_MAX_C + 1, 16, 64, False),
    (torch.bfloat16, 43, 16, 64, False), (torch.float32, 0, 16, 64, False),
    (torch.float32, 43, 32, 64, False), (torch.float32, 43, 16, 32, False)])
def test_what_the_kernel_takes(dtype, c, mid, w, takes):
    assert conv_mask_head_takes(dtype, c, mid, w) is takes


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


@pytest.mark.parametrize("arch,chfak,c", [
    ("paper", 1, 11), ("paper", 5, 43), ("resnet18", 1, 67),
    ("convnext_t", 1, 99)])
def test_route_counts_one_conv_mask_head_a_forward(arch, chfak, c,
                                                   one_torch_thread):
    """An f32 forward on the card with grad mode off: one mask head and
    one `conv_mask_head`, whose input is the last join at its width; the
    mask the eager chain's, bit for bit on the CPU."""
    critic, masker = build_pair(Config(critic_arch=arch, chfak=chfak,
                                       dropout=0.0).derive())
    critic.eval()
    x = _frames()
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return conv_mask_head(*args)

    with torch.no_grad():
        want, n = _counted(lambda: _decode(critic, masker, x))
        assert n == (0, 0)
        with mock.patch.object(epilogue, "on_card", lambda t: True), \
                mock.patch.object(epilogue, "conv_mask_head_op", spy):
            got, n = _counted(lambda: _decode(critic, masker, x))
    assert n == (1, 1) and calls == [(2, 64, 64, c)]
    assert got.shape == (2, 1, 64, 64) and got.dtype == torch.float32
    assert torch.equal(got, want)


def test_route_keeps_the_first_convolution_in_bf16_and_past_the_limit(
        one_torch_thread):
    """Under bf16 autocast, and for a join wider than the kernel takes,
    the head is `masker.0` then `mask_head`: one mask head, no
    `conv_mask_head`; a wide join's mask the eager chain's bit for bit."""
    x = _frames()
    with torch.no_grad(), \
            mock.patch.object(epilogue, "on_card", lambda t: True):
        critic = Critic(dropout=0.0, compute_dtype=torch.bfloat16)
        masker = UnetDecoder(compute_dtype=torch.bfloat16)
        got, n = _counted(lambda: _decode(critic, masker, x))
        assert n == (1, 0) and got.dtype == torch.float32
        critic = Critic(dropout=0.0)
        wide = UnetDecoder(ddims=(CONV_MASK_HEAD_MAX_C, 8, 8, 16))
        assert wide.masker[0].in_channels == 3 + CONV_MASK_HEAD_MAX_C
        got, n = _counted(lambda: _decode(critic, wide, x))
        assert n == (1, 0)
    with torch.no_grad():
        assert torch.equal(got, _decode(critic, wide, x))


def test_route_takes_no_conv_mask_head_under_grad(one_torch_thread):
    """Grad mode on, frozen or not: the eager chain, neither counter."""
    critic = Critic(dropout=0.0)
    x = _frames()
    with mock.patch.object(epilogue, "on_card", lambda t: True):
        for frozen in (False, True):
            masker = UnetDecoder().requires_grad_(not frozen)
            _, n = _counted(lambda: _decode(critic, masker, x))
            assert n == (0, 0)


def test_an_outer_autocast_keeps_the_first_convolution():
    """An f32 decoder under an autocast region its caller opened: the
    convolution would run in the autocast type, so the route leaves it
    to `masker.0` (CPU autocast stands in for the card's)."""
    head, x = _head_and_input(11, h=4)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16), \
            mock.patch.object(epilogue, "on_card", lambda t: True):
        _, n = _counted(lambda: epilogue.conv_mask_head(head, x))
    assert n == (0, 0)
