"""Swin Transformer V2-T as the reward critic (Liu et al., "Swin
Transformer V2: Scaling Up Capacity and Resolution", arXiv:2111.09883;
the authors' `swinv2_tiny_patch4_window8_256`, torchvision `swin_v2_t`),
for the paper's U-Net masker on its four stages (`models/build.py`,
`--critic swin_v2_t`).

    patch embed  Conv2d(3, 96, k=4, s=4) -> LayerNorm(96)         16x16
    stage i      blocks at width C_i = 96, 192, 384, 768, depths 2, 2,
                 6, 2, heads 3, 6, 12, 24 (head size d = 32), at 16x16,
                 8x8, 4x4, 2x2; before stages 2-4 a patch merge
    block        x = x + drop_path(LN(attn(x)))
                 x = x + drop_path(LN(mlp(x)))     (res-post-norm: the
                 residual stream itself is never normalised)
    mlp          Linear(C, 4C) -> GELU (erf) -> Linear(4C, C)
    merge        cat of the 2x2 neighbours (0::2, 0::2), (1::2, 0::2),
                 (0::2, 1::2), (1::2, 1::2) -> Linear(4C, 2C, no bias)
                 -> LayerNorm(2C)                    (PatchMergingV2)
    head         LayerNorm(768) -> mean over tokens -> Linear(768, 1)

Scaled cosine window attention, per window of N = w^2 tokens and head h:

    attn = softmax(cos(q, k) * exp(min(tau_h, log 100))
                   + 16 * sigmoid(B) + M) @ v

q = x Wq + bq, k = x Wk (its bias fixed at zero), v = x Wv + bv;
cos(q, k) is the dot product of q and k each divided by its L2 norm
(at least 1e-12); tau_h a learned temperature a head. B is the
continuous position bias: a table over the (2w - 1)^2 relative offsets,
`Linear(2, 512) -> ReLU -> Linear(512, heads, no bias)` of the
log-spaced offsets `sign(t) * log2(1 + |8 t|) / 3`, t = offset / (w -
1) (the authors' `pretrained_window_size` 0 case), gathered to (heads,
N, N). Shifted blocks (the odd ones of a stage) roll the map by (-s,
-s), s = w / 2, before the windows are cut and by (s, s) after they are
put back; M is -100 on the pairs of a window that the roll brought
together from different regions of the map (the authors' three-region
construction), 0 elsewhere and in unshifted blocks.

The authors' rule for maps no larger than the window
(`SwinTransformerBlock.__init__`: where min(resolution) <= window the
shift is 0 and the window the map) gives, at the system's 64x64 frame:

    stage 1  16x16  window 8  four windows, block 2 shifted by 4, masked
    stage 2   8x8   window 8  one window: full attention over 64 tokens
    stage 3   4x4   window 4  full attention over 16 tokens
    stage 4   2x2   window 2  full attention over 4 tokens

so no token is padding (torchvision pads stages 3 and 4 to 8x8
windows instead). The CPB coordinates follow each stage's own window.

Departures from the authors' code, each the benchmark's plain reference
(`portbench/reference/swin_v2_t.py`) makes too:
- the head has one output, a raw score (`head` is Linear(768, 1), no
  sigmoid), where the published one has 1000 classes;
- the critic returns taps besides the score, for the decoder;
- the state-dict keys are torchvision's `swin_v2_t` (`features.0.{0,2}`
  the patch embedding, `features.{1,3,5,7}.{j}` the blocks,
  `features.{2,4,6}` the merges, `norm` and `head`), whose k third of
  `attn.qkv.bias` is zeroed at every forward as the authors' k has no
  bias; the coordinate table, the offset index and the shift mask are
  buffers outside the state_dict (they follow the geometry, which here
  is not torchvision's);
- the geometry is fixed at construction for `frame` x `frame` inputs.

The critic interface of `models/critic.py:Critic`: `forward(x,
collect=True)` also returns the taps: None where the decoder's 32x32
level would take one (the stride-4 patch embedding leaves none), then
the last block output of stages 1-4 (96 @ 16x16, 192 @ 8x8, 384 @ 4x4,
768 @ 2x2, the neck, before the final LayerNorm), each before the merge
that follows it, as NCHW views of the NHWC token maps: channels_last,
no layout copy. The score is raw and the input is `ImageNetCritic`'s.
Drop-path (`convnext.drop_path`, p rising linearly from 0 to `drop_path`
over the 12 blocks, one rate a block for both branches) acts in train
mode only and draws from `generator`. The token maps stay NHWC, so the
LayerNorms, linears and GELU run on them as they are; the window
partition, the roll and their reverses are views where the layout
allows and one copy where it does not. Under `compute_dtype=
torch.bfloat16` the convolution, linears and attention run in bf16 with
f32 parameters, the LayerNorms in f32 (autocast's rule).

The attention route. On the card with grad mode off (the eval forward
of `-process`, `-eval` and the server), each block's attention is one
`scaled_dot_product_attention` launch pinned to PyTorch's
memory-efficient backend (f32 here, with an additive mask: the N x N
scores never reach device memory, and a backend that cannot take the
call raises rather than falls back to the math path). q and k are
normalised, and q scaled by the temperature, on the way into the
(frames, windows x heads, N, d) layout the launch reads; the position
bias and the shift mask are folded into one (1, windows x heads, N, N)
bias a layer, computed once a forward from the weights and broadcast
over the frames. In grad mode, and on the CPU, the same bias goes
through `attend_plain`: the scores written out, softmax, then v.

`layer_norms` (29) and `window_attns` (12) list the forward's LayerNorm
and attention layers (the counters `model.layer_norms` and
`model.window_attns`, `models/build.py:critic_forward`), `drop_paths`
its drop-path layers (a frozen critic runs them in eval mode,
`train/steps.py:set_masker_modes`). Under a profiler the patch
embedding, each stage (with the merge that opens it) and the head are
the spans `cgs.model.swin.patch_embed`, `.stage1` ... `.stage4` and
`.head`.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cgs_tpu_torch.models.convnext import DropPath, Permute
from cgs_tpu_torch.models.critic import compute_autocast
from cgs_tpu_torch.models.zoo import ImageNetCritic
from cgs_tpu_torch.utils.profiling import span

EMBED = 96
DEPTHS = (2, 2, 6, 2)
HEADS = (3, 6, 12, 24)
WINDOW = 8
MLP_RATIO = 4
PATCH = 4
FRAME = 64
LN_EPS = 1e-5
DROP_PATH = 0.2            # swinv2_tiny's stochastic depth
CPB_HIDDEN = 512
LOGIT_MAX = math.log(100.0)  # the temperature's clamp, log(1 / 0.01)
MASK_FILL = -100.0
NORM_EPS = 1e-12           # F.normalize's
ALIGN = 16                 # the bias's row stride the fused route reads


def geometry(hw: int, window: int, shifted: bool):
    """(window, shift) of a block on an hw x hw map: the authors' rule
    shrinks the window to a map no larger than it and shifts no such
    map; otherwise the odd blocks shift by half the window."""
    if hw <= window:
        return hw, 0
    if hw % window:
        raise ValueError(f"a {hw}x{hw} map does not tile into "
                         f"{window}x{window} windows")
    return window, (window // 2 if shifted else 0)


def coords_table(window: int) -> torch.Tensor:
    """(2w - 1, 2w - 1, 2) log-spaced relative offsets, the CPB input:
    sign(t) * log2(1 + |8 t|) / 3 with t = offset / (w - 1)."""
    r = torch.arange(-(window - 1), window, dtype=torch.float32)
    t = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1)
    t = t / (window - 1) * 8.0
    return torch.sign(t) * torch.log2(t.abs() + 1.0) / math.log2(8.0)


def offset_index(window: int) -> torch.Tensor:
    """(N, N) index into the flattened table of each pair's offset."""
    r = torch.arange(window)
    c = torch.stack(torch.meshgrid(r, r, indexing="ij")).flatten(1)
    rel = (c[:, :, None] - c[:, None, :]).permute(1, 2, 0) + (window - 1)
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def shift_mask(hw: int, window: int, shift: int) -> torch.Tensor:
    """(windows, N, N) additive mask of a shifted block: on the rolled
    map, rows [0, hw - w), [hw - w, hw - s) and [hw - s, hw) are three
    regions, and so are the columns; a pair from two different regions
    gets MASK_FILL."""
    pos = torch.arange(hw)
    band = (pos >= hw - window).long() + (pos >= hw - shift).long()
    region = band[:, None] * 3 + band[None, :]                # (hw, hw)
    n = hw // window
    region = region.view(n, window, n, window).permute(0, 2, 1, 3) \
        .reshape(n * n, window * window)
    differ = region[:, :, None] != region[:, None, :]
    return torch.where(differ, MASK_FILL, 0.0)


def attend_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T + bias) v, the scores written out: (B, H, N, d)."""
    return torch.softmax(q @ k.transpose(-2, -1) + bias, dim=-1) @ v


def attend_fused(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 bias: torch.Tensor) -> torch.Tensor:
    """The same in one `scaled_dot_product_attention` launch at scale 1,
    pinned to the memory-efficient backend, which reads the bias where
    it lies and keeps the scores on chip (on the card: `fused_route`)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        return F.scaled_dot_product_attention(q, k, v, attn_mask=bias,
                                              scale=1.0)


def fused_route(x: torch.Tensor) -> bool:
    """The eval forward on the card takes the fused attention."""
    return x.is_cuda and not torch.is_grad_enabled()


class WindowAttentionV2(nn.Module):
    """Scaled cosine attention over the windows of an hw x hw NHWC map
    at width `dim`, shifted by `shift` (module docstring), under
    torchvision's `ShiftedWindowAttentionV2` keys."""

    def __init__(self, dim: int, heads: int, hw: int, window: int,
                 shift: int):
        super().__init__()
        self.dim, self.heads, self.hw = dim, heads, hw
        self.window, self.shift = window, shift
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.logit_scale = nn.Parameter(torch.log(10.0 * torch.ones(
            heads, 1, 1)))
        self.cpb_mlp = nn.Sequential(nn.Linear(2, CPB_HIDDEN), nn.ReLU(),
                                     nn.Linear(CPB_HIDDEN, heads,
                                               bias=False))
        self.register_buffer("relative_coords_table",
                             coords_table(window), persistent=False)
        self.register_buffer("relative_position_index",
                             offset_index(window), persistent=False)
        self.register_buffer(
            "attn_mask", shift_mask(hw, window, shift) if shift else None,
            persistent=False)
        keep = torch.ones(3 * dim)
        keep[dim:2 * dim] = 0.0
        self.register_buffer("k_bias_keep", keep, persistent=False)

    def bias(self) -> torch.Tensor:
        """(1, windows x heads, N, N): 16 sigmoid(B) plus the shift mask,
        once a forward, stored with rows ALIGN-aligned as the fused route
        reads them."""
        h, n = self.heads, self.window * self.window
        nw = (self.hw // self.window) ** 2
        table = self.cpb_mlp(self.relative_coords_table).view(-1, h)
        b = 16.0 * torch.sigmoid(
            table[self.relative_position_index.view(-1)].view(n, n, h)
            .permute(2, 0, 1))
        b = b.float().unsqueeze(0).expand(nw, h, n, n)
        if self.attn_mask is not None:
            b = b + self.attn_mask.unsqueeze(1)
        out = b.new_empty(nw * h, n, -(-n // ALIGN) * ALIGN)[..., :n]
        out.copy_(b.reshape(nw * h, n, n))
        return out.unsqueeze(0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, hw, hw, C) NHWC. Returns the attention's output, (B,
        hw, hw, C) contiguous, before the block's post-norm."""
        bsz, hw, _, c = x.shape
        w, s, h = self.window, self.shift, self.heads
        d, n, nw = c // h, w * w, hw // w
        if s:
            x = torch.roll(x, (-s, -s), (1, 2))
        # torchvision's qkv bias with its k third zeroed: k has none
        qkv = F.linear(x, self.qkv.weight, self.qkv.bias * self.k_bias_keep)
        # (B, hw, hw, 3C) -> (3, B, windows, windows, heads, w, w, d): views
        q, k, v = qkv.view(bsz, nw, w, nw, w, 3, h, d).permute(
            5, 0, 1, 3, 6, 2, 4, 7).unbind(0)
        shape = (bsz, nw * nw * h, n, d)
        scale = torch.clamp(self.logit_scale, max=LOGIT_MAX).exp().view(
            h, 1, 1, 1)
        q = (q * (scale / q.norm(dim=-1, keepdim=True).clamp_min(NORM_EPS))
             ).reshape(shape)
        k = (k / k.norm(dim=-1, keepdim=True).clamp_min(NORM_EPS)
             ).reshape(shape)
        v = v.reshape(shape)
        bias = self.bias().to(q.dtype)
        attend = attend_fused if fused_route(q) else attend_plain
        o = attend(q, k, v, bias)                     # (B, nW h, N, d)
        # window reverse: (B, i, j, wi, wj, heads d) -> (B, wi i, wj j, C);
        # a view for one window when the route wrote (B, N, heads, d)
        o = o.transpose(1, 2).reshape(bsz, w, w, nw, nw, c).permute(
            0, 3, 1, 4, 2, 5).reshape(bsz, hw, hw, c)
        y = self.proj(o)
        if s:
            y = torch.roll(y, (s, s), (1, 2))
        return y


class SwinBlockV2(nn.Module):
    """torchvision's `SwinTransformerBlockV2` at width `dim` on an hw x
    hw map (module docstring)."""

    def __init__(self, dim: int, heads: int, hw: int, window: int,
                 shifted: bool, drop: float):
        super().__init__()
        w, s = geometry(hw, window, shifted)
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = WindowAttentionV2(dim, heads, hw, w, s)
        self.stochastic_depth = DropPath(drop)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        # torchvision's MLP keys: 0 the first linear, 3 the second
        self.mlp = nn.Sequential(nn.Linear(dim, MLP_RATIO * dim), nn.GELU(),
                                 nn.Identity(),
                                 nn.Linear(MLP_RATIO * dim, dim))

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        x = x + self.stochastic_depth(self.norm1(self.attn(x)), generator)
        return x + self.stochastic_depth(self.norm2(self.mlp(x)),
                                         generator)


class PatchMergingV2(nn.Module):
    """torchvision's `PatchMergingV2`: the 2x2 neighbours side by side in
    the authors' order, a linear to twice the width, then LayerNorm."""

    def __init__(self, dim: int):
        super().__init__()
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)
        self.norm = nn.LayerNorm(2 * dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bsz, hw, _, c = x.shape
        # (B, i, di, j, dj, C) -> (B, i, j, dj, di, C): the channel groups
        # (0::2, 0::2), (1::2, 0::2), (0::2, 1::2), (1::2, 1::2); one copy
        x = x.view(bsz, hw // 2, 2, hw // 2, 2, c).permute(0, 1, 3, 4, 2, 5) \
            .reshape(bsz, hw // 2, hw // 2, 4 * c)
        return self.norm(self.reduction(x))


class SwinV2Critic(ImageNetCritic):
    """Swin V2-T features and a one-output head (module docstring)."""

    def __init__(self, embed: int = EMBED, depths: Sequence[int] = DEPTHS,
                 heads: Sequence[int] = HEADS, window: int = WINDOW,
                 drop_path: float = DROP_PATH, frame: int = FRAME,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.frame = frame
        total, seen = sum(depths), 0
        hw, dim = frame // PATCH, embed
        layers: List[nn.Module] = [nn.Sequential(
            nn.Conv2d(3, embed, PATCH, stride=PATCH),
            Permute((0, 2, 3, 1)), nn.LayerNorm(embed, eps=LN_EPS))]
        for i, (depth, h) in enumerate(zip(depths, heads)):
            if i:
                layers.append(PatchMergingV2(dim))
                hw, dim = hw // 2, 2 * dim
            blocks = []
            for j in range(depth):
                blocks.append(SwinBlockV2(
                    dim, h, hw, window, j % 2 == 1,
                    drop_path * seen / max(total - 1, 1)))
                seen += 1
            layers.append(nn.Sequential(*blocks))
        self.features = nn.Sequential(*layers)
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.head = nn.Linear(dim, 1)
        mods = list(self.modules())
        self.layer_norms = [m for m in mods if isinstance(m, nn.LayerNorm)]
        self.window_attns = [m for m in mods
                             if isinstance(m, WindowAttentionV2)]
        self.drop_paths = [m for m in mods if isinstance(m, DropPath)]

    def forward(self, x: torch.Tensor, collect: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, 3, frame, frame). The score (B, 1) and, with
        collect=True, the taps [None, stage1, ..., stage4]."""
        if tuple(x.shape[2:]) != (self.frame, self.frame):
            raise ValueError(f"SwinV2Critic is built for {self.frame}x"
                             f"{self.frame} frames, got {tuple(x.shape)}")
        x = self.normalize(x).contiguous(memory_format=torch.channels_last)
        taps: List[Optional[torch.Tensor]] = [None]
        f = self.features
        with compute_autocast(x.device.type, self.compute_dtype):
            with span("cgs.model.swin.patch_embed"):
                x = f[0](x)                          # (B, H, W, C)
            for s in range(4):
                with span(f"cgs.model.swin.stage{s + 1}"):
                    if s:
                        x = f[2 * s](x)
                    for block in f[2 * s + 1]:
                        x = block(x, generator)
                taps.append(x.permute(0, 3, 1, 2))   # NCHW channels_last
            with span("cgs.model.swin.head"):
                score = self.head(self.norm(x).mean((1, 2)))
        if self.compute_dtype == torch.bfloat16:
            score = score.float()
        return (score, taps) if collect else score
