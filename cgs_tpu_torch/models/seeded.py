"""R seeds' critics and decoders as one module each: the seed axis
written out (PyTorch counterpart of the vmapped `init_seed_params`,
`init_seed_state` and `apply` of `cgs_tpu/sandbox/seed_parallel.py:67-95`).

`SeededCritic` and `SeededDecoder` hold R seeds' weights stacked along
the output channels, and run every convolution as one grouped cuDNN
call over the R seeds (`groups=R`, weight `(R*Cout, Cin, kh, kw)`), the
critic's 4x4 VALID bottleneck included; the critic head's two linears
are one `torch.bmm` each (weights `(R, out, in)`). A step then makes the
same device operations for any R, each R times larger.

Three batch layouts, all NCHW stored `torch.channels_last`:

  seed-major  (R*n, C, H, W): seed r's frames at [r*n, (r+1)*n);
  parted      (P*R*n, C, H, W): P parts end to end, each seed-major (the
              ingest's joined A || B, and the merges' replaced ||
              injected); P = 1 is seed-major;
  grouped     (P*n, R*C, H, W): frame p*n + i holds every seed's frame i
              of part p, seed r in channels [r*C, (r+1)*C), which the
              grouped convolutions, ReLU, max-pool and dropout take.

The port's kernels are per-frame maps and see the seeds in the batch:
the ingest writes the parted batch, the merges read and write seed-major
batches, and each decoder skip join (`ops.upsample.up_cat`) joins
seed-major skip and upsampled frames, so its per-frame channel concat
stays per seed. `to_grouped` and `from_grouped` move between the
layouts; each is one copy for R > 1 and a view for R = 1, and
`layout_moves` counts them per direction.

Dropout (`seeded_dropout`) draws seed r's mask from seed r's own
generator, in the shape, memory order and call order in which the
serial critic (`models/critic.py:dropout`) draws it for that seed alone:
a grouped (P*n, R*C, H, W) activation gets R channels_last (P*n, C, H,
W) draws, placed into channels [r*C, (r+1)*C) by one copy, and the
head's (R, n, neck) activation one (n, neck) draw per seed. A seed's
masks are then the serial step's for that seed, whatever R and the
other seeds are. The loss of R seeds is the sum of each seed's loss, so
each seed's gradient is its own, and one Adam over the stacked tensors
is R independent Adams (Adam works element by element).
"""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from cgs_tpu_torch.models.critic import compute_autocast
from cgs_tpu_torch.ops.upsample import up_cat

layout_moves: collections.Counter = collections.Counter()


def to_grouped(x: torch.Tensor, seeds: int, parts: int = 1) -> torch.Tensor:
    """(P*R*n, C, H, W) parted -> (P*n, R*C, H, W) grouped, channels_last."""
    pn, c, h, w = x.shape
    n = pn // (parts * seeds)
    if seeds > 1:
        layout_moves["to_grouped"] += 1
    g = (x.permute(0, 2, 3, 1).reshape(parts, seeds, n, h, w, c)
         .permute(0, 2, 3, 4, 1, 5).reshape(parts * n, h, w, seeds * c))
    return g.permute(0, 3, 1, 2)


def to_grouped_shared(x: torch.Tensor, seeds: int) -> torch.Tensor:
    """(n, C, H, W) frames every seed reads -> (n, R*C, H, W) grouped."""
    n, c, h, w = x.shape
    if seeds > 1:
        layout_moves["to_grouped"] += 1
    g = (x.permute(0, 2, 3, 1).unsqueeze(3).expand(n, h, w, seeds, c)
         .reshape(n, h, w, seeds * c))
    return g.permute(0, 3, 1, 2)


def from_grouped(g: torch.Tensor, seeds: int, parts: int = 1
                 ) -> torch.Tensor:
    """(P*n, R*C, H, W) grouped -> (P*R*n, C, H, W) parted, channels_last."""
    pn, rc, h, w = g.shape
    n, c = pn // parts, rc // seeds
    if seeds > 1:
        layout_moves["from_grouped"] += 1
    x = (g.permute(0, 2, 3, 1).reshape(parts, n, h, w, seeds, c)
         .permute(0, 4, 1, 2, 3, 5).reshape(parts * seeds * n, h, w, c))
    return x.permute(0, 3, 1, 2)


def shared_seed_major(x: torch.Tensor, seeds: int) -> torch.Tensor:
    """(n, C, H, W) frames every seed reads -> (R*n, C, H, W) seed-major,
    channels_last."""
    n, c, h, w = x.shape
    if seeds > 1:
        layout_moves["to_seed_major"] += 1
    x = (x.permute(0, 2, 3, 1).unsqueeze(0).expand(seeds, n, h, w, c)
         .reshape(seeds * n, h, w, c))
    return x.permute(0, 3, 1, 2)


def seeded_dropout(x: torch.Tensor, p: float, training: bool,
                   generators: Optional[Sequence[torch.Generator]] = None
                   ) -> torch.Tensor:
    """Inverted dropout of R seeds, seed r's mask from generators[r]:
    x is a grouped (P*n, R*C, H, W) activation stored channels_last, or
    the head's (R, n, F) one. Each seed's uniforms fill a contiguous
    slice of one buffer in the serial draw's memory order (NHWC, or
    (n, F)), so seed r sees the mask `models/critic.py:dropout` draws
    from the same generator on that seed's activation alone."""
    if not training or p == 0.0:
        return x
    if generators is None:
        raise ValueError("seeded_dropout: needs one generator per seed")
    if x.dim() == 4:        # grouped: seed r draws (P*n, H, W, C), NHWC
        pn, rc, h, w = x.shape
        r = len(generators)
        u = torch.empty((r, pn, h, w, rc // r), dtype=torch.float32,
                        device=x.device)
    else:                   # the head: seed r draws (n, F)
        u = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for ur, gen in zip(u, generators, strict=True):
        ur.uniform_(generator=gen)
    if x.dim() == 4:        # seed r's (P*n, H, W, C) into its channels
        u = u.permute(1, 2, 3, 0, 4).reshape(pn, h, w, rc).permute(0, 3, 1,
                                                                   2)
    return torch.where(u >= p, x / (1.0 - p), torch.zeros_like(x))


class SeededConv2d(nn.Module):
    """R convolutions as one grouped call: weight (R*Cout, Cin, k, k),
    bias (R*Cout,); (n, R*Cin, H, W) grouped in and out."""

    def __init__(self, seeds: int, cin: int, cout: int, kernel: int,
                 padding: int = 0):
        super().__init__()
        self.seeds, self.padding = seeds, padding
        self.weight = nn.Parameter(torch.empty(seeds * cout, cin, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.empty(seeds * cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.conv2d(x, self.weight, self.bias, padding=self.padding,
                        groups=self.seeds)


class SeededLinear(nn.Module):
    """R linears as one batched product: weight (R, out, in), bias
    (R, out); (R, n, in) in, (R, n, out) out."""

    def __init__(self, seeds: int, fin: int, fout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(seeds, fout, fin))
        self.bias = nn.Parameter(torch.empty(seeds, fout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.baddbmm(self.bias.unsqueeze(1), x,
                             self.weight.transpose(1, 2))


class SeededCritic(nn.Module):
    """R critics (`models/critic.py:Critic`) at the same module indices,
    so a seeded state_dict has the reference's key names."""

    def __init__(self, seeds: int, dims: Sequence[int] = (8, 8, 8, 16),
                 bottleneck: int = 32, colorchs: int = 3, chfak: int = 1,
                 dropout: float = 0.3,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        d = [k * chfak for k in dims]
        neck = bottleneck * chfak
        self.seeds, self.chfak = seeds, chfak
        self.compute_dtype = compute_dtype

        def block(cin, cout):
            return [SeededConv2d(seeds, cin, cout, 3, padding=1), nn.ReLU(),
                    nn.MaxPool2d(2)]

        self.features = nn.Sequential(
            *block(colorchs, d[0]), *block(d[0], d[1]), *block(d[1], d[2]),
            nn.Dropout(dropout),
            *block(d[2], d[3]),
            nn.Dropout(dropout),
            SeededConv2d(seeds, d[3], neck, 4), nn.ReLU())
        self.crit = nn.Sequential(
            nn.Flatten(), SeededLinear(seeds, neck, neck), nn.ReLU(),
            nn.Dropout(dropout), SeededLinear(seeds, neck, 1), nn.Sigmoid())

    def forward(self, x: torch.Tensor, parts: int = 1, collect: bool = False,
                shared: bool = False,
                generators: Optional[Sequence[torch.Generator]] = None):
        """x: (P*R*n, 3, 64, 64) parted, or with shared=True (n, 3, 64,
        64) frames every seed reads; generators: one dropout generator
        per seed (needed only in train() mode). Returns the sigmoid
        preds (R, P*n), column p*n + i for frame i of part p, and, with
        collect=True, the 5-entry feature pyramid in the grouped layout
        (P*n rows)."""
        r = self.seeds
        if self.training and generators is not None and len(generators) != r:
            raise ValueError(f"{len(generators)} dropout generators for {r} "
                             "seeds")
        x = x.to(self.compute_dtype)
        x = to_grouped_shared(x, r) if shared else to_grouped(x, r, parts)
        embeds: List[torch.Tensor] = []
        with compute_autocast(x.device.type, self.compute_dtype):
            for layer in self.features:
                if isinstance(layer, nn.Dropout):
                    x = seeded_dropout(x, layer.p, self.training,
                                       generators)
                    continue
                x = layer(x)
                if isinstance(layer, nn.MaxPool2d):
                    embeds.append(x)      # post-pool, pre-dropout
            embeds.append(x)              # bottleneck tap
            h = x.reshape(x.shape[0], r, -1).transpose(0, 1)  # (R, n, neck)
            for layer in self.crit[1:-1]:  # the sigmoid runs in f32 below
                if isinstance(layer, nn.Dropout):
                    h = seeded_dropout(h, layer.p, self.training,
                                       generators)
                else:
                    h = layer(h)
        pred = torch.sigmoid(h.float()).squeeze(-1)
        if collect:
            return pred, embeds
        return pred


class SeededDecoder(nn.Module):
    """R decoders (`models/decoder.py:UnetDecoder`) at the same module
    indices. Each skip join is one `up_cat` on seed-major frames (5
    launches forward, 5 backward, whatever R is); each convolution one
    grouped call."""

    def __init__(self, seeds: int, edims: Sequence[int] = (8, 8, 8, 16),
                 ddims: Sequence[int] = (8, 8, 8, 16),
                 bottleneck: int = 32, masker_channels: int = 16,
                 colorchs: int = 3, chfak: int = 1,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        e = [k * chfak for k in edims]
        d = [k * chfak for k in ddims]
        neck = bottleneck * chfak
        self.seeds = seeds
        self.compute_dtype = compute_dtype
        self.dec_model = nn.ModuleList([
            SeededConv2d(seeds, e[0] + d[1], d[0], 3, padding=1),
            SeededConv2d(seeds, e[1] + d[2], d[1], 3, padding=1),
            SeededConv2d(seeds, e[2] + d[3], d[2], 3, padding=1),
            SeededConv2d(seeds, e[3] + neck, d[3], 3, padding=1),
            SeededConv2d(seeds, neck, neck, 1),
        ])
        self.masker = nn.Sequential(
            SeededConv2d(seeds, colorchs + d[0], masker_channels, 3,
                         padding=1),
            nn.LeakyReLU(0.01),
            SeededConv2d(seeds, masker_channels, 1, 3, padding=1),
            nn.Sigmoid())

    def forward(self, x: torch.Tensor, embeds: List[torch.Tensor]
                ) -> torch.Tensor:
        """x: (R*n, 3, 64, 64) seed-major in [0, 1]; embeds: the seeded
        critic's pyramid in the grouped layout, n rows. Returns the
        masks (R*n, 1, 64, 64) seed-major, float32."""
        r = self.seeds
        x = x.to(self.compute_dtype)
        embeds = [e.to(self.compute_dtype) for e in embeds]
        skips = [from_grouped(e, r) for e in embeds[:4]]
        dec = self.dec_model
        with compute_autocast(x.device.type, self.compute_dtype):
            out = from_grouped(dec[4](embeds[4]), r)
            out = from_grouped(dec[3](to_grouped(up_cat(skips[3], out, 4),
                                                 r)), r)
            out = from_grouped(dec[2](to_grouped(up_cat(skips[2], out), r)),
                               r)
            out = from_grouped(dec[1](to_grouped(up_cat(skips[1], out), r)),
                               r)
            out = from_grouped(dec[0](to_grouped(up_cat(skips[0], out), r)),
                               r)
            h = self.masker[0](to_grouped(up_cat(x, out), r))
            h = self.masker[2](self.masker[1](h))
        return from_grouped(torch.sigmoid(h.float()), r)
