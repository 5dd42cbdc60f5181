"""Model zoo: the reference's research-sandbox nets (PyTorch port of
`cgs_tpu/models/zoo.py`; reference nets.py beyond the two production
models).

NCHW, torch's default init; feed activations `torch.channels_last`
(the U-Nets convert their input once) so the skip joins' NHWC views need
no copy. Layer names are the JAX modules' (`enc0`, `crit1`, `dec3`, ...),
so `models/interop.py:zoo_state_dict_from_flax` carries a JAX parameter
tree across by name; the two torchvision-backbone critics use the
reference's `nn.Sequential` index keys instead (`features.0`,
`head.1`, `resnet.4.0.conv1`, ...), so a reference or torchvision `.pt`
loads with `load_state_dict` (`models/interop.py:load_pt_vgg_critic`,
`load_pt_resnet_critic`).

What the port keeps of the JAX module's semantics:
  * Flax `SAME` padding is asymmetric at stride 2 and odd kernels (low
    side floor, high side ceil of the total), which torch's `padding=`
    cannot say: `Conv2dSame` pads explicitly where the two sides differ.
  * Flax `ConvTranspose` (transpose_kernel=False) correlates the dilated
    input with the kernel as given; torch's `ConvTranspose2d` is the
    gradient of a conv, i.e. correlation with the kernel flipped. Same
    padding geometry (k=4: VALID at stride 1, SAME at stride 2 = torch
    `padding=1`); the converters flip the kernel.
  * `jax.image.resize(..., "nearest")` samples half-pixel centres:
    torch's "nearest-exact". Bilinear with antialias off is
    `F.interpolate(..., "bilinear", align_corners=False)`.
  * BatchNorm: flax momentum 0.9 is torch's 0.1, and flax keeps the
    biased batch variance as its running variance where torch's
    `nn.BatchNorm2d` keeps the unbiased one: `BatchNorm2d` below follows
    the JAX module in train mode (running statistics move only there).
  * Every skip join of `Unet`, `SmallUnet` and `GroundedUnet` is one
    `ops.upsample.up_cat(..., up_first=True)` launch, cat([up(u), skip])
    in the JAX module's channel order; `Unet`'s quirk join
    cat([up(u0), up(u0)]) (nets.py:437) is the upsample of u0 joined with
    u0 upsampled again. `ConvDecoder64x64`'s x4 is one factor-4 launch.
  * `VAE` and `FlexibleUnet` draw their noise and dropout from an
    explicit `torch.Generator` (or take the noise as an argument).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from cgs_tpu_torch.models.critic import compute_autocast
from cgs_tpu_torch.ops.upsample import up_cat

CL = torch.channels_last


def _cl(x: torch.Tensor) -> torch.Tensor:
    """x stored channels_last (no copy when it already is)."""
    return x.contiguous(memory_format=CL)


def _same_pads(size: int, k: int, s: int) -> Tuple[int, int]:
    """Flax/XLA `SAME` padding (low, high) of one spatial axis."""
    out = -(-size // s)
    total = max((out - 1) * s + k - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """`nn.Conv2d` with flax `SAME` padding, asymmetric where it is."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1):
        super().__init__(cin, cout, k, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (k, _), (s, _) = self.kernel_size, self.stride
        (ht, hb), (wl, wr) = (_same_pads(x.shape[2], k, s),
                              _same_pads(x.shape[3], k, s))
        if ht == hb and wl == wr:
            return F.conv2d(x, self.weight, self.bias, self.stride, (ht, wl))
        return F.conv2d(F.pad(x, (wl, wr, ht, hb)), self.weight, self.bias,
                        self.stride)


def _conv(cin: int, cout: int, k: int, stride: int = 1,
          padding: str = "SAME") -> nn.Conv2d:
    if padding == "VALID":
        return nn.Conv2d(cin, cout, k, stride)
    return Conv2dSame(cin, cout, k, stride)


def _max_pool(x: torch.Tensor) -> torch.Tensor:
    return F.max_pool2d(x, 2, 2)


def _nearest(x: torch.Tensor, size: int) -> torch.Tensor:
    """`jax.image.resize(..., "nearest")` to size x size."""
    return F.interpolate(x, size=(size, size), mode="nearest-exact")


def _bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """`jax.image.resize(..., "bilinear", antialias=False)`."""
    return F.interpolate(x, size=(h, w), mode="bilinear",
                         align_corners=False)


class LegacyCritic(nn.Module):
    """The pre-NewCritic conv critic (nets.py:133-157): 4 conv blocks
    (pool or stride-2) then a 4x4 conv to 1 channel; raw output.
    Port of `zoo.LegacyCritic`."""

    def __init__(self, chfak: int = 1, colorchs: int = 3,
                 pool: str = "max"):
        super().__init__()
        self.pool = pool
        stride = 1 if pool == "max" else 2
        dims = [d * chfak for d in (8, 8, 8, 16)]
        ins = [colorchs] + dims[:-1]
        for i, (a, b) in enumerate(zip(ins, dims)):
            self.add_module(f"conv{i}", _conv(a, b, 3, stride))
        self.head = nn.Conv2d(dims[-1], 1, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
            if self.pool == "max":
                x = _max_pool(x)
        return self.head(x)


class SmallCritic(nn.Module):
    """nets.py:315-335: two stride-2 convs + 4x4 head on 16x16.
    Port of `zoo.SmallCritic`."""

    def __init__(self, chfak: int = 1, colorchs: int = 3):
        super().__init__()
        self.conv0 = _conv(colorchs, 8 * chfak, 3, 2)
        self.conv1 = _conv(8 * chfak, 16 * chfak, 3, 2)
        self.head = nn.Conv2d(16 * chfak, 1, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(F.relu(self.conv1(F.relu(self.conv0(x)))))


class NoScaleCritic(nn.Module):
    """nets.py:338-353: stride-1 convs, no downsampling, 4x4 head.
    Port of `zoo.NoScaleCritic`."""

    def __init__(self, chfak: int = 1, colorchs: int = 3):
        super().__init__()
        self.conv0 = _conv(colorchs, 64 * chfak, 3)
        self.conv1 = _conv(64 * chfak, 16 * chfak, 3)
        self.head = nn.Conv2d(16 * chfak, 1, 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(F.relu(self.conv1(F.relu(self.conv0(x)))))


def _flatten_hwc(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W*C) in the JAX modules' NHWC order."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def _unflatten_hwc(h: torch.Tensor, shape) -> torch.Tensor:
    b, c, hh, ww = shape
    return h.reshape(b, hh, ww, c).permute(0, 3, 1, 2)


class AutoEncoder(nn.Module):
    """MLP autoencoder (nets.py:19-47): 32-16-enc_dim tanh stack;
    returns (recon_logits, enc). Port of `zoo.AutoEncoder`; the flat
    vector is in the JAX module's NHWC order."""

    def __init__(self, width: int = 64, enc_dim: int = 1,
                 colorchs: int = 3):
        super().__init__()
        flat = width * width * colorchs
        self.enc0, self.enc1 = nn.Linear(flat, 32), nn.Linear(32, 16)
        self.enc2 = nn.Linear(16, enc_dim)
        self.dec0, self.dec1 = nn.Linear(enc_dim, 16), nn.Linear(16, 32)
        self.dec2 = nn.Linear(32, flat)

    def forward(self, x: torch.Tensor):
        h = torch.tanh(self.enc1(torch.tanh(self.enc0(_flatten_hwc(x)))))
        enc = torch.tanh(self.enc2(h))
        h = torch.tanh(self.dec1(torch.tanh(self.dec0(enc))))
        return _unflatten_hwc(self.dec2(h), x.shape), enc


class VAE(nn.Module):
    """MLP VAE (nets.py:69-103, the working intent of a class the
    reference cannot build). Returns (recon_logits, mean, log_std).
    Port of `zoo.VAE`: the reparameterised sample draws its normal noise
    from `generator`, or takes it as `noise` (B, enc_dim); with neither
    it raises, as the JAX module does without a key."""

    def __init__(self, width: int = 64, enc_dim: int = 8,
                 colorchs: int = 3):
        super().__init__()
        flat = width * width * colorchs
        self.enc_dim = enc_dim
        self.enc0, self.enc1 = nn.Linear(flat, 32), nn.Linear(32, 16)
        self.enc2 = nn.Linear(16, 2 * enc_dim)
        self.dec0, self.dec1 = nn.Linear(enc_dim, 16), nn.Linear(16, 32)
        self.dec2 = nn.Linear(32, flat)

    def forward(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                deterministic: bool = False,
                noise: Optional[torch.Tensor] = None):
        h = F.relu(self.enc1(F.relu(self.enc0(_flatten_hwc(x)))))
        stats = self.enc2(h)
        mean, log_std = stats[:, :self.enc_dim], stats[:, self.enc_dim:]
        if deterministic:
            sample = mean
        else:
            if noise is None:
                if generator is None:
                    raise ValueError(
                        "VAE needs a generator (or noise) for the "
                        "reparameterized sample (pass deterministic=True "
                        "for the eval-time mean path)")
                noise = torch.randn(mean.shape, generator=generator,
                                    device=mean.device, dtype=mean.dtype)
            sample = mean + torch.exp(log_std) * noise
        h = F.relu(self.dec1(F.relu(self.dec0(sample))))
        return _unflatten_hwc(self.dec2(h), x.shape), mean, log_std


def vae_loss(recon_logits, target, mean, log_std) -> torch.Tensor:
    """BCE-with-logits (sum) + KL (nets.py:111-117)."""
    bce = torch.sum(recon_logits.clamp_min(0) - recon_logits * target
                    + torch.log1p(torch.exp(-recon_logits.abs())))
    kl = -0.5 * torch.sum(1 + log_std - mean ** 2 - torch.exp(log_std))
    return bce + kl


class ConvEncoder64x64(nn.Module):
    """Generic 64x64 conv encoder (nets.py:223-257): 4 conv+pool blocks
    -> 4x4 conv -> tanh (1x1 spatial). embed=True also returns every
    post-activation map resized (nearest) to 64x64 and concatenated on
    the channels. Port of `zoo.ConvEncoder64x64`."""

    def __init__(self, pooling: str = "max", enc_dim: int = 1,
                 in_chs: int = 3, chfak: int = 1):
        super().__init__()
        self.pooling = pooling
        stride = 1 if pooling in ("max", "avg") else 2
        dims = [d * chfak for d in (8, 8, 16, 16)]
        ins = [in_chs] + dims[:-1]
        for i, (a, b) in enumerate(zip(ins, dims)):
            self.add_module(f"conv{i}", _conv(a, b, 3, stride))
        self.neck = nn.Conv2d(dims[-1], enc_dim, 4)

    def forward(self, x: torch.Tensor, embed: bool = False):
        embeds = []
        for i in range(4):
            x = F.relu(getattr(self, f"conv{i}")(x))
            if embed:
                embeds.append(_nearest(x, 64))
            if self.pooling == "max":
                x = _max_pool(x)
            elif self.pooling == "avg":
                x = F.avg_pool2d(x, 2, 2)
        x = torch.tanh(self.neck(x))
        if embed:
            embeds.append(_nearest(x, 64))
            return x, torch.cat(embeds, 1)
        return x


class ConvDecoder64x64(nn.Module):
    """nets.py:260-285: x4 upsample then 4 conv + x2-upsample stages.
    Port of `zoo.ConvDecoder64x64`: the x4 is one factor-4 launch of the
    upsample kernel, each x2 one launch."""

    def __init__(self, enc_dim: int = 1, out_chs: int = 3, chfak: int = 1):
        super().__init__()
        d = 8 * chfak
        for i in range(4):
            self.add_module(f"conv{i}", _conv(enc_dim if i == 0 else d, d, 3))
        self.out = _conv(d, out_chs, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = up_cat(None, _cl(x), 4)
        for i in range(4):
            x = up_cat(None, _cl(F.relu(getattr(self, f"conv{i}")(x))))
        return self.out(x)


class PolicyNet(nn.Module):
    """MineRL agent remnant (nets.py:288-312): encoder -> linear -> tanh
    logits; `greedy_action` mirrors get_action's argmax. Port of
    `zoo.PolicyNet`."""

    def __init__(self, enc_dim: int = 64, in_chs: int = 6,
                 out_chs: int = 64, chfak: int = 1):
        super().__init__()
        self.encoder = ConvEncoder64x64(enc_dim=enc_dim, in_chs=in_chs,
                                        chfak=chfak)
        self.head = nn.Linear(enc_dim, out_chs)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        h = F.relu(self.encoder(obs)).reshape(obs.shape[0], -1)
        return torch.tanh(self.head(h))

    @staticmethod
    def greedy_action(logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, -1)


def _leaky(h: torch.Tensor) -> torch.Tensor:
    return F.leaky_relu(h, 0.2)


class Unet(nn.Module):
    """Full encoder + decoder U-Net with a built-in critic head
    (nets.py:356-449), the predecessor of the split Critic /
    UnetDecoder design that TrainHandler trains; LeakyReLU(0.2). Port of
    `zoo.Unet`.

    forward(x, critic=True) -> the critic score (B, 1) from the
    bottleneck, with no decoder work (no join launches); otherwise the
    sigmoid mask (B, 1, 64, 64), and the u0 features with embeds=True.
    The state_dict is the full tree either way. Each of the four joins
    is one up-first `up_cat` launch forward and one backward; the last
    is the reference's cat(ups(u0), ups(u0)) quirk (nets.py:437)."""

    def __init__(self, edims: Sequence[int] = (8, 8, 8, 16),
                 ddims: Sequence[int] = (8, 8, 8, 16), bottleneck: int = 32,
                 colorchs: int = 3, chfak: int = 1):
        super().__init__()
        e = [d * chfak for d in edims]
        dd = [d * chfak for d in ddims]
        self.enc0 = _conv(colorchs, e[0], 3)
        self.enc1 = _conv(e[0], e[1], 3)
        self.enc2 = _conv(e[1], e[2], 3)
        self.enc3 = _conv(e[2], e[3], 3)
        self.enc4 = nn.Conv2d(e[3], bottleneck, 4)
        self.crit0 = nn.Linear(bottleneck, 32)
        self.crit1 = nn.Linear(32, 1)
        self.dec4 = nn.ConvTranspose2d(bottleneck, dd[3], 4)
        self.dec3 = _conv(e[3] + dd[3], dd[2], 3)
        self.dec2 = _conv(e[2] + dd[2], dd[1], 3)
        self.dec1 = _conv(e[1] + dd[1], dd[0], 3)
        self.dec0 = _conv(e[0] + dd[0], 1, 3)

    def forward(self, x: torch.Tensor, critic: bool = False,
                embeds: bool = False):
        x = _cl(x)
        x0 = _leaky(self.enc0(x))
        x1 = _leaky(self.enc1(_max_pool(x0)))
        x2 = _leaky(self.enc2(_max_pool(x1)))
        x3 = _leaky(self.enc3(_max_pool(x2)))
        x4 = _leaky(self.enc4(_max_pool(x3)))
        h = F.relu(self.crit0(x4.reshape(x4.shape[0], -1)))
        score = self.crit1(h)
        if critic:
            return score
        u3 = _cl(_leaky(self.dec4(x4)))
        u2 = _cl(_leaky(self.dec3(up_cat(_cl(x3), u3, up_first=True))))
        u1 = _cl(_leaky(self.dec2(up_cat(_cl(x2), u2, up_first=True))))
        u0 = _cl(_leaky(self.dec1(up_cat(_cl(x1), u1, up_first=True))))
        up0 = up_cat(None, u0)
        y = torch.sigmoid(self.dec0(up_cat(up0, u0, up_first=True)))
        return (y, u0) if embeds else y


class SmallUnet(nn.Module):
    """3-level U-Net (nets.py:526-561). Port of `zoo.SmallUnet`."""

    def __init__(self, edims: Sequence[int] = (8, 8, 16),
                 ddims: Sequence[int] = (8, 8, 16), colorchs: int = 3,
                 chfak: int = 1):
        super().__init__()
        e = [d * chfak for d in edims]
        dd = [d * chfak for d in ddims]
        self.enc0 = _conv(colorchs, e[0], 3)
        self.enc1 = _conv(e[0], e[1], 3)
        self.enc2 = nn.Conv2d(e[1], e[2], 4)
        self.dec2 = nn.ConvTranspose2d(dd[2], dd[1], 4)
        self.dec1 = _conv(e[1] + dd[1], dd[0], 3)
        self.dec0 = _conv(e[0] + dd[0], 1, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _cl(x)
        x0 = F.relu(self.enc0(x))
        x1 = F.relu(self.enc1(_max_pool(x0)))
        x2 = F.relu(self.enc2(_max_pool(x1)))
        u1 = _cl(F.relu(self.dec2(x2)))
        u0 = _cl(F.relu(self.dec1(up_cat(_cl(x1), u1, up_first=True))))
        return torch.sigmoid(self.dec0(up_cat(_cl(x0), u0, up_first=True)))


class GroundedUnet(nn.Module):
    """U-Net with RGB re-grounding at every encoder scale
    (nets.py:646-701): the bilinearly downsampled input is concatenated
    before encoder convs 1-3. Port of `zoo.GroundedUnet`."""

    def __init__(self, edims: Sequence[int] = (8, 8, 8, 16, 32),
                 ddims: Sequence[int] = (8, 8, 8, 16, 32),
                 colorchs: int = 3):
        super().__init__()
        e, dd = list(edims), list(ddims)
        self.enc0 = _conv(colorchs, e[0], 3)
        self.enc1 = _conv(3 + e[0], e[1], 3)
        self.enc2 = _conv(3 + e[1], e[2], 3)
        self.enc3 = _conv(3 + e[2], e[3], 3)
        self.enc4 = nn.Conv2d(e[3], e[4], 4)
        self.dec4 = nn.ConvTranspose2d(dd[4], dd[3], 4)
        self.dec3 = _conv(e[3] + dd[3], dd[2], 3)
        self.dec2 = _conv(e[2] + dd[2], dd[1], 3)
        self.dec1 = _conv(e[1] + dd[1], dd[0], 3)
        self.dec0 = _conv(e[0] + dd[0], 1, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def down(h):
            return _cl(_bilinear(h, h.shape[2] // 2, h.shape[3] // 2))

        x = _cl(x)
        x0 = F.relu(self.enc0(x))
        d1 = down(x)
        x1 = F.relu(self.enc1(torch.cat([_max_pool(x0), d1], 1)))
        d2 = down(d1)
        x2 = F.relu(self.enc2(torch.cat([_max_pool(x1), d2], 1)))
        d3 = down(d2)
        x3 = F.relu(self.enc3(torch.cat([_max_pool(x2), d3], 1)))
        x4 = F.relu(self.enc4(_max_pool(x3)))
        u3 = _cl(F.relu(self.dec4(x4)))
        u2 = _cl(F.relu(self.dec3(up_cat(_cl(x3), u3, up_first=True))))
        u1 = _cl(F.relu(self.dec2(up_cat(_cl(x2), u2, up_first=True))))
        u0 = _cl(F.relu(self.dec1(up_cat(_cl(x1), u1, up_first=True))))
        return torch.sigmoid(self.dec0(up_cat(_cl(x0), u0, up_first=True)))


class FlexibleUnet(nn.Module):
    """Programmatic-depth hourglass (nets.py:564-643): log2(wid)-1
    stride-2 conv encoder doubling channels from 8*hidfac, mirrored
    transposed-conv decoder, sigmoid output, no skips. Port of
    `zoo.FlexibleUnet`; with dropout=True each activation drops with p
    0.3 unless `deterministic`, drawing from `generator`."""

    def __init__(self, in_dim: int = 3, chs: int = 1, wid: int = 64,
                 hidfac: float = 1.0, dropout: bool = False, neck: int = 1):
        super().__init__()
        self.dropout = dropout
        self.folds = list(range(1, int(np.log2(wid))))
        bottleneck = max(self.folds)
        hf = hidfac

        def width(i):
            return int(2 ** (3 + i) * hf * (neck if i == bottleneck else 1))

        self.enc0 = nn.Conv2d(in_dim, int(8 * hf), 4, 2, padding=1)
        for i in self.folds:
            self.add_module(f"enc{i}", nn.Conv2d(int(2 ** (2 + i) * hf),
                                                 width(i), 4, 2, padding=1))
        for i in reversed(self.folds):
            self.add_module(f"dec{i}", nn.ConvTranspose2d(
                width(i), int(2 ** (2 + i) * hf), 4, 2, padding=1))
        self.dec0 = nn.ConvTranspose2d(int(8 * hf), chs, 4, 2, padding=1)

    def forward(self, x: torch.Tensor, deterministic: bool = True,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        from cgs_tpu_torch.models.critic import dropout

        def act(h):
            h = F.relu(h)
            if self.dropout:
                h = dropout(h, 0.3, not deterministic, generator)
            return h

        x = act(self.enc0(x))
        for i in self.folds:
            x = act(getattr(self, f"enc{i}")(x))
        for i in reversed(self.folds):
            x = act(getattr(self, f"dec{i}")(x))
        return torch.sigmoid(self.dec0(x))


# ---------------------------------------------------------------------
# pretrained-backbone critics (nets.py:704-804)
# ---------------------------------------------------------------------

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def imagenet_normalize(x: torch.Tensor) -> torch.Tensor:
    """nets.py:802-804 get_normalizer, NCHW."""
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device).view(1, 3, 1, 1)
    std = torch.as_tensor(IMAGENET_STD, device=x.device).view(1, 3, 1, 1)
    return (x - mean) / std


VGG11_CFG = (64, "M", 128, "M", 256, 256, "M", 512, 512, "M", 512, 512,
             "M")


class VGG11Features(nn.Sequential):
    """torchvision vgg11 `.features` (nets.py:753-758) at its own
    indices (convs at 0, 3, 6, 8, 11, 13, 16, 18): 64x64 -> (512, 2, 2).
    collect_embeds=True (VGGEmbedder, nets.py:744-748) also returns every
    post-ReLU map resized bilinearly to 64x64, concatenated on the
    channels. Port of `zoo.VGG11Features`."""

    def __init__(self, collect_embeds: bool = False):
        layers, cin = [], 3
        for v in VGG11_CFG:
            if v == "M":
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(cin, v, 3, padding=1), nn.ReLU()]
                cin = v
        super().__init__(*layers)
        self.collect_embeds = collect_embeds

    def forward(self, x: torch.Tensor):
        embeds = []
        for layer in self:
            x = layer(x)
            if self.collect_embeds and isinstance(layer, nn.ReLU):
                embeds.append(_bilinear(x, 64, 64))
        if self.collect_embeds:
            return x, torch.cat(embeds, 1)
        return x


class VGGCritic(nn.Module):
    """nets.py:761-787: VGG11 features + 256-128-1 MLP head. Port of
    `zoo.VGGCritic`, the reference's keys (`features.*`, `head.{1,3,5}`);
    the head flattens NCHW, as the reference's does."""

    def __init__(self, resize: int = 64):
        super().__init__()
        self.resize = resize
        fak = resize // 64
        self.features = VGG11Features()
        self.head = nn.Sequential(
            nn.Flatten(), nn.Linear(512 * 2 * fak * 2 * fak, 256), nn.ReLU(),
            nn.Linear(256, 128), nn.ReLU(), nn.Linear(128, 1))

    def forward(self, x: torch.Tensor, normalize: bool = True
                ) -> torch.Tensor:
        if normalize:
            x = imagenet_normalize(x)
        if self.resize != 64:
            x = _nearest(x, self.resize)
        return self.head(self.features(x))


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` (momentum 0.1, eps 1e-5) whose train-mode pass
    normalises with the biased batch variance and keeps it as the
    running variance, as the JAX module's flax BatchNorm does (torch's
    own keeps the unbiased one). Eval mode is torch's."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        mean = x.mean((0, 2, 3))
        var = ((x * x).mean((0, 2, 3)) - mean * mean).clamp_min(0.0)
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1 - m).add_(m * mean.detach())
            self.running_var.mul_(1 - m).add_(m * var.detach())
            self.num_batches_tracked.add_(1)
        shape = (1, -1, 1, 1)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return (x - mean.view(shape)) * scale.view(shape) \
            + self.bias.view(shape)


class ResNetBlock(nn.Module):
    """torchvision's BasicBlock (`conv1`, `bn1`, `conv2`, `bn2`,
    `downsample`), padding 1 on both sides at stride 2 as torch pads.
    Port of `zoo.ResNetBlock`."""

    def __init__(self, cin: int, filters: int, strides: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(cin, filters, 3, strides, 1, bias=False)
        self.bn1 = BatchNorm2d(filters)
        self.conv2 = nn.Conv2d(filters, filters, 3, 1, 1, bias=False)
        self.bn2 = BatchNorm2d(filters)
        self.downsample = None
        if strides != 1 or cin != filters:
            self.downsample = nn.Sequential(
                nn.Conv2d(cin, filters, 1, strides, bias=False),
                BatchNorm2d(filters))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.bn2(self.conv2(F.relu(self.bn1(self.conv1(x)))))
        res = x if self.downsample is None else self.downsample(x)
        return F.relu(res + y)


class ResNet18Features(nn.Sequential):
    """torchvision resnet18 children[0:8] (nets.py:790-793) at their
    indices: 0 conv1, 1 bn1, 2 relu, 3 maxpool, 4-7 layer1-4 of two
    blocks each. 64x64 -> (512, 2, 2). Port of `zoo.ResNet18Features`."""

    def __init__(self):
        layers = [nn.Conv2d(3, 64, 7, 2, 3, bias=False), BatchNorm2d(64),
                  nn.ReLU(), nn.MaxPool2d(3, 2, 1)]
        cin = 64
        for stage, filters in enumerate((64, 128, 256, 512)):
            blocks = []
            for block in range(2):
                strides = 2 if stage > 0 and block == 0 else 1
                blocks.append(ResNetBlock(cin, filters, strides))
                cin = filters
            layers.append(nn.Sequential(*blocks))
        super().__init__(*layers)


class ImageNetCritic(nn.Module):
    """The input of the critics on an ImageNet backbone (`ResNetCritic`,
    `models/convnext.py:ConvNeXtCritic`, `models/swin.py:SwinV2Critic`):
    frames in [0, 1], or in [0, 255] when their maximum is above 1
    (nets.py:721), normalised by the ImageNet mean and std
    (nets.py:802-804). The mean and std are buffers outside the
    state_dict, so a forward on the card makes no host copy."""

    def __init__(self):
        super().__init__()
        self.register_buffer("mean", torch.as_tensor(IMAGENET_MEAN).view(
            1, 3, 1, 1), persistent=False)
        self.register_buffer("std", torch.as_tensor(IMAGENET_STD).view(
            1, 3, 1, 1), persistent=False)

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.where(x.max() > 1.0, x / 255.0, x)    # nets.py:721
        return (x - self.mean) / self.std               # nets.py:802-804


class ResNetCritic(ImageNetCritic):
    """nets.py:704-730: ImageNet-normalised ResNet18 features + 256-1
    head, no sigmoid. Port of `zoo.ResNetCritic`, the reference's keys
    (`resnet.*`, `head.{1,3}`); train mode moves the BatchNorm
    statistics.

    The critic interface of `models/critic.py:Critic`, so that
    `MaskPipeline` and the masker step run it with the paper's
    `UnetDecoder` on its pyramid (`models/build.py`): `forward(x,
    collect=True)` also returns the five post-ReLU taps, stored
    channels_last: the stem's ReLU (64 @ 32x32) and layer1-4 (64 @
    16x16, 128 @ 8x8, 256 @ 4x4, 512 @ 2x2, the neck). `generator` is
    accepted and unused (no dropout). Under `compute_dtype=
    torch.bfloat16` the convolutions and linears run in bf16 with f32
    parameters, as in `Critic`. `batch_norms` lists the 20 BatchNorm
    layers in forward order; the input is `ImageNetCritic`'s."""

    def __init__(self, compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.resnet = ResNet18Features()
        self.head = nn.Sequential(nn.Flatten(), nn.Linear(512 * 2 * 2, 256),
                                  nn.ReLU(), nn.Linear(256, 1))
        self.batch_norms = [m for m in self.modules()
                            if isinstance(m, nn.BatchNorm2d)]

    def forward(self, x: torch.Tensor, collect: bool = False,
                generator: Optional[torch.Generator] = None):
        """x: (B, 3, 64, 64). The score (B, 1) and, with collect=True,
        the five taps."""
        x = self.normalize(x)
        taps = []
        with compute_autocast(x.device.type, self.compute_dtype):
            for i, layer in enumerate(self.resnet):
                x = layer(x)
                if i == 2 or i >= 4:        # the stem's ReLU, layer1-4
                    taps.append(_cl(x))
            score = self.head(x)
        if self.compute_dtype == torch.bfloat16:
            score = score.float()
        return (score, taps) if collect else score


class Printer(nn.Module):
    """Shape-printing identity (nets.py:10-16). Port of `zoo.Printer`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        print(tuple(x.shape))
        return x


class Pass(nn.Module):
    """Identity module (nets.py:215-220). Port of `zoo.Pass`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x

