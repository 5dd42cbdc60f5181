"""Operations and bytes counted from shapes, and the card's published
peaks. Frozen here: a change to the program does not change them.

FLOPs are 2 x the multiply-adds of every convolution and linear layer a
path runs; in training each input gradient (dgrad) and weight gradient
(wgrad) the step needs costs as many as the layer's forward.
Elementwise work (ReLU, pooling, dropout, sigmoid, the merges, the
losses, Adam) and the joins' copies are not counted. Bytes count each
input once and each output once, whatever a kernel reads again.
"""

from __future__ import annotations

from portbench.lib.shapes import FRAME, critic_layers, decoder_layers, joins

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
PEAK_F32_FLOPS = 67e12          # float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES_PER_S = 3.35e12
L2_BYTES = 50e6

F32 = 4
PIXELS = FRAME * FRAME


def critic_macs(cfg) -> int:
    return sum(L.macs_per_frame for L in critic_layers(cfg))


def decoder_macs(cfg) -> int:
    return sum(L.macs_per_frame for L in decoder_layers(cfg))


def process_flops_per_frame(cfg) -> int:
    """One frame through the critic (with its pyramid) and the decoder."""
    return 2 * (critic_macs(cfg) + decoder_macs(cfg))


def masker_step_flops(cfg, k: int) -> int:
    """One masker step with the critic frozen (protocol B, `-frozen`) and
    fuse 'both' (the port's default, `train/losses.py`): A is 2K frames
    (K high || K low), B 2K contrast negatives.

    forward: the critic on A || B (4K), the decoder on A (2K), the
    critic on replaced || injected (4K). backward: the critic pass on
    the merged frames needs every layer's dgrad (the loss reaches the
    mask through the merged frames) and no wgrad; the decoder needs
    every wgrad and the dgrad of every layer whose input carries a
    gradient, which is all but dec_model.4 (it reads the frozen
    critic's bottleneck)."""
    if not cfg["train"]["frozen"]:
        raise ValueError("masker_step_flops counts the frozen critic only")
    n_a = 2 * k
    crit, dec = critic_macs(cfg), decoder_macs(cfg)
    dec_dgrad = dec - decoder_layers(cfg)[0].macs_per_frame
    macs = (2 * n_a * crit          # critic forward on A || B
            + n_a * dec             # decoder forward on A
            + 2 * n_a * crit        # critic forward on the merged batch
            + 2 * n_a * crit        # its dgrad
            + n_a * dec_dgrad       # decoder dgrad
            + n_a * dec)            # decoder wgrad
    return 2 * macs


def ingest_bytes(n: int, out_bytes: int = F32) -> int:
    """uint8 (n, 64, 64, 3) read once, float (n, 64, 64, 3) written."""
    return n * PIXELS * 3 * (1 + out_bytes)


def joins_bytes(cfg, n: int, elem: int = F32) -> int:
    """The five decoder joins of a batch of n: skip and x read once, the
    joined buffer written once."""
    total = 0
    for cs, hs, cx, hx, _ in joins(cfg):
        total += cs * hs * hs + cx * hx * hx + (cs + cx) * hs * hs
    return n * total * elem


def bound_s(nbytes: float = 0.0, flops: float = 0.0,
            peak_flops: float = PEAK_F32_FLOPS) -> float:
    """The least time the card could take: the larger of the two."""
    return max(nbytes / PEAK_HBM_BYTES_PER_S, flops / peak_flops)
