"""int8 inference for the mask pipeline (PyTorch port of
`cgs_tpu/ops/quant.py:64-241`): `MaskPipeline(..., quantize="int8")`.

Scheme (post-training quantization, as the JAX package's):
  * weights: per-output-channel symmetric int8 over each conv weight's
    (I, H, W) in torch's OIHW layout (the set JAX reduces over in
    HWIO), `scale[o] = max(max|W[o]| / 127, 1e-12)`, quantized once per
    `update_params`; the dense head and every bias stay f32;
  * activations: per-tensor symmetric int8, the scale dynamic
    (`max(max|x|, 1e-12) / 127` per conv input) or static (baked from a
    calibration batch by `calibrate_act_scales` + `merge_act_scales`);
    `round` (half to even, as `jnp.round`), then clip to +-127;
  * each convolution s8 x s8 -> s32, then `y * (sa * scale) + bias` in
    f32, cast to the compute dtype.

The JAX package ran these convolutions through XLA
(`lax.conv_general_dilated` with int32 accumulation), not Pallas, so
there is no TPU kernel to port here. On the card `conv_s32` is im2col
patches times `torch._int_mm` (cuBLASLt's int8 tensor-core GEMM), the
patches built a chunk of frames at a time, at most `MAX_ROWS` rows
(70 MB at the widest K), K and N zero-padded to multiples of 8 as
`_int_mm` asks.
On the CPU it is `conv_s32_plain`, a float64 convolution of the
int8-valued tensors: exact (every partial sum is an integer below
2^53; float32 would not be, since 127^2 * 9 * C_in passes 2^24 at the
decoder's wide inputs), and the oracle of the card's version.

The forwards `critic_apply_q` / `masker_apply_q` mirror `Critic` and
`UnetDecoder` (`models/critic.py`, `models/decoder.py`) in eval mode,
on NCHW activations stored channels_last; the decoder's skip joins are
`ops.upsample.up_cat`, the fused upsample-into-concat kernel on the
card, so the int8 path launches the same 1 ingest + 5 join kernels per
batch as the f32 one. `mode="f32"` runs the same skeleton with f32
convolutions on the raw state_dicts (the wiring's parity mode).

Parameters are the port's state_dicts ({"features.0.weight": ...});
`quantize_tree` turns each conv weight into an int8 `weight` plus a
`weight_scale` (O,) and `merge_act_scales` adds an `act_scale` scalar.
Layer names (`only=`, the calibration records) are the state_dict
prefixes, e.g. "masker.0" for the JAX package's "mask0".

Divergence from the JAX package, documented (ADVICE r5 #1): a baked
activation scale is clamped at >= 1e-12, so a conv input that was all
zero in the calibration batch still quantizes to numbers and gives
finite masks, where the JAX package's `conv_q` divides by 0 (NaN at
the zeros before its int8 cast).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from cgs_tpu_torch.ops.upsample import up_cat

MAX_ROWS = 1 << 15        # rows of one `_int_mm` GEMM (see conv_s32_mm)
SCALE_FLOOR = 1e-12

CRITIC_CONVS = (("features.0", 1), ("features.3", 1), ("features.6", 1),
                ("features.10", 1), ("features.14", 0))


def _is_conv_weight(key: str, v: torch.Tensor) -> bool:
    return key.endswith(".weight") and v.dim() == 4


def quantize_tree(params: Dict, only=None) -> Dict:
    """{name: state_dict} (or one state_dict) of f32 tensors -> the same
    nesting with every conv weight as int8 `weight` + f32 `weight_scale`
    (O,); dense weights and biases are copied as they are. only: layer
    names to quantize (e.g. {"masker.0", "masker.2"}); the other convs
    keep f32 weights and run as f32 convolutions."""
    out = {}
    for key, v in params.items():
        if isinstance(v, dict):
            out[key] = quantize_tree(v, only)
            continue
        layer = key.rsplit(".", 1)[0]
        if not _is_conv_weight(key, v) or (only is not None
                                           and layer not in only):
            out[key] = v
            continue
        k = v.float()
        scale = (k.abs().amax(dim=(1, 2, 3)) / 127.0).clamp_min(SCALE_FLOOR)
        out[key] = torch.round(k / scale.view(-1, 1, 1, 1)).clamp_(
            -127, 127).to(torch.int8)
        out[f"{layer}.weight_scale"] = scale
    return out


def conv_s32_plain(xq: torch.Tensor, wq: torch.Tensor,
                   padding: int) -> torch.Tensor:
    """s8 x s8 -> s32 convolution as a float64 convolution of the int8
    values (exact): xq (B, C, H, W) int8, wq (O, C, kh, kw) int8 ->
    (B, O, H', W') int32, channels_last."""
    y = F.conv2d(xq.double(), wq.double(), padding=padding)
    return y.to(torch.int32).contiguous(memory_format=torch.channels_last)


def _up8(n: int) -> int:
    return -(-n // 8) * 8


def conv_s32_mm(xq: torch.Tensor, wq: torch.Tensor,
                padding: int) -> torch.Tensor:
    """The same convolution as im2col patches times `torch._int_mm`, a
    chunk of frames at a time (at most MAX_ROWS rows): xq (B, C, H, W)
    int8 stored channels_last, wq (O, C, kh, kw) int8 -> (B, O, H', W')
    int32, channels_last. The patches' K = C*kh*kw (in the weight's
    (C, kh, kw) order) and N = O are zero-padded to multiples of 8, the
    rows to at least 32 (`_int_mm` wants more than 16)."""
    b, c, h, w = xq.shape
    o, _, kh, kw = wq.shape
    ho, wo = h + 2 * padding - kh + 1, w + 2 * padding - kw + 1
    k, kp, np_ = c * kh * kw, _up8(c * kh * kw), _up8(o)
    wmat = torch.zeros((np_, kp), dtype=torch.int8, device=xq.device)
    wmat[:o, :k] = wq.reshape(o, k)
    x = xq.permute(0, 2, 3, 1)                        # NHWC view
    if padding:
        x = F.pad(x, (0, 0, padding, padding, padding, padding))
    win = x.unfold(1, kh, 1).unfold(2, kw, 1)         # (B, H', W', C, kh, kw)
    hw = ho * wo
    # on the H100 cuBLASLt answers NOT_SUPPORTED for conv0's GEMM (K 32,
    # N 40) beyond 32768 rows, which every shape here takes
    chunk = max(1, min(b, MAX_ROWS // hw))
    # 32 spare rows: a chunk of fewer than 32 rows (the last one at
    # most) is padded to 32
    out = torch.empty((b * hw + 32, np_), dtype=torch.int32,
                      device=xq.device)
    # one patch buffer for every chunk (the stream orders its reuse);
    # its padding columns stay zero
    pat = torch.zeros((max(chunk * hw, 32), kp), dtype=torch.int8,
                      device=xq.device)
    for lo in range(0, b, chunk):
        hi = min(b, lo + chunk)
        rows = (hi - lo) * hw
        m = max(rows, 32)
        if m > rows:
            pat[rows:m].zero_()
        pat[:rows, :k].view(hi - lo, ho, wo, k).unflatten(
            -1, (c, kh, kw)).copy_(win[lo:hi])
        torch._int_mm(pat[:m], wmat.t(), out=out[lo * hw:lo * hw + m])
    y = out[:b * hw].view(b, ho, wo, np_)[..., :o]
    return y.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)


def conv_s32(xq: torch.Tensor, wq: torch.Tensor, padding: int
             ) -> torch.Tensor:
    """s8 x s8 -> s32 convolution: `conv_s32_mm` on a CUDA tensor,
    `conv_s32_plain` on a CPU one."""
    if xq.device.type == "cpu":
        return conv_s32_plain(xq, wq, padding)
    if xq.device.type != "cuda":
        raise ValueError(f"conv_s32: expected a CUDA or CPU tensor, got "
                         f"{xq.device}")
    return conv_s32_mm(xq, wq, padding)


def act_quant(x: torch.Tensor, act_scale: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 x, its f32 scale): the scale dynamic `max(max|x|, 1e-12) /
    127` when act_scale is None, else act_scale."""
    xf = x.float()
    sa = (xf.abs().amax().clamp_min(SCALE_FLOOR) / 127.0
          if act_scale is None else act_scale)
    return torch.round(xf / sa).clamp_(-127, 127).to(torch.int8), sa


def conv_q(wq: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
           x: torch.Tensor, padding: int, compute_dtype,
           act_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """int8 convolution of x (B, C, H, W): the s32 sums rescaled in f32,
    `y * (sa * scale) + bias`, cast to compute_dtype."""
    xq, sa = act_quant(x, act_scale)
    y = conv_s32(xq, wq, padding)
    y = y.float() * (sa * scale).view(1, -1, 1, 1) + bias.view(1, -1, 1, 1)
    return y.to(compute_dtype)


def conv_f32(weight: torch.Tensor, bias: torch.Tensor, x: torch.Tensor,
             padding: int, compute_dtype) -> torch.Tensor:
    """The convolution on raw weights in compute_dtype (parity mode, and
    the layers `quantize_tree(only=...)` left out)."""
    return F.conv2d(x.to(compute_dtype), weight.to(compute_dtype),
                    bias.to(compute_dtype), padding=padding)


def _make_conv(qp: Dict, mode: str, compute_dtype, record=None):
    def conv(name: str, x: torch.Tensor, padding: int) -> torch.Tensor:
        w, b = qp[f"{name}.weight"], qp[f"{name}.bias"]
        if mode == "int8" and f"{name}.weight_scale" in qp:
            return conv_q(w, qp[f"{name}.weight_scale"], b, x, padding,
                          compute_dtype, qp.get(f"{name}.act_scale"))
        if record is not None:      # calibration tap
            m = x.float().abs().amax()
            record[name] = m if name not in record else torch.maximum(
                record[name], m)
        return conv_f32(w, b, x, padding, compute_dtype)
    if mode not in ("int8", "f32"):
        raise ValueError(f"mode={mode!r} not in ('int8', 'f32')")
    return conv


def critic_apply_q(qp: Dict, x: torch.Tensor, *, mode: str = "int8",
                   compute_dtype=torch.float32, record=None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The eval-mode `Critic(x, collect=True)` on a critic state_dict
    (quantized by `quantize_tree`, or raw with mode='f32'): x (B, 3, 64,
    64) NCHW stored channels_last in [0, 1]. Returns (sigmoid pred (B,
    1) float32, the 5-entry feature pyramid)."""
    conv = _make_conv(qp, mode, compute_dtype, record)
    x = x.to(compute_dtype)
    embeds: List[torch.Tensor] = []
    for name, pad in CRITIC_CONVS[:4]:
        x = F.max_pool2d(F.relu(conv(name, x, pad)), 2)
        embeds.append(x)             # post-pool, pre-dropout
    name, pad = CRITIC_CONVS[4]
    x = F.relu(conv(name, x, pad))
    embeds.append(x)
    # the (neck, neck) + (neck, 1) head stays f32 weights
    h = x.reshape(x.shape[0], -1)
    h = F.relu(F.linear(h, qp["crit.1.weight"].to(compute_dtype),
                        qp["crit.1.bias"].to(compute_dtype)))
    h = F.linear(h, qp["crit.4.weight"].to(compute_dtype),
                 qp["crit.4.bias"].to(compute_dtype))
    return torch.sigmoid(h.float()), embeds


def masker_apply_q(qp: Dict, x: torch.Tensor, embeds: List[torch.Tensor],
                   *, mode: str = "int8", compute_dtype=torch.float32,
                   record=None) -> torch.Tensor:
    """The `UnetDecoder(x, embeds)` forward on a decoder state_dict: no
    activation between the decoder convs, leaky ReLU only in the mask
    head, each skip join one `up_cat`. Returns the mask (B, 1, 64, 64)
    float32."""
    conv = _make_conv(qp, mode, compute_dtype, record)
    x = x.to(compute_dtype)
    embeds = [e.to(compute_dtype) for e in embeds]
    out = conv("dec_model.4", embeds[4], 0)
    out = conv("dec_model.3", up_cat(embeds[3], out, 4), 1)
    out = conv("dec_model.2", up_cat(embeds[2], out), 1)
    out = conv("dec_model.1", up_cat(embeds[1], out), 1)
    out = conv("dec_model.0", up_cat(embeds[0], out), 1)
    h = F.leaky_relu(conv("masker.0", up_cat(x, out), 1), 0.01)
    h = conv("masker.2", h, 1)
    return torch.sigmoid(h.float())


def calibrate_act_scales(params: Dict, x: torch.Tensor, *,
                         separate: bool = False,
                         compute_dtype=torch.float32
                         ) -> Dict[str, Dict[str, float]]:
    """Static activation scales {model: {layer: max|input| / 127}} from
    one f32-mode forward of the calibration frames x (B, 3, 64, 64),
    NCHW stored channels_last, on the params' device. A few hundred
    frames suffice: the scales are per-tensor maxima."""
    rec: Dict[str, Dict[str, torch.Tensor]] = {"critic": {}, "masker": {}}
    cc = dict(mode="f32", compute_dtype=compute_dtype)
    with torch.no_grad():
        _, em = critic_apply_q(params["critic"], x, record=rec["critic"],
                               **cc)
        if separate:
            rec["sepcrit"] = {}
            _, em = critic_apply_q(params["sepcrit"], x,
                                   record=rec["sepcrit"], **cc)
        masker_apply_q(params["masker"], x, em, record=rec["masker"], **cc)
    return {sub: {k: float(v) / 127.0 for k, v in r.items()}
            for sub, r in rec.items()}


def merge_act_scales(qparams: Dict, scales: Dict) -> Dict:
    """Attach calibrated activation scales to a `quantize_tree` output,
    in place, each clamped at >= 1e-12 (so a conv input that was all
    zero in the calibration batch cannot divide by 0)."""
    for sub, d in scales.items():
        for name, s in d.items():
            q = qparams[sub]
            if f"{name}.weight_scale" in q:       # quantized layers only
                dev = q[f"{name}.weight_scale"].device
                q[f"{name}.act_scale"] = torch.tensor(
                    max(float(s), SCALE_FLOOR), dtype=torch.float32,
                    device=dev)
    return qparams
