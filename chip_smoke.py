#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`cgs_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA card
(written for an H100, `sm_90a`) and `nvcc`. It builds the CUDA kernels
from `cgs_tpu_torch/csrc/`, then:

  kernels  holds each kernel against its plain PyTorch version on the
           card at the shapes the serving path gives it (bit-equal /
           exactly equal), and times kernel, plain version, a PyTorch
           yardstick where one exists, and the least time the card
           could take (bytes / 3.35 TB/s, or operations / peak);
  serve    runs `MaskPipeline` at chfak 5 (the published width), batch
           8192, on device-resident frames, in f32 (TF32 off) and
           bf16: kernel path against plain path, 1 `normalize_u8` and 6
           `upsample2x` launches per batch, frames/s;
  eval     (main path) a `Handler` built from `-eval -salience
           -synthetic_data --chfak 5`: `evaluate(..., write=False)` on
           the 2450-frame synthetic set; the kernel IoU must equal a
           host numpy IoU of the same masks;
  process  (main path) `_mask_variants` with the u8 wire and the
           device-side binarisation against the f32 wire thresholded
           on the host.

Launch counts are set to 0 just before the main path (eval + process)
and read just after it; every kernel must have launched there.
Weights are random, from a seed. Any failed check exits non-zero.
Without CUDA, or without the rest of the checkout, it fails and prints
no result. The next-to-last lines are a JSON `kernels` summary and the
card's name and power limit from nvidia-smi; the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
F32_OPS_PER_S = 67e12           # f32 outside the tensor cores
CHFAK5_STEPS = [(1, 1, 160), (2, 2, 160), (4, 4, 80), (8, 8, 40),
                (16, 16, 40), (32, 32, 40)]
CHFAK1_STEPS = [(1, 1, 32), (2, 2, 32), (4, 4, 16), (8, 8, 8),
                (16, 16, 8), (32, 32, 8)]
BATCH = 8192
EVAL_N, FRAME_F, MASK_F = 2450, 64 * 64 * 3, 64 * 64


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def bound_ms(nbytes: float, ops: float = 0.0):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a "
              "card", file=sys.stderr)
        return 2
    if not (ROOT / "cgs_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: run from the root of a cgs-tpu checkout "
              "(cgs_tpu_torch/ not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t_start = time.time()

    from cgs_tpu_torch.core.device import disable_tf32
    from cgs_tpu_torch.ops import _build

    # -- set-up -----------------------------------------------------------
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])
    t0 = time.time()
    _build.build_kernels(verbose=True)
    log(f"[setup] kernels built in {time.time() - t0:.1f} s")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log("[setup] tf32:", disable_tf32())

    summary = {}
    phase_kernels(_build, summary)
    phase_serve(_build)

    _build.launches.clear()                 # main path starts here
    phase_eval(_build)
    phase_process()
    main_launches = dict(_build.launches)   # main path ends here
    log("[main path] launches:", main_launches)
    for name in _build.SIGNATURES:
        check(main_launches.get(name, 0) > 0,
              f"{name} never launched on the main path")
        summary[name]["launches"] = main_launches[name]

    log(f"[done] {time.time() - t_start:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(json.dumps({"kernels": list(summary.values())}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _bits(t):
    """The raw bits, so equality is bit-equality."""
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


def phase_kernels(_build, summary) -> None:
    import torch.nn.functional as F

    from cgs_tpu_torch.ops.kernels import (
        INV255, normalize_u8, normalize_u8_plain, threshold_iou,
        threshold_iou_plain,
    )
    from cgs_tpu_torch.ops.upsample import upsample2x, upsample2x_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.time()

    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=dev, generator=gen)

    # normalize_u8: bit-equal at the batch, a ragged N, odd numel, N=0
    err = 0.0
    for shape in [(BATCH, FRAME_F), (1001, FRAME_F), (3, 4097),
                  (0, FRAME_F)]:
        x = u8(shape)
        got, want = normalize_u8(x), normalize_u8_plain(x)
        check(got.shape == want.shape and torch.equal(_bits(got),
                                                      _bits(want)),
              f"normalize_u8 differs from plain at {shape}")
        if got.numel():
            err = max(err, float((got - want).abs().max()))
    x = u8((BATCH, FRAME_F))
    nb = BATCH * FRAME_F
    b_ms, b_by = bound_ms(5 * nb, nb)
    summary["normalize_u8"] = {
        "name": "normalize_u8", "route": "cuda",
        "source": "cgs_tpu_torch/csrc/normalize_u8.cu",
        "replaces": "cgs_tpu/ops/pallas_kernels.py:71",
        "launches": 0, "max_abs_err": err,
        "ms": time_ms(lambda: normalize_u8(x)),
        "plain_ms": time_ms(lambda: normalize_u8_plain(x)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(
            lambda: x.to(torch.float32).mul_(INV255)),
        "shape": f"uint8 ({BATCH}, {FRAME_F})"}
    del x

    # upsample2x: bit-equal at all 12 decoder steps x 2 dtypes
    err = 0.0
    steps_ms = []
    for width, steps in (("chfak5", CHFAK5_STEPS), ("chfak1", CHFAK1_STEPS)):
        for h, w, c in steps:
            for dt in (torch.float32, torch.bfloat16):
                xin = torch.rand((BATCH, h, w, c), device=dev,
                                 generator=gen).to(dt)
                got, want = upsample2x(xin), upsample2x_plain(xin)
                check(torch.equal(_bits(got), _bits(want)),
                      f"upsample2x differs from plain at "
                      f"{(BATCH, h, w, c)} {dt}")
                err = max(err, float((got.float() - want.float())
                                     .abs().max()))
                del got, want
                if dt == torch.float32 and width == "chfak5":
                    nchw = xin.permute(0, 3, 1, 2)
                    steps_ms.append({
                        "shape": [BATCH, h, w, c],
                        "ms": time_ms(lambda: upsample2x(xin)),
                        "plain_ms": time_ms(
                            lambda: upsample2x_plain(xin)),
                        "library_ms": time_ms(lambda: F.interpolate(
                            nchw, scale_factor=2, mode="nearest")),
                        "bound_ms": bound_ms(5 * xin.numel() * 4)[0]})
                del xin
    # ragged shapes no TPU run used: odd C and W, an unaligned pixel
    for shape in [(3, 5, 7, 3), (2, 3, 9, 5)]:
        for dt in (torch.float32, torch.bfloat16):
            xin = torch.rand(shape, device=dev, generator=gen).to(dt)
            check(torch.equal(_bits(upsample2x(xin)),
                              _bits(upsample2x_plain(xin))),
                  f"upsample2x differs from plain at {shape} {dt}")
    torch.cuda.empty_cache()
    log("[kernels] upsample2x chfak-5 f32 steps:", json.dumps(steps_ms))
    summary["upsample2x"] = {
        "name": "upsample2x", "route": "cuda",
        "source": "cgs_tpu_torch/csrc/upsample2x.cu",
        "replaces": "cgs_tpu/ops/pallas_upsample.py:87",
        "launches": 0, "max_abs_err": err,
        "ms": sum(s["ms"] for s in steps_ms),
        "plain_ms": sum(s["plain_ms"] for s in steps_ms),
        "bound_ms": sum(s["bound_ms"] for s in steps_ms),
        "bound_by": "bytes",
        "library_ms": sum(s["library_ms"] for s in steps_ms),
        "shape": f"the 6 chfak-5 decoder steps, f32, batch {BATCH} (sum)"}

    # threshold_iou: exact counts at the eval set, ragged N, odd numel, 0
    err = 0.0
    for shape in [(EVAL_N, MASK_F), (1001, MASK_F), (3, 4095),
                  (0, MASK_F)]:
        m = torch.rand(shape, device=dev, generator=gen)
        g = torch.rand(shape, device=dev, generator=gen) > 0.7
        got = [int(v) for v in threshold_iou(m, g, 0.05)]
        want = [int(v) for v in threshold_iou_plain(m, g, 0.05)]
        check(got == want, f"threshold_iou {got} != plain {want} at "
                           f"{shape}")
        err = max(err, float(max((abs(a - b) for a, b in zip(got, want)),
                                 default=0)))
    m = torch.rand((EVAL_N, MASK_F), device=dev, generator=gen)
    g = (torch.rand((EVAL_N, MASK_F), device=dev, generator=gen) > 0.7)
    ne = EVAL_N * MASK_F
    b_ms, b_by = bound_ms(5 * ne + 16, ne)
    summary["threshold_iou"] = {
        "name": "threshold_iou", "route": "cuda",
        "source": "cgs_tpu_torch/csrc/threshold_iou.cu",
        "replaces": "cgs_tpu/ops/pallas_kernels.py:221",
        "launches": 0, "max_abs_err": err,
        "ms": time_ms(lambda: threshold_iou(m, g, 0.05), iters=50),
        "plain_ms": time_ms(
            lambda: threshold_iou_plain(m, g, 0.05), iters=50),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"f32 + bool ({EVAL_N}, {MASK_F})"}
    del m, g
    torch.cuda.empty_cache()
    log(f"[kernels] ok in {time.time() - t0:.1f} s")


CATEGORIES = (   # first match wins, on the lower-cased kernel name
    ("port kernels", ("normalize_u8", "upsample2x", "threshold_iou")),
    ("concat", ("catarray", "cat_")),
    ("max-pool", ("max_pool",)),
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "sm90", "wgrad",
                     "dgrad", "fprop", "nchw", "nhwc")),
    ("elementwise", ("elementwise", "reduce", "copy", "fill")),
)


def device_breakdown(step, reps: int = 2) -> dict:
    """Device time of `reps` steps by kernel category, from
    torch.profiler, with the top kernels and the device's idle share of
    the host-timed window (profiler on, so an upper bound)."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_us = (time.time() - t0) * 1e6
    kern = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        kern[e.key] = kern.get(e.key, 0.0) + us
    busy = sum(kern.values())
    cats = {}
    for k, us in kern.items():
        low = k.lower()
        cat = next((c for c, keys in CATEGORIES
                    if any(s in low for s in keys)), "other")
        cats[cat] = cats.get(cat, 0.0) + us
    top = sorted(kern.items(), key=lambda kv: -kv[1])[:8]
    return {"ms_per_step": busy / reps / 1e3,
            "idle_share": max(0.0, 1.0 - busy / wall_us),
            "by_category_ms": {c: us / reps / 1e3 for c, us in
                               sorted(cats.items(), key=lambda kv: -kv[1])},
            "top_kernels_ms": [[k[:90], us / reps / 1e3] for k, us in top]}


def _random_params(critic, masker, seed: int):
    from cgs_tpu_torch.models.interop import init_torch_default
    gen = torch.Generator().manual_seed(seed)
    return {name: {k: v.clone() for k, v in
                   init_torch_default(mod, gen).state_dict().items()}
            for name, mod in (("critic", critic), ("masker", masker))}


def phase_serve(_build) -> None:
    from unittest import mock

    import cgs_tpu_torch.models.decoder as decoder_mod
    import cgs_tpu_torch.pipeline as pipeline_mod
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.ops.kernels import normalize_u8_plain
    from cgs_tpu_torch.ops.upsample import upsample2x_plain
    from cgs_tpu_torch.pipeline import MaskPipeline

    dev = torch.device("cuda")
    frames = torch.randint(0, 256, (BATCH, 64, 64, 3), dtype=torch.uint8,
                           device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(1))
    for dtype in (torch.float32, torch.bfloat16):
        t0 = time.time()
        critic = Critic(chfak=5, dropout=0.5, compute_dtype=dtype)
        masker = UnetDecoder(chfak=5, compute_dtype=dtype)
        params = _random_params(critic, masker, seed=0)
        pipe = MaskPipeline(critic, masker, params, batch_size=BATCH,
                            device="cuda")
        _build.launches.clear()
        pred, mask, _ = pipe.run_device(frames)
        torch.cuda.synchronize()
        per_batch = dict(_build.launches)
        check(per_batch == {"normalize_u8": 1, "upsample2x": 6},
              f"launches per batch {per_batch}, want 1 normalize_u8 "
              "and 6 upsample2x")
        check(mask.shape == (BATCH, 64, 64, 1) and pred.shape == (BATCH,),
              f"output shapes {tuple(mask.shape)} {tuple(pred.shape)}")
        check(bool(torch.isfinite(mask).all()) and
              bool(((mask > 0) & (mask < 1)).all()),
              "masks not finite or outside (0, 1)")
        # the same weights through the plain versions on the card
        with mock.patch.object(pipeline_mod, "normalize_u8",
                               normalize_u8_plain), \
                mock.patch.object(decoder_mod, "upsample2x",
                                  upsample2x_plain):
            ppred, pmask, _ = pipe.run_device(frames)
        torch.cuda.synchronize()
        if torch.equal(mask, pmask) and torch.equal(pred, ppred):
            how = "bit-identical"
        else:
            d = float((mask - pmask).abs().max())
            log(f"[serve] kernel and plain masks differ by {d:.3g}: "
                "cuDNN may pick another algorithm for another buffer; "
                "allowing atol=1e-5")
            check(d <= 1e-5, f"kernel path differs from plain by {d}")
            how = f"max |diff| {d:.3g}"
        del ppred, pmask
        reps = 10
        torch.cuda.synchronize()
        t1 = time.time()
        for _ in range(reps):
            out = pipe.run_device(frames)
        torch.cuda.synchronize()
        dt = time.time() - t1
        del out, pred, mask
        name = "f32" if dtype == torch.float32 else "bf16"
        log(f"[serve] chfak 5 {name} batch {BATCH}: kernel vs plain "
            f"{how}; launches/batch {per_batch}")
        log(f"[serve] frames/s chfak5 {name} batch {BATCH} "
            f"device-resident: {reps * BATCH / dt:.0f} "
            f"({dt / reps * 1e3:.2f} ms/batch)")
        log(f"[serve] device time chfak5 {name}:",
            json.dumps(device_breakdown(lambda: pipe.run_device(frames))))
        log(f"[serve] phase {name} {time.time() - t0:.1f} s")
        del pipe
        torch.cuda.empty_cache()


def phase_eval(_build) -> None:
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.eval.harness import evaluate, load_eval_set
    from cgs_tpu_torch.handler import Handler
    from cgs_tpu_torch.ops.iou import iou

    t0 = time.time()
    cfg = parse_args(["-eval", "-salience", "-synthetic_data",
                      "--chfak", "5", "--model", "chip-smoke"])
    handler = Handler(cfg)
    check(handler.device.type == "cuda", f"handler on {handler.device}")
    x, gt = load_eval_set(cfg)
    check(x.shape == (EVAL_N, 64, 64, 3), f"eval set {x.shape}")
    pipe = handler._pipeline(salience=cfg.salience)
    before = _build.launches["threshold_iou"]
    t1 = time.time()
    result = evaluate(cfg, pipe, x, gt, write=False)
    torch.cuda.synchronize()
    wall = time.time() - t1
    check(_build.launches["threshold_iou"] > before,
          "threshold_iou did not launch in evaluate")
    ious = result["ious"]
    host = iou(result["variants"]["hard"], gt)
    check(ious[0] == host, f"kernel IoU {ious[0]} != host IoU {host}")
    check(len(ious) == 2 and all(0.0 <= v <= 1.0 for v in ious),
          f"ious {ious}")
    check(bool(np.isfinite(result["preds"]).all()), "preds not finite")
    log(f"[eval] chfak 5 f32, {EVAL_N} frames: IoU {ious} (host numpy "
        f"IoU {host}); evaluate wall {wall:.3f} s; phase "
        f"{time.time() - t0:.1f} s")


def phase_process() -> None:
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.eval.segment import _mask_variants
    from cgs_tpu_torch.handler import Handler

    t0 = time.time()
    cfg = parse_args(["-process", "--chfak", "5", "--model", "chip-smoke",
                      "--seed", "1"])
    handler = Handler(cfg)
    xu8, _ = synthetic_eval_set(n_frames=384, seed=7)
    x = xu8 / 255.0
    thr = cfg.binarymaskthreshold
    red = handler._pipeline(salience=False, wire="u8", hard_threshold=thr)
    full = handler._pipeline(salience=False)
    t1 = time.time()
    _, m_u8, png_u8 = _mask_variants(cfg, red, x)
    wall = time.time() - t1
    _, m_f32, png_f32 = _mask_variants(cfg, full, x)
    check(len(png_u8) == len(png_f32) == 2, "expected raw + hard planes")
    soft = m_f32[0]
    np.testing.assert_array_equal(
        png_u8[0], (255 * np.clip(soft, 0, 1)).astype(np.uint8))
    np.testing.assert_array_equal(m_u8[1], (soft >= thr).astype(np.float32))
    for a, b in zip(png_u8, png_f32):
        np.testing.assert_array_equal(a, b)
    log(f"[process] chfak 5, 384 frames: u8 wire and device hard plane "
        f"equal the host-thresholded f32 wire; _mask_variants wall "
        f"{wall:.3f} s; hard fraction {float(m_u8[1].mean()):.4f}; phase "
        f"{time.time() - t0:.1f} s")


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
