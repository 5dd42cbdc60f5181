#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`cgs_tpu_torch`) on one CUDA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --train-seeds 0,1,2   # the protocol per seed

Run from the root of a checkout on a machine with an NVIDIA card
(written for an H100, `sm_90a`) and `nvcc`. It builds the CUDA kernels
from `cgs_tpu_torch/csrc/`, then:

  kernels  holds each kernel against its plain PyTorch version on the
           card at the shapes the serving and training paths give it
           (bit-equal / exactly equal), and times kernel, plain
           version, a PyTorch yardstick where one exists, and the
           least time the card could take (bytes / 3.35 TB/s, or
           operations / peak); the merges and the upsample gradient at
           the masker step's shapes and at batch 8192;
  serve    runs `MaskPipeline` at chfak 5 (the published width), batch
           8192, on device-resident frames, in f32 (TF32 off) and
           bf16: kernel path against plain path, 1 `normalize_u8` and 6
           `upsample2x` launches per batch, frames/s;
  step     one chfak-5 masker step (default flags, f32, TF32 off,
           deterministic cuDNN): loss terms and every gradient of the
           kernel path bit-equal to the plain path, every decoder gradient
           non-zero, the launches per step and the gradient layouts
           the kernels were handed;
  speed    critic and masker train steps/s at chfak 5, f32 and bf16,
           and the device time of one masker step by category;
  eval     (serving main path) a `Handler` built from `-eval -salience
           -synthetic_data --chfak 5`: `evaluate(..., write=False)` on
           the 2450-frame synthetic set; the kernel IoU must equal a
           host numpy IoU of the same masks;
  process  (serving main path) `_mask_variants` with the u8 wire and
           the device-side binarisation against the f32 wire
           thresholded on the host;
  train    (training main path) `cli.main(["-train", "-eval",
           "-synthetic_data", "--chfak", "5", "--dropout", "0.5",
           ...])`: the paper's synthetic protocol (20k frames, critic 10
           / masker 12 epochs) with `-frozen` (the CLI's `-train` makes
           cuDNN deterministic), in a temporary directory, writing no
           files; the eval IoU must reach 0.70.

Launch counts are set to 0 just before each main path (eval + process;
train) and read just after it; every kernel of a path must have
launched there. Weights are random, from a seed. Any failed check exits
non-zero. Without CUDA, or without the rest of the checkout, it fails
and prints no result. The next-to-last lines are a JSON `kernels`
summary and the card's name and power limit from nvidia-smi; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys
import tempfile
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
MASKER_N = 64        # frames a masker step merges and decodes (2K)
PIX = 64 * 64
SERVE_KERNELS = ("normalize_u8", "upsample2x", "threshold_iou")
TRAIN_KERNELS = ("normalize_u8", "merge_pair", "merge_pair_bwd",
                 "upsample2x", "upsample2x_bwd", "threshold_iou")
STEP_LAUNCHES = {"normalize_u8": 2, "merge_pair": 1, "merge_pair_bwd": 1,
                 "upsample2x": 6, "upsample2x_bwd": 6}
PROTOCOL = ["-train", "-eval", "-synthetic_data", "--chfak", "5",
            "--dropout", "0.5", "--datasize", "20000", "--cepochs", "10",
            "--mepochs", "12", "-frozen", "--model", "chip-smoke-train"]
MIN_IOU = 0.70


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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-seeds", default="0",
                    help="comma-separated seeds of the train protocol")
    args = ap.parse_args(argv)
    seeds = [int(s) for s in args.train_seeds.split(",")]
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
    phase_train_kernels(summary)
    phase_serve(_build)
    phase_train_step(_build)
    phase_train_speed()

    _build.launches.clear()                 # serving main path starts
    phase_eval(_build)
    phase_process()
    serve_launches = dict(_build.launches)  # serving main path ends
    log("[main path: serve] launches:", serve_launches)
    for name in SERVE_KERNELS:
        check(serve_launches.get(name, 0) > 0,
              f"{name} never launched on the serving main path")

    train_launches = {}
    for seed in seeds:
        _build.launches.clear()             # training main path starts
        phase_train(seed)
        for name, n in _build.launches.items():   # ... and ends
            train_launches[name] = train_launches.get(name, 0) + n
    log("[main path: train] launches:", train_launches)
    for name in TRAIN_KERNELS:
        check(train_launches.get(name, 0) > 0,
              f"{name} never launched on the training main path")
    for name in _build.KERNELS:
        summary[name]["launches"] = (serve_launches.get(name, 0)
                                     + train_launches.get(name, 0))
        check(summary[name]["launches"] > 0,
              f"{name} never launched on a main path")

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
    ("port kernels", ("normalize_u8", "upsample2x", "threshold_iou",
                      "merge_pair")),
    ("concat", ("catarray", "cat_")),
    ("max-pool", ("max_pool",)),
    ("convolution", ("conv", "cudnn", "xmma", "gemm", "sm90", "wgrad",
                     "dgrad", "fprop", "nchw", "nhwc")),
    ("elementwise", ("elementwise", "reduce", "copy", "fill")),
)


def device_breakdown(step, reps: int = 2) -> dict:
    """Device time of `reps` steps by kernel category, from
    torch.profiler, with the top kernels, the device operations
    (kernels, copies, fills) per step, and the device's idle share of
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
    n_kernels = 0
    for e in prof.key_averages():
        # a user annotation (the optimizer's `Optimizer.step#...` span)
        # also shows on the device timeline; its kernels count already
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or getattr(e, "is_user_annotation", False)):
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        kern[e.key] = kern.get(e.key, 0.0) + us
        n_kernels += e.count
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
            "device_ops_per_step": n_kernels / reps,
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


def _layout(t) -> str:
    if t.is_contiguous():
        return "nchw-dense" if t.dim() == 4 else "contiguous"
    if t.dim() == 4 and t.is_contiguous(memory_format=torch.channels_last):
        return "channels_last-dense"
    return f"strided {tuple(t.stride())}"


def phase_train_kernels(summary) -> None:
    """The training slice's kernels: merge_pair, merge_pair_bwd and the
    upsample backward, bit-equal to their plain versions, and timed at
    the masker step's shapes (the summary rows) and at batch 8192."""
    import torch.nn.functional as F

    from cgs_tpu_torch.ops.kernels import (
        merge_pair, merge_pair_bwd, merge_pair_bwd_plain, merge_pair_plain,
    )
    from cgs_tpu_torch.ops.upsample import (
        upsample2x_bwd, upsample2x_bwd_plain,
    )

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    t0 = time.time()

    def frames(n, h=64, w=64, c=3):      # NCHW stored channels_last
        return torch.rand((n, h, w, c), device=dev,
                          generator=gen).permute(0, 3, 1, 2)

    errs = {"merge_pair": 0.0, "merge_pair_bwd": 0.0,
            "upsample2x_bwd": 0.0}

    def same(got, want, what):
        name = what.split()[0]
        for g, w in zip(got, want):
            check(g.shape == w.shape and torch.equal(_bits(g), _bits(w)),
                  f"{what} differs from plain")
            if g.numel():
                errs[name] = max(errs[name], float(
                    (g.float() - w.float()).abs().max()))

    # merges: the masker step, batch 8192, a ragged shape, N = 0; the
    # gradients in both memory formats cuDNN's dgrad may hand over
    for n, h, w in [(MASKER_N, 64, 64), (BATCH, 64, 64), (7, 5, 9),
                    (0, 64, 64)]:
        a, b, z = frames(n, h, w), frames(n, h, w), frames(n, h, w, 1)
        same(merge_pair(a, b, z), merge_pair_plain(a, b, z),
             f"merge_pair at {(n, h, w)}")
        gr, gi = frames(n, h, w), frames(n, h, w)
        for fmt in (torch.channels_last, torch.contiguous_format):
            g_r = gr.contiguous(memory_format=fmt)
            g_i = gi.contiguous(memory_format=fmt)
            same(merge_pair_bwd(a, b, z, g_r, g_i),
                 merge_pair_bwd_plain(a, b, z, g_r, g_i),
                 f"merge_pair_bwd at {(n, h, w)} {fmt}")
        del a, b, z, gr, gi
    torch.cuda.empty_cache()

    rows = {}
    for n in (MASKER_N, BATCH):
        a, b, z = frames(n), frames(n), frames(n, 64, 64, 1)
        gr, gi = frames(n), frames(n)
        gr_nchw, gi_nchw = gr.contiguous(), gi.contiguous()
        px = n * PIX
        rows[n] = {
            "merge_pair": {
                "ms": time_ms(lambda: merge_pair(a, b, z), iters=50),
                "plain_ms": time_ms(lambda: merge_pair_plain(a, b, z),
                                    iters=50),
                "bound": bound_ms(52 * px, 19 * px)},
            "merge_pair_bwd": {
                "ms": time_ms(lambda: merge_pair_bwd(a, b, z, gr, gi),
                              iters=50),
                "ms_nchw_grads": time_ms(lambda: merge_pair_bwd(
                    a, b, z, gr_nchw, gi_nchw), iters=50),
                "plain_ms": time_ms(lambda: merge_pair_bwd_plain(
                    a, b, z, gr, gi), iters=50),
                "bound": bound_ms(80 * px, 31 * px)}}
        del a, b, z, gr, gi, gr_nchw, gi_nchw
        torch.cuda.empty_cache()
    log("[kernels] merges (ms; N = 64 is the masker step):",
        json.dumps(rows))
    for name, src_line in (("merge_pair", 110), ("merge_pair_bwd", 151)):
        r = rows[MASKER_N][name]
        summary[name] = {
            "name": name, "route": "cuda",
            "source": "cgs_tpu_torch/csrc/merge_pair.cu",
            "replaces": f"cgs_tpu/ops/pallas_kernels.py:{src_line}",
            "launches": 0, "max_abs_err": errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None,
            "shape": f"f32 ({MASKER_N}, 3, 64, 64) channels_last + mask "
                     f"({MASKER_N}, 1, 64, 64)"}

    # upsample backward: the six chfak-5 decoder steps at batch 128 in
    # f32 and bf16, a ragged shape, N = 0, and the channel slices of a
    # concat's gradient (what autograd hands over) in both layouts
    for h, w, c in CHFAK5_STEPS:
        for dt in (torch.float32, torch.bfloat16):
            g = torch.rand((128, 2 * h, 2 * w, c), device=dev,
                           generator=gen).to(dt)
            same([upsample2x_bwd(g)], [upsample2x_bwd_plain(g)],
                 f"upsample2x_bwd at {(128, h, w, c)} {dt}")
    for shape in [(3, 10, 18, 5), (0, 4, 4, 8)]:
        g = torch.rand(shape, device=dev, generator=gen)
        same([upsample2x_bwd(g)], [upsample2x_bwd_plain(g)],
             f"upsample2x_bwd at {shape}")
    for dt in (torch.float32, torch.bfloat16):
        wide = torch.rand((128, 64, 64, 43), device=dev,
                          generator=gen).to(dt)          # cat([x, up])
        wide_nchw = wide.permute(0, 3, 1, 2).contiguous().permute(
            0, 2, 3, 1)
        for g in (wide[..., 3:], wide_nchw[..., 3:]):
            check(not g.is_contiguous(), "slice should be a strided view")
            same([upsample2x_bwd(g)], [upsample2x_bwd_plain(g)],
                 f"upsample2x_bwd of a channel slice {g.stride()} {dt}")
    del g, wide, wide_nchw
    torch.cuda.empty_cache()

    steps = {}
    for n in (MASKER_N, BATCH):
        steps[n] = []
        for h, w, c in CHFAK5_STEPS:
            g = torch.rand((n, 2 * h, 2 * w, c), device=dev, generator=gen)
            g_nchw = g.permute(0, 3, 1, 2)
            steps[n].append({
                "shape": [n, h, w, c],
                "ms": time_ms(lambda: upsample2x_bwd(g), iters=50),
                "plain_ms": time_ms(lambda: upsample2x_bwd_plain(g),
                                    iters=50),
                "library_ms": time_ms(lambda: F.avg_pool2d(
                    g_nchw, 2, divisor_override=1), iters=50),
                # f32: reads 4 B and writes 1 B per gradient element
                "bound_ms": bound_ms(5 * g.numel(),
                                     3 * g.numel() // 4)[0]})
            del g, g_nchw
        torch.cuda.empty_cache()
    log("[kernels] upsample2x_bwd chfak-5 f32 steps (ms):",
        json.dumps(steps))
    st = steps[MASKER_N]
    summary["upsample2x_bwd"] = {
        "name": "upsample2x_bwd", "route": "cuda",
        "source": "cgs_tpu_torch/csrc/upsample2x.cu",
        "replaces": "cgs_tpu/ops/pallas_upsample.py:132",
        "launches": 0, "max_abs_err": errs["upsample2x_bwd"],
        "ms": sum(s["ms"] for s in st),
        "plain_ms": sum(s["plain_ms"] for s in st),
        "bound_ms": sum(s["bound_ms"] for s in st), "bound_by": "bytes",
        "library_ms": sum(s["library_ms"] for s in st),
        "shape": f"the 6 chfak-5 decoder steps, f32, batch {MASKER_N} "
                 "(sum)"}
    log(f"[kernels] training kernels ok in {time.time() - t0:.1f} s")


def _train_models(dtype, seed: int):
    """Train-mode chfak-5 critic and masker on the card, random
    weights."""
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    critic = Critic(chfak=5, dropout=0.5, compute_dtype=dtype)
    masker = UnetDecoder(chfak=5, compute_dtype=dtype)
    params = _random_params(critic, masker, seed)
    out = {}
    for name, template in (("critic", critic), ("masker", masker)):
        m = copy.deepcopy(template).to("cuda",
                                       memory_format=torch.channels_last)
        m.load_state_dict(params[name])
        out[name] = m.train()
    return out


def phase_train_step(_build) -> None:
    """One chfak-5 masker step with default flags, kernel path against
    plain path: loss terms and every gradient bit-equal, every decoder
    gradient non-zero, launches per step as expected."""
    from unittest import mock

    import cgs_tpu_torch.ops.merge as merge_mod
    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.train.losses as losses_mod
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.ops.augment import shift_batch
    from cgs_tpu_torch.ops.kernels import (
        merge_pair_bwd_plain, merge_pair_plain, normalize_u8_plain,
    )
    from cgs_tpu_torch.train.steps import StepRng

    t0 = time.time()
    dev = torch.device("cuda")
    cfg = parse_args(["-train", "--chfak", "5", "--dropout", "0.5"])
    check(cfg.live and cfg.inject, "default flags are live + inject")
    models = _train_models(torch.float32, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    a_u8, b_u8 = (torch.randint(0, 256, (MASKER_N, 64, 64, 3),
                                dtype=torch.uint8, device=dev, generator=g)
                  for _ in range(2))
    y = torch.rand(MASKER_N, device=dev, generator=g)
    terms = ("loss", "replace", "inject", "norm", "critic")

    def run():
        rng = StepRng.seeded(0, dev)          # the same draws each run
        for m in models.values():
            m.zero_grad(set_to_none=True)
        a = shift_batch(a_u8, cfg.shift, rng.shift)
        loss, aux = losses_mod.build_masker_loss(cfg)(
            models, losses_mod.ingest(a), y, losses_mod.ingest(b_u8),
            rng.dropout)
        loss.backward()
        torch.cuda.synchronize()
        return ({t: float(aux[t].detach()) for t in terms},
                {f"{n}.{k}": p.grad.detach().clone()
                 for n, m in models.items()
                 for k, p in m.named_parameters()})

    layouts = {}
    real_mbwd, real_ubwd = merge_mod.merge_pair_bwd, upsample_mod.upsample2x_bwd

    def spy_mbwd(a, b, z, gr, gi):
        layouts["merge_pair_bwd (gr, gi)"] = [_layout(gr), _layout(gi)]
        return real_mbwd(a, b, z, gr, gi)

    def spy_ubwd(gg):
        layouts.setdefault("upsample2x_bwd", []).append(
            [list(gg.shape), list(gg.stride())])
        return real_ubwd(gg)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _build.launches.clear()
        with mock.patch.object(merge_mod, "merge_pair_bwd", spy_mbwd), \
                mock.patch.object(upsample_mod, "upsample2x_bwd", spy_ubwd):
            k_terms, k_grads = run()
        per_step = dict(_build.launches)
        with mock.patch.object(losses_mod, "normalize_u8",
                               normalize_u8_plain), \
                mock.patch.object(merge_mod, "merge_pair",
                                  merge_pair_plain), \
                mock.patch.object(merge_mod, "merge_pair_bwd",
                                  merge_pair_bwd_plain), \
                mock.patch.object(upsample_mod, "upsample2x_fwd",
                                  upsample_mod.upsample2x_plain), \
                mock.patch.object(upsample_mod, "upsample2x_bwd",
                                  upsample_mod.upsample2x_bwd_plain):
            _build.launches.clear()
            p_terms, p_grads = run()
            check(sum(_build.launches.values()) == 0,
                  f"plain path launched {dict(_build.launches)}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log("[step] launches per masker step:", per_step)
    check(per_step == STEP_LAUNCHES,
          f"launches per masker step {per_step}, want {STEP_LAUNCHES}")
    log("[step] gradient layouts the kernels were handed:",
        json.dumps(layouts))
    d_terms = max(abs(k_terms[t] - p_terms[t]) for t in terms)
    d_grads = max(float((k_grads[k] - p_grads[k]).abs().max())
                  for k in k_grads)
    check(all(np.isfinite(v) for v in k_terms.values()),
          f"loss terms not finite: {k_terms}")
    # the kernels are bit-equal to their plain versions and cuDNN is
    # deterministic, so the two paths agree in every bit
    check(k_terms == p_terms and all(
        torch.equal(_bits(k_grads[k]), _bits(p_grads[k])) for k in k_grads),
        f"kernel path vs plain path: terms {d_terms}, grads {d_grads}")
    zero = [k for k, v in k_grads.items()
            if k.startswith("masker.") and not bool(v.abs().sum() > 0)]
    check(not zero, f"decoder gradients all zero: {zero}")
    log(f"[step] chfak 5 f32 masker step: terms {k_terms}; kernel vs plain "
        f"max |diff| terms {d_terms:.3g} grads {d_grads:.3g}; all "
        f"{sum(k.startswith('masker.') for k in k_grads)} decoder "
        f"gradients non-zero; phase {time.time() - t0:.1f} s")


def phase_train_speed() -> None:
    """Critic (batch 64) and masker (2K = 64) train steps/s at chfak 5,
    f32 (TF32 off) and bf16, on random uint8 banks on the card, and the
    device time of one masker step."""
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.train.contrastive import sample_index_stacks
    from cgs_tpu_torch.train.loops import critic_chunk, masker_chunk
    from cgs_tpu_torch.train.steps import (
        StepRng, make_optimizer, masker_step,
    )

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    bank = torch.randint(0, 256, (4096, 64, 64, 3), dtype=torch.uint8,
                         device=dev, generator=g)
    ybank = torch.rand(4096, device=dev, generator=g)
    cfg = parse_args(["-train", "--chfak", "5", "--dropout", "0.5"])
    nrng = np.random.default_rng(0)
    for dtype in (torch.float32, torch.bfloat16):
        name = "f32" if dtype == torch.float32 else "bf16"
        t0 = time.time()
        rng = StepRng.seeded(0, dev)
        models = _train_models(dtype, seed=6)
        opt = make_optimizer({"critic": models["critic"]})
        idx = nrng.integers(0, 4096, (205, 64))
        critic_chunk(cfg, models["critic"], opt, bank, ybank, idx[:5], rng)
        torch.cuda.synchronize()
        t1 = time.time()
        losses = critic_chunk(cfg, models["critic"], opt, bank, ybank,
                              idx[5:], rng).cpu().numpy()
        c_sps = 200 / (time.time() - t1)
        check(bool(np.isfinite(losses).all()), "critic losses not finite")

        models = _train_models(dtype, seed=6)
        opt = make_optimizer(models)
        xpos, ypos = bank[:2048], ybank[:2048]
        xneg, yneg = bank[2048:], ybank[2048:]
        h, l, c = sample_index_stacks(nrng, 2048, 2048, 55, 32)
        masker_chunk(cfg, models, opt, xpos, ypos, xneg, yneg, h[:5],
                     l[:5], c[:5], rng)
        torch.cuda.synchronize()
        t1 = time.time()
        losses = masker_chunk(cfg, models, opt, xpos, ypos, xneg, yneg,
                              h[5:], l[5:], c[5:], rng).cpu().numpy()
        m_sps = 50 / (time.time() - t1)
        check(bool(np.isfinite(losses).all()), "masker losses not finite")
        a_u8 = torch.cat([xpos[:32], xneg[:32]])
        log(f"[speed] chfak 5 {name}: critic {c_sps:.1f} steps/s (batch "
            f"64), masker {m_sps:.1f} steps/s (2K = 64)")
        log(f"[speed] device time of one masker step, chfak5 {name}:",
            json.dumps(device_breakdown(lambda: masker_step(
                cfg, models, opt, a_u8, ypos[:64], xneg[:64], rng))))
        log(f"[speed] phase {name} {time.time() - t0:.1f} s")
        del models, opt
        torch.cuda.empty_cache()


def phase_train(seed: int) -> None:
    """The paper's synthetic protocol through the CLI, -frozen, at
    chfak 5, writing no files."""
    from cgs_tpu_torch import cli

    t0 = time.time()
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            handler = cli.main(PROTOCOL + ["--seed", str(seed)],
                               primary=False)
        finally:
            os.chdir(old)
    check(handler.device.type == "cuda", f"handler on {handler.device}")
    check(torch.backends.cudnn.deterministic,
          "the CLI's -train did not make cuDNN deterministic")
    closs = handler.loss_log["critic"]
    mloss = handler.loss_log["masker"]
    check(closs.shape == (10 * 313,) and bool(np.isfinite(closs).all()),
          f"critic losses {closs.shape}")
    check(mloss.ndim == 2 and mloss.shape[0] > 0
          and bool(np.isfinite(mloss).all()), f"masker losses {mloss.shape}")
    sets = handler.contrastive
    iou = handler.last_ious[0]
    log(f"[train] seed {seed}: chfak 5 -frozen, 20k frames, critic 10 / "
        f"masker 12 epochs: {closs.shape[0]} critic and {mloss.shape[0]} "
        f"masker steps; contrastive {sets.n_pos} pos / {sets.n_neg} neg; "
        f"critic loss first/last chunk {closs[:100].mean():.5f} / "
        f"{closs[-100:].mean():.5f}; eval IoU {handler.last_ious}; "
        f"phase {time.time() - t0:.1f} s")
    check(iou >= MIN_IOU, f"seed {seed}: eval IoU {iou} < {MIN_IOU}")


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
