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
           operations / peak); the gather-shift-normalise ingest
           (`normalize_u8`) at the serve batch in f32 and bf16 and at
           the masker and critic steps' segments (every shift -63..63),
           with the device time of a step's one launch; the fused
           upsample-into-concat pair
           (`upsample2x`, `upsample2x_bwd`) at the decoder's five skip
           joins, at batch 8192 (serve) and 64 (masker step), beside
           the unfused pair it replaced, with the device time from
           torch.profiler at batch 64; the merges, writing the joined
           (replaced || injected) batch, and their gradient, for dz
           alone (what the masker step asks for) and for all three
           outputs, at the masker step's shapes (with their device
           time) and at batch 8192; `threshold_iou` at the eval set
           (exact counts, one device operation per call, device time
           with the L2 flushed before each call);
  serve    runs `MaskPipeline` at chfak 5 (the published width), batch
           8192, on device-resident frames, in f32 (TF32 off) and
           bf16: kernel path against plain path, 1 `normalize_u8` and 5
           `upsample2x` launches per batch and no concat kernel,
           frames/s;
  step     one chfak-5 masker step through `masker_step` (default
           flags, f32, TF32 off, deterministic cuDNN, frames gathered
           from uint8 banks by index): loss terms and every gradient
           of the kernel path bit-equal to the plain path, every
           decoder gradient non-zero, the launches per step (1 ingest,
           1 + 1 merge, 5 + 5 upsample), merge_pair_bwd asked for dz
           alone, and the gradient layouts the kernels were handed;
  speed    critic and masker train steps/s at chfak 5, f32 and bf16,
           and the device time of one critic and one masker step by
           category, with no concat kernel in either;
  eval     (serving main path) a `Handler` built from `-eval -salience
           -synthetic_data --chfak 5`: `evaluate(..., write=False)` on
           the 2450-frame synthetic set; the kernel IoU must equal a
           host numpy IoU of the same masks; then `evaluate` again
           with its parts timed (pipeline, the masks' upload, the
           `threshold_iou` call, the saliency normalisation, the rest);
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
# the decoder's skip joins: (name, skip channels Cs, upsampled channels
# Cu, input H = W, factor); ragged ones: (Cs, Cu, H, W, factor), odd
# Cs, Cu and W, no skip (the plain upsample)
CHFAK5_JOINS = [("in3", 80, 160, 1, 4), ("in2", 40, 80, 4, 2),
                ("in1", 40, 40, 8, 2), ("in0", 40, 40, 16, 2),
                ("head", 3, 40, 32, 2)]
CHFAK1_JOINS = [("in3", 16, 32, 1, 4), ("in2", 8, 16, 4, 2),
                ("in1", 8, 8, 8, 2), ("in0", 8, 8, 16, 2),
                ("head", 3, 8, 32, 2)]
RAGGED_JOINS = [(5, 7, 3, 9, 2), (3, 5, 2, 3, 4), (0, 7, 3, 5, 2),
                (0, 3, 5, 7, 2)]
BATCH = 8192
EVAL_N, FRAME_F, MASK_F = 2450, 64 * 64 * 3, 64 * 64
MASKER_N = 64        # frames a masker step merges and decodes (2K)
PIX = 64 * 64
SERVE_KERNELS = ("normalize_u8", "upsample2x", "threshold_iou")
TRAIN_KERNELS = ("normalize_u8", "merge_pair", "merge_pair_bwd",
                 "upsample2x", "upsample2x_bwd", "threshold_iou")
STEP_LAUNCHES = {"normalize_u8": 1, "merge_pair": 1, "merge_pair_bwd": 1,
                 "upsample2x": 5, "upsample2x_bwd": 5}
# the outputs of merge_pair_bwd checked (da, db, dz): the masker step's
# (its frames need no gradient), all three, and da with dz
BWD_NEEDS = [(False, False, True), (True, True, True), (True, False, True)]
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


def _join_inputs(n, cs, cu, h, w, f, dt, gen):
    """NHWC skip (n, fH, fW, Cs) and x (n, H, W, Cu) on the card."""
    return tuple(torch.rand(shape, device="cuda", generator=gen).to(dt)
                 for shape in ((n, f * h, f * w, cs), (n, h, w, cu)))


def _unaligned(t):
    """A copy of t whose data starts 1 element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return buf.copy_(t.flatten()).view(t.shape)


def _unfused_fwd(skip, x, f):
    """A join as the decoder ran it before the fusion: the upsample
    kernel with no skip (twice for x4), then torch.cat."""
    from cgs_tpu_torch.ops.upsample import LEVELS, upcat_fwd
    for _ in range(LEVELS[f]):
        x = upcat_fwd(None, x)
    return torch.cat([skip, x], -1)


def _unfused_bwd(g, cs, f, need_skip):
    """Its gradient as it ran before the fusion: the sum-pool kernel on
    the upsampled channels' slice (twice for x4), and a copy of the
    skip's slice."""
    from cgs_tpu_torch.ops.upsample import LEVELS, upcat_bwd
    dskip = g[..., :cs].contiguous() if need_skip else None
    dx = g[..., cs:]
    for _ in range(LEVELS[f]):
        dx = upcat_bwd(dx, 0, need_skip=False)[1]
    return dskip, dx


def _name(dt) -> str:
    return "f32" if dt == torch.float32 else "bf16"


def _step_banks(gen, n=2048):
    """uint8 pos and neg banks with their labels, on the card, and one
    masker step's index rows h, l (K = 32 each) and c (2K), with
    repeated indices."""
    def bank():
        return torch.randint(0, 256, (n, 64, 64, 3), dtype=torch.uint8,
                             device="cuda", generator=gen)

    def rows(k):
        return torch.randint(0, n, (k,), device="cuda", generator=gen)

    xpos, xneg = bank(), bank()
    ypos = torch.rand(n, device="cuda", generator=gen)
    yneg = torch.rand(n, device="cuda", generator=gen)
    h, l, c = rows(MASKER_N // 2), rows(MASKER_N // 2), rows(MASKER_N)
    h[:8] = h[0]
    return xpos, ypos, xneg, yneg, h, l, c


def _step_segments(banks, shift, critic=False):
    """The ingest segments of a masker step, A = [pos[h] || neg[l]]
    shifted with its labels and B = neg[c]; or of a critic step, 2K
    frames with labels."""
    from cgs_tpu_torch.ops.kernels import Segment
    xpos, ypos, xneg, yneg, h, l, c = banks
    if critic:
        return [Segment(xpos, c, shift, ypos)]
    return [Segment(xpos, h, shift, ypos), Segment(xneg, l, shift, yneg),
            Segment(xneg, c)]


def phase_kernels(_build, summary) -> None:
    from cgs_tpu_torch.ops.kernels import (
        INV255, Segment, gather_normalize_u8, gather_normalize_u8_plain,
        normalize_u8, normalize_u8_plain, threshold_iou,
        threshold_iou_plain,
    )
    from cgs_tpu_torch.ops.upsample import upcat_fwd, upcat_plain

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    t0 = time.time()

    def u8(shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8,
                             device=dev, generator=gen)

    # normalize_u8, the gather-shift-normalise ingest: bit-equal to its
    # plain version at the serve batch (f32 and bf16), the masker step's
    # three segments at every shift -63..63, the critic step's batch,
    # repeated indices, an empty segment, N = 0, and the any-shape case
    err = 0.0

    def same_ingest(segs, dt, what):
        nonlocal err
        (got, gy), (want, wy) = (gather_normalize_u8(segs, dt),
                                 gather_normalize_u8_plain(segs, dt))
        check(got.shape == want.shape
              and torch.equal(_bits(got), _bits(want))
              and ((gy is None and wy is None) or torch.equal(gy, wy)),
              f"normalize_u8 differs from plain at {what}")
        if got.numel():
            err = max(err, float((got.float() - want.float()).abs().max()))

    frames = u8((BATCH, 64, 64, 3))
    banks = _step_banks(gen)
    for dt in (torch.float32, torch.bfloat16):
        same_ingest([Segment(frames)], dt, f"serve {BATCH} {_name(dt)}")
        for shift in range(-63, 64):
            same_ingest(_step_segments(banks, shift), dt,
                        f"masker step, shift {shift} {_name(dt)}")
        same_ingest(_step_segments(banks, 9, critic=True), dt,
                    "critic step")
        a, b = _step_segments(banks, 2)[:2], _step_segments(banks, 0)[2]
        same_ingest([a[0], a[1]._replace(idx=a[1].idx[:0]), b], dt,
                    "an empty segment")
        same_ingest([Segment(banks[0], a[0].idx[:0])], dt, "N = 0")
        x = u8((3, 4097))
        check(torch.equal(_bits(normalize_u8(x, dt)),
                          _bits(normalize_u8_plain(x, dt))),
              "normalize_u8 differs from plain at (3, 4097)")
    nb = BATCH * FRAME_F
    b_ms, b_by = bound_ms(5 * nb, nb)
    row = {
        "name": "normalize_u8", "route": "cuda",
        "source": "cgs_tpu_torch/csrc/normalize_u8.cu",
        "replaces": "cgs_tpu/ops/pallas_kernels.py:71",
        "launches": 0, "max_abs_err": err,
        "ms": time_ms(lambda: normalize_u8(frames)),
        "plain_ms": time_ms(lambda: normalize_u8_plain(frames)),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": time_ms(lambda: frames.mul(INV255)),
        "library_two_pass_ms": time_ms(
            lambda: frames.to(torch.float32).mul_(INV255)),
        "bf16_ms": time_ms(lambda: normalize_u8(frames, torch.bfloat16)),
        "bf16_plain_ms": time_ms(
            lambda: normalize_u8_plain(frames, torch.bfloat16)),
        "bf16_bound_ms": bound_ms(3 * nb, nb)[0],
        "shape": f"uint8 ({BATCH}, 64, 64, 3) -> f32"}
    del frames
    # the train steps' ingests: the masker step's 3 segments (128
    # frames, 64 labels) and the critic step's 64 frames with labels
    for key, segs in (("masker_step", _step_segments(banks, 5)),
                      ("critic_step", _step_segments(banks, 5,
                                                     critic=True))):
        n = sum(sg.rows for sg in segs)
        n_lab = sum(sg.rows for sg in segs if sg.labels is not None)
        nbytes = 5 * n * FRAME_F + 8 * n + 8 * n_lab
        row[key] = {
            "frames": n,
            "ms": time_ms(lambda: gather_normalize_u8(segs), iters=50),
            "device_ms": device_breakdown(lambda: gather_normalize_u8(segs),
                                          reps=20)["ms_per_step"],
            "plain_ms": time_ms(lambda: gather_normalize_u8_plain(segs),
                                iters=50),
            "plain_device_ms": device_breakdown(
                lambda: gather_normalize_u8_plain(segs),
                reps=20)["ms_per_step"],
            "bound_ms": bound_ms(nbytes, n * FRAME_F)[0]}
    summary["normalize_u8"] = row
    log("[kernels] normalize_u8 (gather-shift-normalise):", json.dumps(row))
    del banks
    torch.cuda.empty_cache()

    # upsample2x, fused into the concat: bit-equal at the five skip
    # joins of chfak 1 and chfak 5, f32 and bf16, at the serve batch and
    # the masker step's; the chfak-5 joins timed beside the unfused pair
    # they replaced (and, at batch 64, their device time)
    fwd = {}
    for n in (BATCH, MASKER_N):
        for dt in (torch.float32, torch.bfloat16):
            for joins in (CHFAK1_JOINS, CHFAK5_JOINS):
                ins = [(name, f) + _join_inputs(n, cs, cu, h, h, f, dt, gen)
                       for name, cs, cu, h, f in joins]
                for name, f, skip, x in ins:
                    check(torch.equal(_bits(upcat_fwd(skip, x, f)),
                                      _bits(upcat_plain(skip, x, f))),
                          f"upsample2x differs from plain at {name} "
                          f"{tuple(skip.shape)} + {tuple(x.shape)} x{f} {dt}")
            rows = []
            for name, f, skip, x in ins:          # the chfak-5 joins
                nbytes = (2 * skip.numel() + (1 + f * f) * x.numel()) \
                    * skip.element_size()
                rows.append({
                    "join": name,
                    "ms": time_ms(lambda: upcat_fwd(skip, x, f)),
                    "unfused_ms": time_ms(lambda: _unfused_fwd(skip, x, f)),
                    "plain_ms": time_ms(lambda: upcat_plain(skip, x, f)),
                    "bound_ms": bound_ms(nbytes)[0]})
            res = {k: sum(r[k] for r in rows) for k in
                   ("ms", "unfused_ms", "plain_ms", "bound_ms")}
            res["joins"] = rows
            if n == MASKER_N:
                for key, fn in (("device_ms", upcat_fwd),
                                ("unfused_device_ms", _unfused_fwd)):
                    res[key] = device_breakdown(
                        lambda: [fn(s, x, f) for _, f, s, x in ins],
                        reps=20)["ms_per_step"]
            fwd[f"batch {n} {_name(dt)}"] = res
            del ins, skip, x
            torch.cuda.empty_cache()
    # ragged joins no decoder has (odd Cs, Cu and W, no pixel or row
    # 16-byte aligned), no skip, N = 0, and inputs off a 16-byte boundary
    for cs, cu, h, w, f in RAGGED_JOINS:
        for n in (3, 0):
            for dt in (torch.float32, torch.bfloat16):
                skip, x = _join_inputs(n, cs, cu, h, w, f, dt, gen)
                for sk, xx in ((skip, x), (_unaligned(skip), _unaligned(x))):
                    check(torch.equal(_bits(upcat_fwd(sk, xx, f)),
                                      _bits(upcat_plain(sk, xx, f))),
                          f"upsample2x differs from plain at "
                          f"{(n, cs, cu, h, w, f)} {dt}")
    log("[kernels] upsample2x (fused into the concat), the 5 chfak-5 "
        "joins (ms, sums over the joins):", json.dumps(fwd))
    r = fwd[f"batch {BATCH} f32"]
    summary["upsample2x"] = {
        "name": "upsample2x", "route": "cuda",
        "source": "cgs_tpu_torch/csrc/upsample2x.cu",
        "replaces": "cgs_tpu/ops/pallas_upsample.py:87",
        "launches": 0, "max_abs_err": 0.0,      # bit-equal, checked above
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "unfused_ms": r["unfused_ms"],
        "shape": f"the 5 chfak-5 skip joins (upsample into concat), f32, "
                 f"batch {BATCH} (sum)"}

    # threshold_iou: exact counts at the eval set, ragged N, odd numel,
    # N = 0, a mask and a gt off their 16-byte boundaries (the element
    # path), and calls back to back (each leaves the last-block ticket at
    # 0 for the next); one device operation per call
    def same_counts(got, m, g, thr, what):
        got = [int(v) for v in got]
        want = [int(v) for v in threshold_iou_plain(m, g, thr)]
        check(got == want, f"threshold_iou {got} != plain {want} at {what}")

    for shape in [(EVAL_N, MASK_F), (1001, MASK_F), (3, 4095),
                  (0, MASK_F)]:
        m = torch.rand(shape, device=dev, generator=gen)
        g = torch.rand(shape, device=dev, generator=gen) > 0.7
        same_counts(threshold_iou(m, g, 0.05), m, g, 0.05, shape)
        if shape[0]:
            same_counts(threshold_iou(_unaligned(m), g, 0.05), m, g, 0.05,
                        f"{shape}, mask off a 16-byte boundary")
            same_counts(threshold_iou(m, _unaligned(g), 0.05), m, g, 0.05,
                        f"{shape}, gt off a 16-byte boundary")
    m = torch.rand((EVAL_N, MASK_F), device=dev, generator=gen)
    g = (torch.rand((EVAL_N, MASK_F), device=dev, generator=gen) > 0.7)
    thrs = (0.05, 0.5, 0.05, 0.95)
    outs = [threshold_iou(m, g, t) for t in thrs]      # no sync between
    for out, t in zip(outs, thrs):
        same_counts(out, m, g, t, f"back-to-back call, threshold {t}")
    ops = device_breakdown(lambda: threshold_iou(m, g, 0.05),
                           reps=20)["device_ops_per_step"]
    check(ops == 1, f"threshold_iou made {ops} device operations per "
                    "call, want 1")
    # device time with the L2 flushed before each call (`evaluate`'s
    # masks arrive by a 50 MB upload): by reading 256 MB, which leaves
    # the L2 clean, and by writing them, which leaves it full of dirty
    # lines the kernel's reads must write back; and warm, back to back
    flush = torch.zeros(2 ** 28 // 4, device=dev)
    cold_ms, per_call = kernel_device_ms(
        lambda: threshold_iou(m, g, 0.05), "threshold_iou",
        before=flush.sum)
    check(per_call == 1, f"threshold_iou: {per_call} kernels per call")
    ne = EVAL_N * MASK_F
    b_ms, b_by = bound_ms(5 * ne + 16, ne)
    summary["threshold_iou"] = {
        "name": "threshold_iou", "route": "cuda",
        "source": "cgs_tpu_torch/csrc/threshold_iou.cu",
        "replaces": "cgs_tpu/ops/pallas_kernels.py:221",
        "launches": 0, "max_abs_err": 0.0,        # exact, checked above
        "ms": cold_ms,
        "plain_ms": time_ms(
            lambda: threshold_iou_plain(m, g, 0.05), iters=50),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "device_ms": cold_ms,
        "dirty_l2_device_ms": kernel_device_ms(
            lambda: threshold_iou(m, g, 0.05), "threshold_iou",
            before=flush.zero_)[0],
        "warm_device_ms": kernel_device_ms(
            lambda: threshold_iou(m, g, 0.05), "threshold_iou")[0],
        "host_ms_per_call": time_ms(lambda: threshold_iou(m, g, 0.05),
                                    iters=50),
        "device_ops_per_call": ops,
        "shape": f"f32 + bool ({EVAL_N}, {MASK_F}); ms is device time "
                 "with the L2 flushed (by a read) before each call"}
    log("[kernels] threshold_iou:", json.dumps(summary["threshold_iou"]))
    del m, g, flush
    torch.cuda.empty_cache()
    log(f"[kernels] ok in {time.time() - t0:.1f} s")


CATEGORIES = (   # first match wins, on the lower-cased kernel name
    ("port kernels", ("normalize_u8", "ingest_", "upsample",
                      "threshold_iou", "merge_pair")),
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


def kernel_device_ms(step, match: str, reps: int = 20, before=None):
    """(device ms per call, launches per call) of the kernels whose name
    holds `match`, from torch.profiler over `reps` calls of `step`, with
    `before()` (an L2 flush, say) enqueued ahead of each call."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            step()
        torch.cuda.synchronize()
    us, count = 0.0, 0
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and match in e.key.lower()):
            us += getattr(e, "self_device_time_total",
                          getattr(e, "self_cuda_time_total", 0))
            count += e.count
    return us / reps / 1e3, count / reps


def _random_params(critic, masker, seed: int):
    from cgs_tpu_torch.models.interop import init_torch_default
    gen = torch.Generator().manual_seed(seed)
    return {name: {k: v.clone() for k, v in
                   init_torch_default(mod, gen).state_dict().items()}
            for name, mod in (("critic", critic), ("masker", masker))}


def phase_serve(_build) -> None:
    from unittest import mock

    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.pipeline as pipeline_mod
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.ops.kernels import normalize_u8_plain
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
        check(per_batch == {"normalize_u8": 1, "upsample2x": 5},
              f"launches per batch {per_batch}, want 1 normalize_u8 "
              "and 5 upsample2x")
        check(mask.shape == (BATCH, 64, 64, 1) and pred.shape == (BATCH,),
              f"output shapes {tuple(mask.shape)} {tuple(pred.shape)}")
        check(bool(torch.isfinite(mask).all()) and
              bool(((mask > 0) & (mask < 1)).all()),
              "masks not finite or outside (0, 1)")
        # the same weights through the plain versions on the card
        with mock.patch.object(pipeline_mod, "normalize_u8",
                               normalize_u8_plain), \
                mock.patch.object(upsample_mod, "upcat_fwd",
                                  upsample_mod.upcat_plain):
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
        breakdown = device_breakdown(lambda: pipe.run_device(frames))
        log(f"[serve] device time chfak5 {name}:", json.dumps(breakdown))
        # the decoder's five joins were the serve batch's only concats
        check("concat" not in breakdown["by_category_ms"],
              f"the serve batch still runs concat kernels: {breakdown}")
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
    again, parts = _eval_breakdown(cfg, pipe, x, gt)
    check(again["ious"] == ious, f"second evaluate: {again['ious']}")
    log(f"[eval] chfak 5 f32, {EVAL_N} frames: IoU {ious} (host numpy "
        f"IoU {host}); evaluate wall {wall:.3f} s; phase "
        f"{time.time() - t0:.1f} s")
    log("[eval] evaluate again, by part (s, host clock, synchronised "
        "around each part):", json.dumps(parts))


def _eval_breakdown(cfg, pipe, x, gt):
    """`evaluate` once more with each part timed on the host clock, the
    card synchronised before and after it: `pipeline.run`,
    `mask_iou_on_device` (the masks' upload, then the `threshold_iou`
    call, timed on its own), the saliency normalisation, and the rest
    (host numpy: the u8 frames, the hard masks, the saliency IoU).
    Measurement only: the same calls run in the same order."""
    from unittest import mock

    import cgs_tpu_torch.eval.harness as harness

    times = {}

    def timed(key, fn):
        def run(*args, **kwargs):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[key] = times.get(key, 0.0) + time.perf_counter() - t
            return out
        return run

    norm = ("normalize_saliency_global" if cfg.salglobal
            else "normalize_saliency_topk")
    with mock.patch.object(pipe, "run", timed("pipeline.run", pipe.run)), \
            mock.patch.object(harness, "mask_iou_on_device",
                              timed("mask_iou_on_device",
                                    harness.mask_iou_on_device)), \
            mock.patch.object(harness, "threshold_iou",
                              timed("threshold_iou call",
                                    harness.threshold_iou)), \
            mock.patch.object(harness, norm,
                              timed("saliency normalisation",
                                    getattr(harness, norm))):
        t = time.perf_counter()
        result = harness.evaluate(cfg, pipe, x, gt, write=False)
        torch.cuda.synchronize()
        total = time.perf_counter() - t
    times["upload (mask_iou_on_device less the threshold_iou call)"] = (
        times["mask_iou_on_device"] - times["threshold_iou call"])
    times["rest of evaluate (host numpy)"] = total - sum(
        times[k] for k in ("pipeline.run", "mask_iou_on_device",
                           "saliency normalisation"))
    times["evaluate"] = total
    return result, times


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
    fused upsample-into-concat backward, bit-equal to their plain
    versions, and timed at the masker step's shapes (the summary rows)
    and at batch 8192."""
    from cgs_tpu_torch.ops.kernels import (
        merge_pair, merge_pair_bwd, merge_pair_bwd_plain, merge_pair_plain,
    )
    from cgs_tpu_torch.ops.upsample import upcat_bwd, upcat_bwd_plain

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

    # merges: the masker step, batch 8192, a ragged shape, N = 0, into
    # the joined (2N) batch, with a and b separate, as the two halves of
    # one joined batch (the ingest's) and off a 16-byte boundary; the
    # backward for each set of outputs in BWD_NEEDS, with the joined
    # gradient in both memory formats cuDNN's dgrad may hand over
    for n, h, w in [(MASKER_N, 64, 64), (BATCH, 64, 64), (7, 5, 9),
                    (0, 64, 64)]:
        ab, z = frames(2 * n, h, w), frames(n, h, w, 1)
        a, b = frames(n, h, w), frames(n, h, w)
        ua = _unaligned(a.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        pairs = ((a, b, "separate"), (ab[:n], ab[n:], "joined"),
                 (ua, b, "unaligned"))
        for x, y, how in pairs:
            same([merge_pair(x, y, z)], [merge_pair_plain(x, y, z)],
                 f"merge_pair at {(n, h, w)} {how}")
        g = frames(2 * n, h, w)
        for fmt in (torch.channels_last, torch.contiguous_format):
            gg = g.contiguous(memory_format=fmt)
            for x, y, how in pairs:
                for need in BWD_NEEDS:
                    got = merge_pair_bwd(x, y, z, gg, need)
                    want = merge_pair_bwd_plain(x, y, z, gg, need)
                    what = f"merge_pair_bwd at {(n, h, w)} {how} {fmt} {need}"
                    check(all((t is not None) == k
                              for t, k in zip(got, need)),
                          f"{what}: outputs not as asked")
                    same([t for t in got if t is not None],
                         [t for t in want if t is not None], what)
            del gg
        del a, b, z, ab, ua, g, pairs
    torch.cuda.empty_cache()

    # timed with a and b the halves of one joined batch and the joined
    # gradient channels_last-dense, as in the masker step, and NCHW;
    # merge_pair_bwd for dz alone (what the step asks for, 52 B a
    # pixel) and for all three outputs (80 B a pixel)
    dz_only, every = (False, False, True), (True, True, True)
    rows = {}
    for n in (MASKER_N, BATCH):
        ab, z = frames(2 * n), frames(n, 64, 64, 1)
        a, b = ab[:n], ab[n:]
        g = frames(2 * n)
        g_nchw = g.contiguous()
        px = n * PIX
        row = {
            "merge_pair": {
                "ms": time_ms(lambda: merge_pair(a, b, z), iters=50),
                "plain_ms": time_ms(lambda: merge_pair_plain(a, b, z),
                                    iters=50),
                "bound": bound_ms(52 * px, 19 * px)},
            "merge_pair_bwd": {}}
        bwd = row["merge_pair_bwd"]
        for key, need, nbytes, ops in (("dz", dz_only, 52, 11),
                                       ("all", every, 80, 31)):
            bwd[key] = {
                "ms": time_ms(lambda: merge_pair_bwd(a, b, z, g, need),
                              iters=50),
                "ms_nchw_grads": time_ms(lambda: merge_pair_bwd(
                    a, b, z, g_nchw, need), iters=50),
                "plain_ms": time_ms(lambda: merge_pair_bwd_plain(
                    a, b, z, g, need), iters=50),
                "bound": bound_ms(nbytes * px, ops * px)}
            if n == MASKER_N:
                bwd[key]["device_ms"] = kernel_device_ms(
                    lambda: merge_pair_bwd(a, b, z, g, need),
                    "merge_pair_bwd")[0]
        if n == MASKER_N:
            row["merge_pair"]["device_ms"] = kernel_device_ms(
                lambda: merge_pair(a, b, z), "merge_pair")[0]
        rows[n] = row
        del a, b, z, ab, g, g_nchw
        torch.cuda.empty_cache()
    log("[kernels] merges (ms; N = 64 is the masker step; merge_pair "
        "writes the joined 2N batch; merge_pair_bwd for dz alone, as the "
        "step asks, and for all three outputs):", json.dumps(rows))
    for name, src_line in (("merge_pair", 110), ("merge_pair_bwd", 151)):
        r = rows[MASKER_N][name]
        r8 = rows[BATCH][name]
        if name == "merge_pair_bwd":
            r, r8 = r["dz"], r8["dz"]
        summary[name] = {
            "name": name, "route": "cuda",
            "source": "cgs_tpu_torch/csrc/merge_pair.cu",
            "replaces": f"cgs_tpu/ops/pallas_kernels.py:{src_line}",
            "launches": 0, "max_abs_err": errs[name],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0], "bound_by": r["bound"][1],
            "library_ms": None, "device_ms": r["device_ms"],
            "batch_8192_ms": r8["ms"], "batch_8192_bound_ms": r8["bound"][0],
            "shape": f"f32 ({MASKER_N}, 3, 64, 64) channels_last + mask "
                     f"({MASKER_N}, 1, 64, 64)"}
    summary["merge_pair_bwd"]["shape"] += (
        f", joined gradient ({2 * MASKER_N}, 3, 64, 64) channels_last; dz "
        "alone, as the masker step asks")
    summary["merge_pair_bwd"]["all_outputs"] = {
        "device_ms": rows[MASKER_N]["merge_pair_bwd"]["all"]["device_ms"],
        "bound_ms": rows[MASKER_N]["merge_pair_bwd"]["all"]["bound"][0],
        "batch_8192_ms": rows[BATCH]["merge_pair_bwd"]["all"]["ms"],
        "batch_8192_bound_ms":
            rows[BATCH]["merge_pair_bwd"]["all"]["bound"][0]}

    # upsample backward, fused: the five joins of chfak 5 and chfak 1 at
    # batch 128 and the ragged joins at N = 3 and 0, f32 and bf16, the
    # concat gradient in both memory formats cuDNN's dgrad may hand
    # over, with and without the skip's gradient
    cases = [(128, cs, cu, h, h, f)
             for _, cs, cu, h, f in CHFAK5_JOINS + CHFAK1_JOINS]
    cases += [(n, *j) for j in RAGGED_JOINS for n in (3, 0)]
    for n, cs, cu, h, w, f in cases:
        for dt in (torch.float32, torch.bfloat16):
            g = torch.rand((n, f * h, f * w, cs + cu), device=dev,
                           generator=gen).to(dt)
            g_nchw = g.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
            grads = [g, g_nchw] + ([_unaligned(g)] if n == 3 else [])
            for gg in grads:
                for need in (True, False):
                    got = upcat_bwd(gg, cs, f, need)
                    want = upcat_bwd_plain(gg, cs, f, need)
                    check((got[0] is None) == (want[0] is None),
                          "upsample2x_bwd: d_skip returned when not asked")
                    same([t for t in got if t is not None],
                         [t for t in want if t is not None],
                         f"upsample2x_bwd at {(n, cs, cu, h, w, f)} {dt} "
                         f"strides {gg.stride()} d_skip {need}")
    del g, g_nchw, grads
    torch.cuda.empty_cache()

    # timed at the chfak-5 joins with the gradient channels_last-dense
    # (what cuDNN's dgrad hands over, the step phase prints it) and the
    # skip's gradient where the masker step asks for it (not for the
    # head join's frame)
    bwd = {}
    for n in (MASKER_N, BATCH):
        for dt in (torch.float32, torch.bfloat16):
            gs = [(name, cs, f, name != "head",
                   torch.rand((n, f * h, f * h, cs + cu), device=dev,
                              generator=gen).to(dt))
                  for name, cs, cu, h, f in CHFAK5_JOINS]
            rows = []
            for name, cs, f, need, g in gs:
                n_skip = g.numel() // g.shape[3] * cs
                n_dx = (g.numel() - n_skip) // (f * f)
                nbytes = (g.numel() + n_skip * need + n_dx) * g.element_size()
                rows.append({
                    "join": name, "d_skip": need,
                    "ms": time_ms(lambda: upcat_bwd(g, cs, f, need),
                                  iters=50),
                    "unfused_ms": time_ms(
                        lambda: _unfused_bwd(g, cs, f, need), iters=50),
                    "plain_ms": time_ms(
                        lambda: upcat_bwd_plain(g, cs, f, need), iters=50),
                    "bound_ms": bound_ms(nbytes, n_dx * (f * f - 1))[0]})
            res = {k: sum(r[k] for r in rows) for k in
                   ("ms", "unfused_ms", "plain_ms", "bound_ms")}
            res["joins"] = rows
            if n == MASKER_N:
                for key, fn in (("device_ms", upcat_bwd),
                                ("unfused_device_ms", _unfused_bwd)):
                    res[key] = device_breakdown(
                        lambda: [fn(g, cs, f, need)
                                 for _, cs, f, need, g in gs],
                        reps=20)["ms_per_step"]
            bwd[f"batch {n} {_name(dt)}"] = res
            del gs, g
            torch.cuda.empty_cache()
    log("[kernels] upsample2x_bwd (fused), the 5 chfak-5 joins (ms, sums "
        "over the joins):", json.dumps(bwd))
    r = bwd[f"batch {MASKER_N} f32"]
    summary["upsample2x_bwd"] = {
        "name": "upsample2x_bwd", "route": "cuda",
        "source": "cgs_tpu_torch/csrc/upsample2x.cu",
        "replaces": "cgs_tpu/ops/pallas_upsample.py:132",
        "launches": 0, "max_abs_err": errs["upsample2x_bwd"],
        "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": "bytes", "library_ms": None,
        "unfused_ms": r["unfused_ms"], "device_ms": r["device_ms"],
        "unfused_device_ms": r["unfused_device_ms"],
        "shape": f"the 5 chfak-5 skip joins, f32, batch {MASKER_N} (sum)"}
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
    """One chfak-5 masker step (`masker_step`, default flags: frames and
    labels gathered from uint8 banks by index, A shifted), kernel path
    against plain path: loss terms and every gradient bit-equal, every
    decoder gradient non-zero, launches per step as expected. The
    optimizer has lr 0, so both runs start from the same weights and
    the step's gradients stay in .grad."""
    from unittest import mock

    import cgs_tpu_torch.ops.merge as merge_mod
    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.train.losses as losses_mod
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.ops.kernels import (
        gather_normalize_u8_plain, merge_pair_bwd_plain, merge_pair_plain,
    )
    from cgs_tpu_torch.train.steps import StepRng, masker_step

    t0 = time.time()
    dev = torch.device("cuda")
    cfg = parse_args(["-train", "--chfak", "5", "--dropout", "0.5"])
    check(cfg.live and cfg.inject, "default flags are live + inject")
    models = _train_models(torch.float32, seed=3)
    opt = torch.optim.SGD([p for m in models.values()
                           for p in m.parameters()], lr=0.0)
    segs = _step_segments(_step_banks(
        torch.Generator(device=dev).manual_seed(4), n=256), 0)
    terms = ("replace", "inject", "norm", "critic")

    def run():
        rng = StepRng.seeded(0, dev)          # the same draws each run
        out = masker_step(cfg, models, opt, segs[:2], segs[2], rng)
        torch.cuda.synchronize()
        return ({t: float(v) for t, v in zip(terms, out)},
                {f"{n}.{k}": p.grad.detach().clone()
                 for n, m in models.items()
                 for k, p in m.named_parameters()})

    layouts = {}
    real_mbwd, real_ubwd = merge_mod.merge_pair_bwd, upsample_mod.upcat_bwd

    needs = []

    def spy_mbwd(a, b, z, g, need):
        layouts["merge_pair_bwd (joined g)"] = _layout(g)
        needs.append(tuple(need))
        return real_mbwd(a, b, z, g, need)

    def spy_ubwd(gg, cs, factor, need_skip):
        layouts.setdefault("upsample2x_bwd (shape, strides, Cs, d_skip)",
                           []).append([list(gg.shape), list(gg.stride()),
                                       cs, need_skip])
        return real_ubwd(gg, cs, factor, need_skip)

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        _build.launches.clear()
        with mock.patch.object(merge_mod, "merge_pair_bwd", spy_mbwd), \
                mock.patch.object(upsample_mod, "upcat_bwd", spy_ubwd):
            k_terms, k_grads = run()
        per_step = dict(_build.launches)
        with mock.patch.object(losses_mod, "gather_normalize_u8",
                               gather_normalize_u8_plain), \
                mock.patch.object(merge_mod, "merge_pair",
                                  merge_pair_plain), \
                mock.patch.object(merge_mod, "merge_pair_bwd",
                                  merge_pair_bwd_plain), \
                mock.patch.object(upsample_mod, "upcat_fwd",
                                  upsample_mod.upcat_plain), \
                mock.patch.object(upsample_mod, "upcat_bwd",
                                  upsample_mod.upcat_bwd_plain):
            _build.launches.clear()
            p_terms, p_grads = run()
            check(sum(_build.launches.values()) == 0,
                  f"plain path launched {dict(_build.launches)}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    log("[step] launches per masker step:", per_step)
    check(per_step == STEP_LAUNCHES,
          f"launches per masker step {per_step}, want {STEP_LAUNCHES}")
    # the frames need no gradient: the step asks merge_pair_bwd for dz
    log("[step] merge_pair_bwd asked for (da, db, dz):", needs)
    check(needs == [(False, False, True)],
          f"the masker step asked merge_pair_bwd for {needs}, want "
          "[(False, False, True)]")
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
    device time of one critic and one masker step (`critic_step`,
    `masker_step`, frames gathered from the banks by index), with no
    concat kernel left in either."""
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.ops.kernels import Segment
    from cgs_tpu_torch.train.contrastive import sample_index_stacks
    from cgs_tpu_torch.train.loops import critic_chunk, masker_chunk
    from cgs_tpu_torch.train.steps import (
        StepRng, critic_step, make_optimizer, masker_step,
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
        x = Segment(bank, torch.from_numpy(idx[0]).to(dev), labels=ybank)
        c_prof = device_breakdown(lambda: critic_step(
            cfg, models["critic"], opt, x, rng))

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
        log(f"[speed] chfak 5 {name}: critic {c_sps:.1f} steps/s (batch "
            f"64), masker {m_sps:.1f} steps/s (2K = 64)")
        h0, l0, c0 = (torch.from_numpy(i[0].astype(np.int64)).to(dev)
                      for i in (h, l, c))
        a = [Segment(xpos, h0, labels=ypos), Segment(xneg, l0, labels=yneg)]
        m_prof = device_breakdown(lambda: masker_step(
            cfg, models, opt, a, Segment(xneg, c0), rng))
        log(f"[speed] device time of one masker step, chfak5 {name}:",
            json.dumps(m_prof))
        log(f"[speed] device time of one critic step, chfak5 {name}:",
            json.dumps(c_prof))
        for step, prof in (("masker", m_prof), ("critic", c_prof)):
            check("concat" not in prof["by_category_ms"],
                  f"the {step} step still runs concat kernels: {prof}")
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
