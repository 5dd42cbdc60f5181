#!/usr/bin/env python3
"""The PyTorch port's (`cgs_tpu_torch`) main paths, run whole on one CUDA
card.

    python3 chip_smoke.py
    python3 chip_smoke.py --train-seeds 0,1,2   # the protocol per seed
    python3 chip_smoke.py --only-dp             # the dp phase alone
    python3 chip_smoke.py --only-swin           # the swin phase alone

Where the card's checks live: checks of single kernels and single steps
on the card are the `cuda`-marked tests (`pytest -m cuda
tests/test_torch_port_cuda.py tests/test_torch_port_masker_graph.py`);
speed is measured only by `portbench/` (`portbench/run.py`, the cells
of `BENCHMARK.json`); this script runs the port's main paths on the
card and checks what only a whole path shows. It times nothing.

Run from the root of a checkout on a machine with an NVIDIA card
(written for an H100, `sm_90a`) and `nvcc`. It builds the CUDA kernels
from `cgs_tpu_torch/csrc/` and the dense-CRF library, then:

  seeded   at R = 2 and 3 a seeded chfak-5 masker step's kernel path
           bit-equal to its plain path ((R, 4) terms and every
           gradient, dropout 0.5, shifts drawn); three seeded steps of
           R = 2 at dropout 0 with given shifts agree with three serial
           `masker_step`s per seed within SP_TOL (f32, TF32 off): the
           first step's gradients, the terms, and the parameters under
           SGD (under Adam, which steps by ~lr on a gradient at 0,
           their |diff| is logged); at dropout 0.5 with shifts drawn,
           R = 3 and R = 10 seeded masker and critic steps against each
           seed's serial steps (terms and first-step gradients) and the
           last seed alone against its slot at R (terms and
           parameters), within SP_TOL: each seed draws its own dropout
           masks;
  eval     (serving main path) a `Handler` built from `-eval -salience
           -synthetic_data --chfak 5`: `evaluate(..., write=False)` on
           the 2450-frame synthetic set; the kernel IoU must equal a
           host numpy IoU of the same masks, and a second `evaluate`
           the first; then `evaluate` under `-crf` (f32 wire): the
           dense-CRF library must build and load, and its `crf` variant
           must equal `DenseCRF` on the plain path's masks;
  process  (serving main path) `_mask_variants` with the u8 wire and
           the device-side binarisation against the f32 wire
           thresholded on the host;
  ensemble (ensemble main path) 3 random-weight members saved as
           `{model}-seed{s}` runs in a temporary directory, a `Handler`
           from `-eval --ensemble 3 -synthetic_data --chfak 5`,
           `evaluate(..., write=False)`: 1 `normalize_u8`, 15
           `upsample2x` and 1 `threshold_iou` launch, masks bit-equal
           to the plain path's ensemble and within 1e-6 of the mean of
           three single-member pipelines;
  profile  (profile main path) `cli.main([... "-eval", "--profile",
           DIR], primary=False)`: the trace file exists and names the
           port's device kernels (`ingest_*`, `upsample_cat_fwd`,
           `threshold_iou_kernel`);
  video    (video main path; cv2 and PIL) a 48-frame 128x128 mp4
           through `cli.main(["-process", "--source-imgs", clip])`:
           the two mask videos of 48 frames; then `-vismasker` on a
           64-frame synthetic test split: the three curve videos;
           `normalize_u8` and `upsample2x` launch (no IoU is computed);
  serve-http  (HTTP serving main path) `cgs_tpu_torch.serve.MaskServer`
           at chfak 5 f32, --infer-batch 256, seeded random weights in
           .pt files of a temporary run dir: 32 client threads in a
           process of their own POST 1024 distinct frames, once plain
           and once under the profiler's CUDA tracing, which must see
           device kernels (raw PNGs within one level of the offline
           `MaskPipeline.run` at batch 256 and identical on >= 99.9% of
           pixels; thresholded equal away from the threshold; crf equal
           to `DenseCRF` of the mask the server handed it; /stats
           dispatches < requests; /healthz 200); a u8-wire server
           answering the same; `/reload` of a second weight set under 8
           clients (each response the old or the new set's mask, never a
           mix; the new set's after the reload returns); 1 ingest and 5
           joins per dispatch (counters and profiler); then
           `--data-parallel 2`, two ranks on cuda:0 over gloo (rank 1 a
           spawned `serve_worker`): the same traffic (raw PNGs against
           the offline pipeline, rank 0's launches 1 + 5 a dispatch) and
           the same `/reload` check; with `--only-dp` on two or more
           cards, the same over NCCL on cards 0 and 1, between two runs
           of the default server, which must take one rank; then
           `--ensemble 3 --data-parallel 2`, which does not divide: one
           warning and rank 0 serving the whole ensemble unmeshed, its
           masks bit-equal to the one-rank `--ensemble 3` server's, once
           as `MaskServer` starts it (no second rank) and once in a
           world already joined (two ranks on cuda:0 over gloo, rank 1
           in `serve.main` as under torchrun, returning at once);
  int8     (int8 main path) `MaskPipeline(quantize="int8")` at chfak 5:
           every quantized conv's s32 sums equal the float64 plain
           version at batch 8; at batch 8192, dynamic and static (512
           calibration frames) scales within JAX's bounds of the f32
           path; 1 ingest and 5 joins per batch;
  train    (training main path) the N-seed runner
           `sandbox.multirun.run_seeds(["-train", "-eval",
           "-synthetic_data", "--chfak", "5", "--dropout", "0.5", ...],
           primary=False)`, one seed per call, with a temporary
           `results.txt`: the paper's synthetic protocol (20k frames,
           critic 10 / masker 12 epochs) with `-frozen` (the CLI's
           `-train` makes cuDNN deterministic), writing no files but
           the runner's line; the eval IoU must reach 0.70;
  train-primary  (training main path as a user runs it) `cli.main(
           ["-train", "-eval", "-synthetic_data", ...], primary=True)`
           at chfak 1, 1100 frames, critic 6 / masker 1 epochs, in a
           temporary directory: both checkpoints, both phases'
           `_loss.png` and the two contrastive histograms as valid PNGs
           (matplotlib's where it is installed, else PIL's; the log
           says which); then one chfak-1 critic step (batch 32) and
           masker step (K = 32), kernel path bit-equal to plain path;
  seed-parallel  (seed-parallel main path) `run_parallel` of R = 3
           seeds of the easy protocol (-frozen, chfak 5, 20k frames,
           critic 10 / masker 12 epochs) in a temporary directory: every
           seed's IoU >= 0.70, the ensemble IoU finite, 12 * ceil(max
           |pos| / 32) masker steps, the JAX runner's results.txt line;
  resume   (resume main path) a small chfak-5 `-train -orbax` (dropout
           0.5, shift on) broken after its second masker chunk and
           resumed: critic and masker bit-equal to an uninterrupted run;
  drift, ablation  (their main paths) `sandbox.drift.main` over full and
           frozen (2 masker epochs): the frozen rows read 0 drift
           exactly, the full rows more; `sandbox.ablation.run_ablation`
           of R = 2 over the four variants and its paired summary, at
           chfak 5 and a small depth;
  zoo      (zoo main path) `models/zoo.py:Unet` at chfak 5: one
           `sandbox/merge_variants.py:make_pair_merge_step` over 32 + 32
           synthetic frames through the kernels and through their plain
           versions (f32, TF32 off, deterministic cuDNN): terms and
           every gradient bit-equal, every decoder gradient non-zero,
           launches 5 / 5 / 1 / 1 (up-first joins forward and backward,
           merge_pair, merge_pair_bwd); then 155 Adam pair steps with
           finite losses, a `sum_segm` chunk and the `unet_embeddings`
           projection on the card;
  cluster  `sandbox/cluster.py:cluster_frames` over 1024 synthetic
           frames (4.19M pixels, K = 20, 25 iterations) on the card and
           on the CPU from the same initial indices: labels equal on >=
           99.9% of pixels, centroids within 1e-4, the same target;
           `sandbox/patch_embed.py:create_patch_embedding_clusters` at
           the reference config (700 + 700 frames, embed_dim 100, 100
           clusters, pw 10, stride 2) on the card: histograms summing to
           100, tree-prob column 2 peaking at 1, the 7-tuple
           round-tripping;
  bench-width  (width-sweep main path) `sandbox/bench_width.main` at
           chfak 5 (inference, 8 dispatches a group), then its
           `bench_training` in chunks of 20 steps x 3 (critic and masker
           f32 / bf16, the masker at fuse none / merges): eight lines,
           each finite and positive (their figures are not logged), and
           the ingest, join, merge and merge-gradient kernels launched;
           then `MaskPipeline` at its auto batch (6553) and at the serve
           batch (8192, the process cells' batch) in f32 and bf16, the
           chfak-1 pair's and the `--critic resnet18`, `convnext_t` and
           `swin_v2_t` pairs' `MaskPipeline` at the serve batch in f32
           (the ImageNet pairs: 1 ingest, 5 joins, the skipless 32x32
           one among ConvNeXt-T's, 5 epilogues and 1 whole mask head a
           batch), and one critic step (batch 64) and one masker step
           (K = 32) at fuse both (the masker cell's step), none and
           merges, each kernel path bit-equal to its plain path but the
           pipelines' masks, whose worst gap to the mask head evaluated
           in float64 is at most twice the plain path's;
  dp       (data-parallel main path, `cgs_tpu_torch/parallel/`) (a) NCCL
           at world size 1: a chfak-5 critic step and masker step
           through the DP code bit-equal to the unmeshed chunks, the
           same launches (2 ingests, 1 + 1 merge, 5 + 5 joins);
           (b) two ranks on cuda:0 over gloo (NCCL takes one rank per
           card): the first critic and masker steps (dropout 0, TF32 off,
           deterministic cuDNN) against one process on the whole batch,
           losses and gradients within 1e-5 of each tensor's largest, or
           within 4 times what taking every row twice moves them (the
           same math at twice the batch: a bias gradient's float32 sum
           of 262,144 pixels moves with the batch size), and
           SGD's parameters too (Adam's gap logged); a chfak-5 `-train
           -eval -synthetic_data -orbax` at 2k frames on both ranks
           (primary=False): both ranks' parameters bit-identical, only
           rank 0 wrote files (its train states), the eval IoU from the
           reduced kernel counts equal to the host numpy IoU of the
           assembled masks; the two-rank pipeline's f32 masks bit-equal
           to the unmeshed pipeline at the per-rank batch, within 1e-5
           of the unmeshed whole batch (hard masks equal away from the
           threshold); a seed-sharded `--ensemble 2` bit-equal to
           unmeshed; `run_parallel` of R = 2 over the 2 ranks bit-equal
           to each seed's unmeshed R = 1 run, its first step within
           SP_TOL of the unmeshed R = 2 run and the gap of each later
           step logged (a seed's grouped convolutions round apart at
           R = 1 and 2, and Adam grows it); (c) the checks of (b) over
           NCCL across cards when there are two or more, else one line
           saying it did not run;
  swin     (the `--critic swin_v2_t` pair's main paths) `-train -eval`
           by `cli.main(SWIN_ARGV, primary=True)` in a temporary
           directory (the critic phase, then the masker phase with the
           critic live: its checkpoints, finite losses, an IoU in [0,
           1]), then `-frozen` with primary=False (the frozen critic's
           drop-path in eval mode); `-process` of a few PNG frames from
           those checkpoints (`-cload 1 -mload 1`): a raw and a hard mask
           a frame, the raw one within one level of `MaskPipeline.run`;
           the HTTP server on the same checkpoints answering as the
           offline pipeline does, within one level; the pipeline's eval
           forward launching 12 `fmha_cutlassF` kernels, one a window
           attention layer (`model.window_attns`), and no softmax; then,
           outside the counted run, one critic step and one masker step
           with the critic live, and one masker step with it frozen, at
           SWIN_ARGV's sizes, kernel path bit-equal to plain path (the
           joins' backward at the pair's shapes: the 32x32 join with no
           skip and the 768 @ 2x2 neck's among them); the pair's
           pipeline at BATCH is held so in bench-width.

Launch counts are set to 0 just before each main path (eval + process;
ensemble; profile; video; serve-http; int8; train; train-primary;
seed-parallel; resume; drift; ablation; zoo; bench-width; dp; swin) and read
just after it; every kernel of a path must have launched there, and
every kernel on some path. Weights are random, from a seed. Any failed
check exits non-zero. Without CUDA, or without the rest of the
checkout, it fails and prints no result. The last lines are the whole
run's seconds (to hold against a run's time limit) and peak device
memory, the launches per kernel over the main paths, the card's name
and power limit from nvidia-smi, and {"ok": true, "device": {...}}.
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
BATCH = 8192            # the serve batch
# the HTTP server: its micro-batch and the distinct frames 32 clients post
SERVE_BATCH, SERVE_FRAMES = 256, 1024
EVAL_N = 2450           # the synthetic eval set
MASKER_N = 64        # frames a masker step merges and decodes (2K)
SERVE_KERNELS = ("normalize_u8", "upsample2x", "bias_act_pool",
                 "conv_mask_head", "threshold_iou")
# video -process and -vismasker compute no IoU
VIDEO_KERNELS = ("normalize_u8", "upsample2x", "bias_act_pool",
                 "conv_mask_head")
# int8 runs its own convolutions (ops/quant.py), with no epilogue kernel
INT8_KERNELS = ("normalize_u8", "upsample2x")
# the convolution epilogues of one paper-critic forward and its decoder's
# (the mask head's two convolutions aside: one `conv_mask_head` launch in
# f32, masker.0 then one `mask_head` in bf16)
EPILOGUES = 10
ENSEMBLE_R = 3
# one ensemble evaluate of the 2450-frame set: one batch, ingested once,
# each member's five decoder joins, ten epilogues and mask head, one IoU
# count
ENSEMBLE_LAUNCHES = {"normalize_u8": 1, "upsample2x": 5 * ENSEMBLE_R,
                     "bias_act_pool": EPILOGUES * ENSEMBLE_R,
                     "conv_mask_head": ENSEMBLE_R,
                     "threshold_iou": 1}
# the names of the port's device kernels a --profile trace must show
TRACE_KERNELS = ("ingest_", "upsample_cat_fwd", "threshold_iou_kernel")
TRAIN_KERNELS = ("normalize_u8", "merge_pair", "merge_pair_bwd",
                 "upsample2x", "upsample2x_bwd", "threshold_iou")
STEP_LAUNCHES = {"normalize_u8": 1, "merge_pair": 1, "merge_pair_bwd": 1,
                 "upsample2x": 5, "upsample2x_bwd": 5}
PROTOCOL = ["-train", "-eval", "-synthetic_data", "--chfak", "5",
            "--dropout", "0.5", "--datasize", "20000", "--cepochs", "10",
            "--mepochs", "12", "-frozen", "--model", "chip-smoke-train"]
MIN_IOU = 0.70
# the seed-parallel runner: R seeds of the easy protocol at once
SP_R = 3
SP_PROTOCOL = ["-synthetic_data", "--chfak", "5", "--dropout", "0.5",
               "--datasize", "20000", "--cepochs", "10", "--mepochs", "12",
               "-frozen", "--model", "chip-smoke-sp"]
# seeded (grouped cuDNN convolutions) against serial masker steps, three
# steps at dropout 0, f32, TF32 off: the largest |difference| allowed in
# any loss term or parameter, and in the first step's gradients relative
# to each tensor's largest (the CPU tests hold 1e-5 after two steps)
SP_TOL = 2e-4
# -orbax resume: a small chfak-5 run, several masker chunks per epoch
RESUME_CHUNK = 2
RESUME_ARGV = ["-train", "-synthetic_data", "--chfak", "5", "--dropout",
               "0.5", "--datasize", "2000", "--testsize", "200", "--cepochs",
               "2", "--mepochs", "2", "--visevery", str(RESUME_CHUNK),
               "--high-rew-thresh", "0.55", "--low-rew-thresh", "0.45",
               "--contrastive-min", "50", "-orbax"]
RESUME_KERNELS = ("normalize_u8", "merge_pair", "merge_pair_bwd",
                  "upsample2x", "upsample2x_bwd")
# the drift probe and the paired ablation at chfak 5, small depth
SMALL = ["-synthetic_data", "--chfak", "5", "--dropout", "0.5",
         "--datasize", "4000", "--testsize", "500", "--cepochs", "3",
         "--high-rew-thresh", "0.55", "--low-rew-thresh", "0.45",
         "--contrastive-min", "100"]
DRIFT_ARGV = SMALL + ["--mepochs", "2", "--model", "chip-smoke-drift",
                      "--variants", "full,frozen"]
ABLATION_ARGV = SMALL + ["--mepochs", "1", "--model", "chip-smoke-abl"]
# data parallelism: a small chfak-5 -train -eval -orbax run per world,
# the meshed pipeline's batch (each of 2 ranks runs half), the bound on
# a DP step against the whole-batch step (relative to each tensor's
# largest |value|: a mean of two half-batch means against one mean),
# and the seed-parallel runner's short run
DP_ARGV = ["-train", "-eval", "-synthetic_data", "--chfak", "5",
           "--dropout", "0.5", "--datasize", "2000", "--testsize", "200",
           "--cepochs", "3", "--mepochs", "1", "--high-rew-thresh", "0.55",
           "--low-rew-thresh", "0.45", "--contrastive-min", "50", "-orbax",
           "--model", "chip-smoke-dp"]
DP_PIPE_B, DP_FRAMES = 512, 1024
DP_TOL = 1e-5
# ... or, for a tensor whose float32 sums round further with the batch
# size (a bias gradient sums 262,144 pixels a batch; on the CPU the
# masker's last two conv biases move by 1.4e-4 and 1.0e-3 of their
# largest when every row is taken twice), DP_FLOOR times the gap that
# taking every row twice makes (`_doubled`: the same math, twice the
# batch)
DP_FLOOR = 4.0
DP_EVAL_THRESH = 0.05
# the HTTP server over ranks
SERVE_DP_WORLD = 2
# the zoo path: zoo.Unet at chfak 5, a pair step over A (ZOO_N frames)
# and its ZOO_N negatives, its launches, ZOO_STEPS Adam steps, and the
# sum_segm chunk (steps x batch)
ZOO_N, ZOO_SUM_SEGM = 32, (5, 32)
ZOO_STEPS = 155
ZOO_KERNELS = ("normalize_u8", "upsample2x", "upsample2x_bwd",
               "merge_pair", "merge_pair_bwd")
ZOO_STEP_LAUNCHES = {"upsample2x": 5, "upsample2x_bwd": 5, "merge_pair": 1,
                     "merge_pair_bwd": 1}


# the -train -eval a user runs (primary=True: its checkpoints, loss plots
# and histograms), at chfak 1 and a small size
PRIMARY_ARGV = ["-train", "-eval", "-synthetic_data", "--datasize", "1100",
                "--testsize", "100", "--cepochs", "6", "--batch-size", "32",
                "--dropout", "0", "--high-rew-thresh", "0.55",
                "--low-rew-thresh", "0.45", "--contrastive-min", "5",
                "--mepochs", "1", "--eval-video-max-frames", "2", "--model",
                "chip-smoke-primary"]
PRIMARY_PNGS = ("critic/_loss.png", "segment/_loss.png",
                "pred_idx1_hist.png", "GT_idx1_hist.png")
# the swin_v2_t pair's -train -eval: PRIMARY_ARGV's small protocol, its
# contrastive thresholds put every frame on both sides, so that a critic
# trained for a few epochs always hands the masker phase its two sets
SWIN_ARGV = ["--critic", "swin_v2_t", "-train", "-eval", "-synthetic_data",
             "--datasize", "1100", "--testsize", "100", "--cepochs", "3",
             "--batch-size", "32", "--dropout", "0", "--high-rew-thresh",
             "-1000", "--low-rew-thresh", "1000", "--contrastive-min", "5",
             "--mepochs", "1", "--eval-video-max-frames", "2", "--model",
             "chip-smoke-swin"]
SWIN_KERNELS = ("normalize_u8", "merge_pair", "merge_pair_bwd",
                "upsample2x", "upsample2x_bwd", "threshold_iou",
                "bias_act_pool", "conv_mask_head")
# an ensemble that does not divide over the server's ranks
UNEVEN_R = 3
# per-pixel HSV KMeans: frames (4096 pixels each), clusters, iterations;
# card against CPU: labels equal on this share, centroids within this
KMEANS_FRAMES, KMEANS_K, KMEANS_ITERS = 1024, 20, 25
KMEANS_AGREE, KMEANS_TOL = 0.999, 1e-4
# the patch-embedding family at the reference config
# (TrainHandler.py:4004-4009, :2166): 700 + 700 frames
EMBED_CFG = {"embed_dim": 100, "n_clusters": 100, "n_samples": 700,
             "patch_width": 10, "stride": 2}
# the width sweep at the published width, cut to fit the run: the CLI's
# inference lines at 8 dispatches a group, then its training chunks
# (`bench_training`) at 20 steps x 3 rounds
BENCH_WIDTH_ARGV = ["--chfak", "5", "--iters", "8", "--skip-training"]
BENCH_WIDTH_STEPS, BENCH_WIDTH_ROUNDS = 20, 3
BENCH_WIDTH_KERNELS = ("normalize_u8", "upsample2x", "upsample2x_bwd",
                       "merge_pair", "merge_pair_bwd")
# one batch of the resnet18, convnext_t or swin_v2_t pair: one ingest, the
# decoder's five joins, its five convolution epilogues and its mask head
# (the critic is no `Critic` and takes no epilogue)
ARCH_LAUNCHES = {"normalize_u8": 1, "upsample2x": 5, "bias_act_pool": 5,
                 "conv_mask_head": 1}


class SmokeFailure(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--train-seeds", default="0",
                    help="comma-separated seeds of the train protocol")
    ap.add_argument("--only-dp", action="store_true",
                    help="run only the dp phase (its NCCL-across-cards "
                    "part needs a machine with two or more cards)")
    ap.add_argument("--only-swin", action="store_true",
                    help="run only the swin phase")
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

    from concurrent.futures import ThreadPoolExecutor

    from cgs_tpu_torch.core.device import disable_tf32
    from cgs_tpu_torch.eval import crf
    from cgs_tpu_torch.ops import _build

    # -- set-up -----------------------------------------------------------
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "python", sys.version.split()[0])
    # the host CRF library (g++) builds while nvcc builds the kernels
    with ThreadPoolExecutor(1) as pool:
        crf_build = pool.submit(crf.build_library)
        _build.build_kernels(verbose=True)
        log(f"[setup] kernels built; densecrf library {crf_build.result()}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log("[setup] tf32:", disable_tf32())

    if args.only_dp:
        log("[main path: dp] launches:", phase_dp(_build))
        if torch.cuda.device_count() >= SERVE_DP_WORLD:
            phase_serve_dp_nccl()
        else:
            log("[serve-http dp] NCCL across cards did not run: this "
                "machine has one card")
        log(card)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if args.only_swin:
        log("[main path: swin] launches:", phase_swin(_build))
        log(card)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    phase_seeded_step(_build)

    _build.launches.clear()                 # serving main path starts
    phase_eval(_build)
    phase_process()
    serve_launches = dict(_build.launches)  # serving main path ends
    log("[main path: serve] launches:", serve_launches)
    for name in SERVE_KERNELS:
        check(serve_launches.get(name, 0) > 0,
              f"{name} never launched on the serving main path")
    # the ensemble and profile paths clear and read the counts around
    # their own main-path call
    ensemble_launches = phase_ensemble(_build)
    log("[main path: ensemble] launches:", ensemble_launches)
    profile_launches = phase_profile(_build)
    log("[main path: profile] launches:", profile_launches)
    video_launches = phase_video(_build)
    log("[main path: video] launches:", video_launches)
    # the HTTP server and int8 paths clear and read the counts around
    # their own main-path traffic
    serve_http_launches = phase_serve_http(_build)
    log("[main path: serve-http] launches:", serve_http_launches)
    int8_launches = phase_int8(_build)
    log("[main path: int8] launches:", int8_launches)
    for path, counts, kernels in (
            ("ensemble", ensemble_launches, SERVE_KERNELS),
            ("profile", profile_launches, SERVE_KERNELS),
            ("video", video_launches, VIDEO_KERNELS),
            ("serve-http", serve_http_launches, VIDEO_KERNELS),
            ("int8", int8_launches, INT8_KERNELS)):
        for name in kernels:
            check(counts.get(name, 0) > 0,
                  f"{name} never launched on the {path} main path")

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
    # the train-primary, seed-parallel, resume, drift, ablation, zoo,
    # bench-width and dp paths clear and read the counts around their
    # own main-path calls
    later = {"train-primary": (phase_train_primary(_build), TRAIN_KERNELS)}
    later["seed-parallel"] = (phase_seed_parallel(_build), TRAIN_KERNELS)
    later["resume"] = (phase_resume(_build), RESUME_KERNELS)
    drift_launches, ablation_launches = phase_drift_ablation(_build)
    later["drift"] = (drift_launches, TRAIN_KERNELS)
    later["ablation"] = (ablation_launches, TRAIN_KERNELS)
    later["zoo"] = (phase_zoo(_build), ZOO_KERNELS)
    phase_cluster()
    later["bench-width"] = (phase_bench_width(_build), BENCH_WIDTH_KERNELS)
    later["dp"] = (phase_dp(_build), TRAIN_KERNELS)
    later["swin"] = (phase_swin(_build), SWIN_KERNELS)
    for path, (counts, kernels) in later.items():
        log(f"[main path: {path}] launches:", counts)
        for name in kernels:
            check(counts.get(name, 0) > 0,
                  f"{name} never launched on the {path} main path")
    total = {name: sum(counts.get(name, 0) for counts in (
        serve_launches, ensemble_launches, profile_launches, video_launches,
        serve_http_launches, int8_launches, train_launches,
        *(c for c, _ in later.values()))) for name in _build.KERNELS}
    for name, n in total.items():
        check(n > 0, f"{name} never launched on a main path")

    log(f"[done] {time.time() - t_start:.1f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(json.dumps({"launches_on_main_paths": total}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def _bits(t):
    """The raw bits, so equality is bit-equality."""
    return t.view({torch.float32: torch.int32,
                   torch.bfloat16: torch.int16}[t.dtype])


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


def _random_params(critic, masker, seed: int):
    from cgs_tpu_torch.models.interop import init_torch_default
    gen = torch.Generator().manual_seed(seed)
    return {name: {k: v.clone() for k, v in
                   init_torch_default(mod, gen).state_dict().items()}
            for name, mod in (("critic", critic), ("masker", masker))}


def _png(frame) -> bytes:
    import io

    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    return buf.getvalue()


def _levels(png: bytes) -> np.ndarray:
    import io

    from PIL import Image
    return np.asarray(Image.open(io.BytesIO(png))).astype(np.int16)


def _post(url: str, body: bytes, timeout: float = 60.0) -> bytes:
    import urllib.request
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        check(r.status == 200, f"POST {url}: {r.status}")
        return r.read()


def _http(srv):
    """Start the server's HTTP front on a free port; (base URL, the
    serving thread)."""
    import threading
    httpd = srv.start(port=0)
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    return f"http://127.0.0.1:{httpd.server_address[1]}", t


def _same_png(got: np.ndarray, want: np.ndarray) -> float:
    """The share of identical levels, after checking every level is
    within one of `want`'s (batch position may change cuDNN's sums)."""
    d = np.abs(got - want)
    check(int(d.max()) <= 1, f"served mask {int(d.max())} levels off")
    return float((d == 0).mean())


def _traffic(url: str, bodies, threads: int):
    """POST every body from `threads` client threads; the responses in
    order."""
    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(threads) as ex:
        return list(ex.map(lambda body: _post(url, body), bodies))


# the HTTP load generator, run in its own interpreter so that its
# threads do not share the server's (argv: URL, pickled list of bodies,
# output path, threads); the standard library only
_CLIENTS = r"""
import pickle, sys, urllib.request
from concurrent.futures import ThreadPoolExecutor
url, src, dst, threads = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
with open(src, "rb") as f:
    bodies = pickle.load(f)
def one(body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read()
with ThreadPoolExecutor(threads) as ex:
    res = list(ex.map(one, bodies))
with open(dst, "wb") as f:
    pickle.dump(res, f)
"""


def _traffic_proc(url: str, bodies, threads: int, tmp: str):
    """`_traffic` from a client process of its own: the responses in
    order."""
    import pickle
    src, dst = os.path.join(tmp, "bodies.pkl"), os.path.join(tmp, "out.pkl")
    with open(src, "wb") as f:
        pickle.dump(list(bodies), f)
    subprocess.run([sys.executable, "-c", _CLIENTS, url, src, dst,
                    str(threads)], check=True, timeout=300)
    with open(dst, "rb") as f:
        got = pickle.load(f)
    for status, _ in got:
        check(status == 200, f"POST {url}: {status}")
    return [b for _, b in got]


def _device_names(run):
    """(run()'s result, the names of the device kernels and copies that
    torch.profiler's CUDA tracing saw while it ran); it times nothing."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = run()
        torch.cuda.synchronize()
    return out, {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.name != "Context Sync"}


def _dispatch_kernels(dispatch, names) -> dict:
    """The device kernels of one `dispatch()` whose lower-cased names
    hold each of `names`, counted by torch.profiler over the active step
    of a schedule. The tracer starts late after the earlier phases'
    sessions (it has missed a dispatch's first milliseconds: the ingest
    and the first convolution), so warm-up steps run the dispatch first
    and only the last one is counted."""
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=1, warmup=2, active=1)) as prof:
        for _ in range(4):
            dispatch()
            torch.cuda.synchronize()
            prof.step()
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    return {n: sum(e.count for e in kernels if n in e.key.lower())
            for n in names}


def _reload_under_traffic(base, bodies, publish, new_w, png_old,
                          png_new) -> dict:
    """8 client threads post while `new_w` is published and `/reload`
    called: every response is the old or the new set's mask, never a
    mix, and every request sent after the reload returned the new
    set's. Returns the counts of each."""
    import threading

    seg = f"{base}/segment"
    seen, errors = [], []
    stop = threading.Event()

    def client(k):
        j = k
        try:
            while not stop.is_set():
                i = j % 64
                t = time.perf_counter()
                seen.append((i, t, _levels(_post(seg, bodies[i]))))
                j += 8
        except Exception as e:          # reported below
            errors.append(repr(e))

    workers = [threading.Thread(target=client, args=(k,)) for k in range(8)]
    for w in workers:
        w.start()
    time.sleep(0.5)
    publish(new_w)
    rel = json.loads(_post(f"{base}/reload", b""))
    reloaded_at = time.perf_counter()
    time.sleep(0.5)
    stop.set()
    for w in workers:
        w.join()
    check(not errors, f"clients failed during the reload: {errors}")
    check(rel["reloaded"] == {"critic": True, "masker": True},
          f"/reload answered {rel}")
    n_old = n_new = 0
    for i, t, got in seen:
        d_old = int(np.abs(got - png_old[i]).max())
        d_new = int(np.abs(got - png_new[i]).max())
        check(min(d_old, d_new) <= 1,
              f"frame {i}: a response of neither weight set "
              f"({d_old} / {d_new} levels off)")
        if t > reloaded_at:
            check(d_new <= 1, f"frame {i}: old weights served after the "
                  "reload returned")
        n_old += d_old <= 1
        n_new += d_new <= 1
    return {"responses": len(seen), "old": n_old, "new": n_new}


def _serve_fixture() -> dict:
    """The HTTP phases' frames, their PNG bodies, two seeded chfak-5
    weight sets and the offline pipeline's masks of each (soft, and as
    PNG levels)."""
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.pipeline import MaskPipeline

    frames, _ = synthetic_eval_set(n_frames=SERVE_FRAMES, seed=5)
    critic, masker = Critic(chfak=5, dropout=0.5), UnetDecoder(chfak=5)
    fx = {"frames": frames, "bodies": [_png(f) for f in frames],
          "old_w": _random_params(critic, masker, seed=30),
          "new_w": _random_params(critic, masker, seed=31)}
    for key in ("old", "new"):
        pipe = MaskPipeline(critic, masker, fx[f"{key}_w"],
                            batch_size=SERVE_BATCH, device="cuda")
        m = pipe.run(frames).masks[..., 0]
        fx[f"soft_{key}"] = m
        fx[f"png_{key}"] = (np.clip(m, 0, 1) * 255).astype(np.int16)
    check(np.abs(fx["png_old"] - fx["png_new"]).max() > 10,
          "the two weight sets give the same masks")
    return fx


def _serve_argv(d: str) -> list:
    return ["--chfak", "5", "--infer-batch", str(SERVE_BATCH), "--model",
            os.path.join(d, "run")]


def _publisher(cfg):
    """publish(params): write a weight set as the run dir's .pt files."""
    from cgs_tpu_torch.train.checkpoints import (
        checkpoint_paths, save_model_pt,
    )
    paths = checkpoint_paths(cfg)

    def publish(params):
        for name, state in params.items():
            save_model_pt(state, name, paths[name])

    return publish


def _serve_dp(fx: dict, d: str, backend=None, device_indices=None) -> dict:
    """`serve.py --data-parallel 2` (`MaskServer` rank 0, rank 1 a spawned
    `serve_worker`): 32 clients in a process of their own POST every
    frame (raw PNGs within one level of the offline pipeline's,
    identical on >= 99.9% of pixels), then `/reload` under 8 clients
    (never a mix of the two sets). Returns the dispatches, the share of
    identical levels, the reload counts and rank 0's launches under the
    traffic."""
    import urllib.request

    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.ops import _build
    from cgs_tpu_torch.serve import MaskServer

    cfg = parse_args(_serve_argv(d) + ["--data-parallel",
                                       str(SERVE_DP_WORLD)])
    publish = _publisher(cfg)
    publish(fx["old_w"])
    srv = MaskServer(cfg, backend=backend, device_indices=device_indices)
    try:
        base, _ = _http(srv)
        stats = json.loads(urllib.request.urlopen(f"{base}/stats",
                                                  timeout=30).read())
        check(stats["world"] == SERVE_DP_WORLD,
              f"/stats world {stats['world']}")
        d0 = stats["dispatches"]
        _build.launches.clear()
        raw = _traffic_proc(f"{base}/segment", fx["bodies"], 32, d)
        launches = dict(_build.launches)
        n_disp = srv.batcher.stats["dispatches"] - d0
        same = np.mean([_same_png(_levels(r), fx["png_old"][i])
                        for i, r in enumerate(raw)])
        check(same >= 0.999, f"two ranks: raw PNGs identical on {same:.5f}")
        check(launches == {"normalize_u8": n_disp, "upsample2x": 5 * n_disp,
                           "bias_act_pool": EPILOGUES * n_disp,
                           "conv_mask_head": n_disp},
              f"two ranks: rank 0 launched {launches} for {n_disp} "
              "dispatches")
        reload = _reload_under_traffic(base, fx["bodies"], publish,
                                       fx["new_w"], fx["png_old"],
                                       fx["png_new"])
    finally:
        srv.shutdown()
    return {"dispatches": n_disp, "identical": same, "reload": reload,
            "launches": launches}


def _serve_uneven_ensemble(fx: dict, d: str) -> dict:
    """`--ensemble 3 --data-parallel 2`, which does not divide: served as
    the JAX server serves it, one warning and rank 0 serving the whole
    ensemble unmeshed, its masks bit-equal to the one-rank `--ensemble
    3` server's. Once as `MaskServer` starts it (no second rank starts),
    once in a world already joined, two ranks on cuda:0 over gloo, rank
    1 running `serve.main` as under torchrun (it returns at once, and
    both ranks exit cleanly)."""
    import contextlib
    import io

    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.parallel import mesh as mesh_mod
    from cgs_tpu_torch.parallel import multihost, probes
    from cgs_tpu_torch.serve import MaskServer

    base = os.path.join(d, "ens")
    critic, masker = Critic(chfak=5, dropout=0.5), UnetDecoder(chfak=5)
    for s in range(UNEVEN_R):
        argv = _serve_argv(d)[:-1] + [f"{base}-seed{s}"]
        _publisher(parse_args(argv))(_random_params(critic, masker, 40 + s))
    argv = _serve_argv(d)[:-1] + [base, "--ensemble", str(UNEVEN_R)]
    uneven_argv = argv + ["--data-parallel", str(SERVE_DP_WORLD)]
    frames = fx["frames"][:8]
    mesh_mod._ensemble_warned.clear()
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        one = MaskServer(parse_args(argv))
        try:
            want = np.stack([one.batcher.submit(f).mask for f in frames])
        finally:
            one.shutdown()
        srv = MaskServer(parse_args(uneven_argv))
        try:
            check(srv.world == 1 and srv.mesh is None and srv._ranks is None,
                  f"the uneven ensemble runs {srv.world} ranks")
            got = np.stack([srv.batcher.submit(f).mask for f in frames])
        finally:
            srv.shutdown()
        joined = multihost.launch(
            probes.serve_joined, SERVE_DP_WORLD, (uneven_argv, frames),
            device="cuda", backend="gloo", device_indices=[0, 0])
    printed = out.getvalue()
    log(printed.rstrip())
    warned = printed.count(f"--ensemble {UNEVEN_R} does not divide over "
                           f"{SERVE_DP_WORLD} ranks")
    check(warned == 1, f"the uneven ensemble warned {warned} times")
    check(np.array_equal(got, want),
          "the uneven ensemble's masks differ from the one-rank server's")
    check(joined["world"] == 1 and not joined["meshed"]
          and np.array_equal(joined["masks"], want),
          "in a joined world rank 0 did not serve the ensemble unmeshed "
          "as one rank does")
    return {"warned": warned, "frames": len(frames), "bit_equal": True,
            "joined_world_rank0": "unmeshed"}


def _log_serve_dp(tag: str, dp: dict) -> None:
    log(f"[serve-http dp] two ranks ({tag}), chfak 5 f32, batch "
        f"{SERVE_BATCH}, 32 clients, {SERVE_FRAMES} frames: "
        f"{dp['dispatches']} dispatches; raw identical on "
        f"{dp['identical']:.5f}; reload under 8 clients "
        f"{json.dumps(dp['reload'])}; rank 0 launches {dp['launches']}")


def _serve_default(fx: dict, d: str) -> float:
    """`serve.py` with no --data-parallel on this machine: it must serve
    on one rank whatever the count of cards. The 32 clients of
    `_serve_dp`; returns the share of identical levels."""
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.serve import MaskServer

    cfg = parse_args(_serve_argv(d))
    _publisher(cfg)(fx["old_w"])
    srv = MaskServer(cfg)
    try:
        check(srv.world == 1 and srv.mesh is None,
              f"the default server runs {srv.world} ranks on "
              f"{torch.cuda.device_count()} cards")
        base, _ = _http(srv)
        raw = _traffic_proc(f"{base}/segment", fx["bodies"], 32, d)
        same = np.mean([_same_png(_levels(r), fx["png_old"][i])
                        for i, r in enumerate(raw)])
        check(same >= 0.999, f"one rank: raw PNGs identical on {same:.5f}")
    finally:
        srv.shutdown()
    return same


def phase_serve_dp_nccl() -> None:
    """`serve.py --data-parallel 2` over NCCL on cards 0 and 1, with the
    checks of `_serve_dp` (a machine with two or more cards), between
    two runs of the default server, which must take one rank."""
    fx = _serve_fixture()
    with tempfile.TemporaryDirectory() as d:
        one_a = _serve_default(fx, d)
        dp = _serve_dp(fx, d)
        one_b = _serve_default(fx, d)
    _log_serve_dp("NCCL, cards 0 and 1", dp)
    log(f"[serve-http dp] the default server (one rank of "
        f"{torch.cuda.device_count()} cards) before and after: raw "
        f"identical on {one_a:.5f} / {one_b:.5f}")


def phase_serve_http(_build) -> dict:
    """The HTTP mask server's main path (`cgs_tpu_torch.serve`): chfak 5
    f32, `--infer-batch` SERVE_BATCH, seeded random weights in .pt files
    of a temporary run dir. 32 client threads, in a process of their
    own, POST SERVE_FRAMES distinct frames, then again under the
    profiler's CUDA tracing, which must see device kernels: every raw
    PNG within one level of the offline
    `MaskPipeline.run` at batch SERVE_BATCH and identical on >= 99.9% of
    pixels; `thresholded` equal except within 1e-5 of the threshold;
    `crf` equal to `DenseCRF` of the soft mask the server handed it;
    /stats dispatches < requests; /healthz 200. A second server on the
    u8 wire with the device's hard plane answers the same. `/reload` of
    a second weight set while 8 threads post: every response is the old
    or the new set's mask, never a mix, and every request sent after
    the reload returned is the new set's. One dispatch launches 1
    ingest and 5 joins (counters and a profiler count). Returns the
    launches of the 32-thread traffic."""
    import urllib.request

    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.eval.crf import DenseCRF
    from cgs_tpu_torch.serve import MaskServer

    fx = _serve_fixture()
    frames, bodies, soft_old = fx["frames"], fx["bodies"], fx["soft_old"]
    old_w, new_w = fx["old_w"], fx["new_w"]
    png_old, png_new = fx["png_old"], fx["png_new"]
    servers = []
    with tempfile.TemporaryDirectory() as d:
        argv = _serve_argv(d) + ["--data-parallel", "1"]
        cfg = parse_args(argv)
        publish = _publisher(cfg)
        publish(old_w)
        try:
            crf = DenseCRF()
            crf_seen = []

            def crf_fn(imgs, masks):
                crf_seen.append(masks.copy())
                return crf(imgs, masks)

            srv = MaskServer(cfg, crf_fn=crf_fn)
            servers.append(srv)
            base, _ = _http(srv)
            seg = f"{base}/segment"
            def dispatches():
                return json.loads(urllib.request.urlopen(
                    f"{base}/stats", timeout=30).read())["dispatches"]

            # the main path: 32 clients in a process of their own, every
            # frame once
            _build.launches.clear()
            d0 = dispatches()
            raw = _traffic_proc(seg, bodies, 32, d)
            launches = dict(_build.launches)
            n_disp = dispatches() - d0
            same = np.mean([_same_png(_levels(r), png_old[i])
                            for i, r in enumerate(raw)])
            check(same >= 0.999, f"raw PNGs identical on {same:.5f}")
            check(n_disp < SERVE_FRAMES,
                  f"{n_disp} dispatches for {SERVE_FRAMES} requests")
            with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
                check(r.status == 200, f"/healthz {r.status}")
            # the same traffic again under the profiler's CUDA tracing
            _, traced = _device_names(
                lambda: _traffic_proc(seg, bodies, 32, d))
            check(bool(traced), "the profiler saw no device work under "
                  "traffic")
            # thresholded and crf
            sub = range(0, SERVE_FRAMES, 8)
            thr = _traffic(f"{seg}?variant=thresholded&threshold=0.5",
                           [bodies[i] for i in sub], 32)
            flips = 0
            for i, r in zip(sub, thr):
                want = (soft_old[i] >= 0.5) * 255
                far = np.abs(soft_old[i] - 0.5) > 1e-5
                flips += int((_levels(r) != want)[far].sum())
            check(flips == 0, f"thresholded differs on {flips} pixels away "
                  "from the threshold")
            for i in range(16):
                got = _levels(_post(f"{seg}?variant=crf", bodies[i]))
                want = crf(frames[i:i + 1], crf_seen[-1])[0] * 255
                check(np.array_equal(got, want) and np.abs(
                    crf_seen[-1][0] - soft_old[i]).max() <= 1e-5,
                    f"crf variant of frame {i} is not DenseCRF of its mask")
            # one dispatch: launches and the profiler's kernel count
            one = srv.pipe.place_input(frames[:SERVE_BATCH])
            srv.pipe.run_device(one)
            torch.cuda.synchronize()
            _build.launches.clear()
            srv.batcher.submit(frames[0])
            per_dispatch = dict(_build.launches)
            check(per_dispatch == {"normalize_u8": 1, "upsample2x": 5,
                                   "bias_act_pool": EPILOGUES,
                                   "conv_mask_head": 1},
                  f"launches per serve dispatch {per_dispatch}")
            counts = _dispatch_kernels(lambda: srv.pipe.run_device(one),
                                       ("ingest_", "upsample_cat_fwd"))
            check(counts == {"ingest_": 1, "upsample_cat_fwd": 5},
                  f"profiler kernels per dispatch {counts}")

            # the u8 wire with the device's hard plane
            cfg8 = parse_args(argv + ["--serve-wire", "u8",
                                      "--binarymaskthreshold", "0.5"])
            srv8 = MaskServer(cfg8)
            servers.append(srv8)
            base8, _ = _http(srv8)
            raw8 = _traffic(f"{base8}/segment", [bodies[i] for i in sub], 32)
            same8 = np.mean([_same_png(_levels(r), png_old[i])
                             for i, r in zip(sub, raw8)])
            thr8 = _traffic(
                f"{base8}/segment?variant=thresholded&threshold=0.5",
                [bodies[i] for i in sub], 32)
            flips8 = sum(int((_levels(r) != (soft_old[i] >= 0.5) * 255)[
                np.abs(soft_old[i] - 0.5) > 1e-5].sum())
                for i, r in zip(sub, thr8))
            check(same8 >= 0.999 and flips8 == 0,
                  f"u8 wire: raw identical on {same8:.5f}, thresholded "
                  f"differs on {flips8} pixels")

            # /reload of a second weight set under traffic
            reload = _reload_under_traffic(base, bodies, publish, new_w,
                                           png_old, png_new)
        finally:
            for s in servers:
                s.shutdown()
        # the same traffic over two ranks on the one card (gloo)
        dp = _serve_dp(fx, d, backend="gloo", device_indices=[0, 0])
        uneven = _serve_uneven_ensemble(fx, d)
    ours = sorted(k[:60] for k in traced
                  if any(w in k for w in TRACE_KERNELS))
    log(f"[serve-http] chfak 5 f32, batch {SERVE_BATCH}, 32 clients, "
        f"{SERVE_FRAMES} distinct frames: {n_disp} dispatches; raw PNGs "
        f"identical on {same:.5f} of pixels (the rest 1 level off); "
        f"traced: {len(traced)} device kernel names, the port's {ours}; "
        f"thresholded and crf checked; u8 wire identical on {same8:.5f}; "
        f"reload under 8 clients {json.dumps(reload)}; launches per "
        f"dispatch {per_dispatch}, profiler kernels {counts}")
    _log_serve_dp("gloo, both ranks on cuda:0", dp)
    log(f"[serve-http dp] --ensemble {UNEVEN_R} --data-parallel "
        f"{SERVE_DP_WORLD}: {json.dumps(uneven)}")
    return launches


def phase_int8(_build) -> dict:
    """int8 inference (`MaskPipeline(quantize="int8")`) at chfak 5: at
    batch 8 (in chunks of 2 frames) every quantized conv's s32 sums
    (im2col + `torch._int_mm`) equal the plain float64 convolution
    exactly; at batch BATCH, with
    dynamic scales and with static scales from 512 calibration frames,
    pred within 1e-2, mask within 3e-2 and hard masks at 0.5 agreeing
    on > 99.5% of pixels against the f32 path (JAX's bounds,
    tests/test_quant.py:84-89); 1 ingest and 5 join launches per batch.
    Returns the launches of the int8 batches."""
    from unittest import mock

    import cgs_tpu_torch.ops.quant as quant
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.pipeline import MaskPipeline

    x, _ = synthetic_eval_set(n_frames=BATCH + 512, seed=9)
    frames, calib = x[:BATCH], x[BATCH:]
    dev = torch.device("cuda")
    frames_dev = torch.from_numpy(frames).to(dev)
    critic, masker = Critic(chfak=5, dropout=0.5), UnetDecoder(chfak=5)
    params = _random_params(critic, masker, seed=40)

    # the s32 sums of every quantized conv at batch 8
    real, sums = quant.conv_s32, []

    def recording(xq, wq, padding):
        y = real(xq, wq, padding)
        sums.append((y, quant.conv_s32_plain(xq, wq, padding)))
        return y

    q8 = MaskPipeline(critic, masker, params, batch_size=8, device="cuda",
                      quantize="int8")
    # 8192 rows a GEMM: the 64 x 64 convs run in chunks of 2 frames
    with mock.patch.object(quant, "conv_s32", recording), \
            mock.patch.object(quant, "MAX_ROWS", 8192):
        q8.run_device(frames_dev[:8])
    check(len(sums) == 12, f"{len(sums)} quantized convs, want 12")
    check(all(torch.equal(a, b) for a, b in sums),
          "int8 conv s32 sums differ from the plain float64 convolution")
    del sums

    f32 = MaskPipeline(critic, masker, params, batch_size=BATCH,
                       device="cuda")
    want = f32.run(frames)
    rows, launches = {}, {}
    for name, kw in (("int8 dynamic", {}), ("int8 static", {"calib": calib})):
        pipe = MaskPipeline(critic, masker, params, batch_size=BATCH,
                            device="cuda", quantize="int8", **kw)
        _build.launches.clear()
        pipe.run_device(frames_dev)
        torch.cuda.synchronize()
        per = dict(_build.launches)
        check(per == {"normalize_u8": 1, "upsample2x": 5},
              f"{name}: launches per batch {per}")
        for k, v in per.items():
            launches[k] = launches.get(k, 0) + v
        got = pipe.run(frames)
        err = {"pred": float(np.abs(got.preds - want.preds).max()),
               "mask": float(np.abs(got.masks - want.masks).max()),
               "hard_agree": float(np.mean((got.masks >= 0.5)
                                           == (want.masks >= 0.5)))}
        check(err["pred"] < 1e-2 and err["mask"] < 3e-2
              and err["hard_agree"] > 0.995,
              f"{name} against f32 at chfak 5: {err}")
        rows[name] = {"vs_f32": err}
        del pipe
    log(f"[int8] chfak 5, batch {BATCH}: 12 quantized convs' s32 sums "
        f"equal the float64 plain version at batch 8; against f32 "
        f"{json.dumps(rows)}; launches per batch 1 + 5")
    del f32, frames_dev
    torch.cuda.empty_cache()
    return launches


def phase_eval(_build) -> None:
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.eval.harness import evaluate, load_eval_set
    from cgs_tpu_torch.handler import Handler
    from cgs_tpu_torch.ops.iou import iou

    cfg = parse_args(["-eval", "-salience", "-synthetic_data",
                      "--chfak", "5", "--model", "chip-smoke"])
    handler = Handler(cfg)
    check(handler.device.type == "cuda", f"handler on {handler.device}")
    x, gt = load_eval_set(cfg)
    check(x.shape == (EVAL_N, 64, 64, 3), f"eval set {x.shape}")
    pipe = handler._pipeline(salience=cfg.salience)
    before = _build.launches["threshold_iou"]
    result = evaluate(cfg, pipe, x, gt, write=False)
    check(_build.launches["threshold_iou"] > before,
          "threshold_iou did not launch in evaluate")
    ious = result["ious"]
    host = iou(result["variants"]["hard"], gt)
    check(ious[0] == host, f"kernel IoU {ious[0]} != host IoU {host}")
    check(len(ious) == 2 and all(0.0 <= v <= 1.0 for v in ious),
          f"ious {ious}")
    check(bool(np.isfinite(result["preds"]).all()), "preds not finite")
    again = evaluate(cfg, pipe, x, gt, write=False)
    check(again["ious"] == ious, f"second evaluate: {again['ious']}")
    log(f"[eval] chfak 5 f32, {EVAL_N} frames: IoU {ious} (host numpy "
        f"IoU {host}), the same on a second evaluate")
    _eval_crf(_build, x, gt)


def _eval_crf(_build, x, gt) -> None:
    """`evaluate` under -crf through a Handler's own CRF: [mask, crf]
    IoUs; the crf variant equals `DenseCRF` of the plain path's masks
    (checked on every 10th frame: frames are refined independently)."""
    from unittest import mock

    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.pipeline as pipeline_mod
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.eval.crf import DenseCRF
    from cgs_tpu_torch.eval.harness import evaluate
    from cgs_tpu_torch.handler import Handler
    from cgs_tpu_torch.ops.kernels import normalize_u8_plain

    cfg = parse_args(["-eval", "-crf", "-synthetic_data", "--chfak", "5",
                      "--model", "chip-smoke"])
    handler = Handler(cfg, primary=False)
    crf_fn = handler._crf_fn()
    check(isinstance(crf_fn, DenseCRF),
          "-crf: the densecrf library did not build or load")
    pipe = handler._pipeline(salience=False)
    check(pipe.wire == "f32", f"-crf eval on the {pipe.wire} wire")
    result = evaluate(cfg, pipe, x, gt, crf_fn=crf_fn, write=False)
    ious = result["ious"]
    check(len(ious) == 2 and all(0.0 <= v <= 1.0 for v in ious),
          f"-crf ious {ious}")
    x_u8 = (x * 255).astype(np.uint8)
    with mock.patch.object(pipeline_mod, "normalize_u8",
                           normalize_u8_plain), \
            mock.patch.object(upsample_mod, "upcat_fwd",
                              upsample_mod.upcat_plain):
        plain = pipe.run(x_u8).masks.squeeze(-1)
    check(np.array_equal(plain, result["variants"]["mask"]),
          "-crf: kernel-path masks differ from the plain path's")
    sub = slice(0, EVAL_N, 10)
    want = DenseCRF()(x_u8[sub], plain[sub])
    check(np.array_equal(want, result["variants"]["crf"][sub]),
          "-crf: the crf variant differs from DenseCRF of the plain "
          "path's masks")
    log(f"[eval] -crf chfak 5 f32, {EVAL_N} frames: IoU [mask, crf] "
        f"{ious}; crf variant equals DenseCRF of the plain path's masks "
        f"({len(want)} frames checked)")


def phase_process() -> None:
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.eval.segment import _mask_variants
    from cgs_tpu_torch.handler import Handler

    cfg = parse_args(["-process", "--chfak", "5", "--model", "chip-smoke",
                      "--seed", "1"])
    handler = Handler(cfg)
    xu8, _ = synthetic_eval_set(n_frames=384, seed=7)
    x = xu8 / 255.0
    thr = cfg.binarymaskthreshold
    red = handler._pipeline(salience=False, wire="u8", hard_threshold=thr)
    full = handler._pipeline(salience=False)
    _, m_u8, png_u8 = _mask_variants(cfg, red, x)
    _, m_f32, png_f32 = _mask_variants(cfg, full, x)
    check(len(png_u8) == len(png_f32) == 2, "expected raw + hard planes")
    soft = m_f32[0]
    np.testing.assert_array_equal(
        png_u8[0], (255 * np.clip(soft, 0, 1)).astype(np.uint8))
    np.testing.assert_array_equal(m_u8[1], (soft >= thr).astype(np.float32))
    for a, b in zip(png_u8, png_f32):
        np.testing.assert_array_equal(a, b)
    log(f"[process] chfak 5, 384 frames: u8 wire and device hard plane "
        f"equal the host-thresholded f32 wire; hard fraction "
        f"{float(m_u8[1].mean()):.4f}")


def phase_ensemble(_build) -> dict:
    """--ensemble 3 through a Handler on random members saved as
    `{model}-seed{s}` runs; returns the launches of its main-path
    `evaluate`."""
    from unittest import mock

    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.pipeline as pipeline_mod
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.eval.harness import evaluate, load_eval_set
    from cgs_tpu_torch.handler import Handler
    from cgs_tpu_torch.ops.kernels import normalize_u8_plain
    from cgs_tpu_torch.pipeline import MaskPipeline
    from cgs_tpu_torch.train.checkpoints import (
        checkpoint_paths, save_model_pt,
    )

    argv = ["-eval", "--ensemble", str(ENSEMBLE_R), "-synthetic_data",
            "--chfak", "5", "--model", "chip-smoke-ens"]
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            cfg = parse_args(argv)
            handler = Handler(cfg, primary=False)
            members = [_random_params(handler.critic, handler.masker,
                                      seed=10 + s)
                       for s in range(ENSEMBLE_R)]
            for s, member in enumerate(members):
                paths = checkpoint_paths(parse_args(
                    argv + ["--model", f"chip-smoke-ens-seed{s}"]))
                for name, state in member.items():
                    save_model_pt(state, name, paths[name])
            pipe = handler._pipeline(salience=cfg.salience)
        finally:
            os.chdir(old)
    check(pipe.ensemble and len(pipe._members) == ENSEMBLE_R,
          "the Handler did not build a 3-member ensemble")
    x, gt = load_eval_set(cfg)
    torch.cuda.synchronize()
    _build.launches.clear()                 # ensemble main path starts
    result = evaluate(cfg, pipe, x, gt, write=False)
    torch.cuda.synchronize()
    launches = dict(_build.launches)        # ensemble main path ends
    check(launches == ENSEMBLE_LAUNCHES,
          f"ensemble evaluate launched {launches}, want "
          f"{ENSEMBLE_LAUNCHES}")
    mask = result["variants"]["mask"]
    x_u8 = (x * 255).astype(np.uint8)
    with mock.patch.object(pipeline_mod, "normalize_u8",
                           normalize_u8_plain), \
            mock.patch.object(upsample_mod, "upcat_fwd",
                              upsample_mod.upcat_plain):
        plain = pipe.run(x_u8).masks.squeeze(-1)
    check(np.array_equal(mask, plain),
          "ensemble: kernel-path masks differ from the plain path's")
    singles = [MaskPipeline(handler.critic, handler.masker, m,
                            batch_size=BATCH, device="cuda")
               for m in members]
    mean = sum(p.run(x_u8).masks.squeeze(-1) for p in singles) / ENSEMBLE_R
    d = float(np.abs(mean - mask).max())
    check(d <= 1e-6, f"ensemble mask differs from the mean of the "
          f"single-member pipelines by {d}")
    ious = result["ious"]
    check(len(ious) == 1 and 0.0 <= ious[0] <= 1.0, f"ious {ious}")

    log(f"[ensemble] chfak 5 f32, R={ENSEMBLE_R}, {EVAL_N} frames: IoU "
        f"{ious}; launches {launches}; masks bit-equal to the plain path, "
        f"max |diff| to the mean of {ENSEMBLE_R} single pipelines {d:.3g}")
    del pipe, singles
    torch.cuda.empty_cache()
    return launches


def phase_profile(_build) -> dict:
    """`-eval --profile DIR` through the CLI, writing no file but the
    trace; the trace must name the port's device kernels. Returns the
    launches of the run."""
    from cgs_tpu_torch import cli

    old = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            _build.launches.clear()         # profile main path starts
            handler = cli.main(["-eval", "-synthetic_data", "--chfak",
                                "5", "--model", "chip-smoke-prof",
                                "--profile", os.path.join(d, "trace")],
                               primary=False)
            launches = dict(_build.launches)  # ... and ends
            path = handler.profiler.path
            check(path is not None and os.path.isfile(path),
                  f"--profile wrote no trace ({path})")
            size = os.path.getsize(path)
            with open(path) as fp:
                events = json.load(fp)["traceEvents"]
        finally:
            os.chdir(old)
    kernels = {e.get("name", "") for e in events
               if e.get("cat") == "kernel"}
    for want in TRACE_KERNELS:
        check(any(want in k for k in kernels),
              f"--profile trace names no {want}* kernel")
    log(f"[profile] -eval --profile: one trace of {size} bytes, "
        f"{len(events)} events, {len(kernels)} distinct device kernels, "
        f"the port's: "
        f"{sorted(k[:60] for k in kernels if any(w in k for w in TRACE_KERNELS))}"
        f"; IoU {handler.last_ious}")
    return launches


def _frame_count(path) -> int:
    import cv2
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


def phase_video(_build) -> dict:
    """Video-file `-process` and `-vismasker` through the CLI, writing
    their videos (cv2, PIL) in a temporary directory. Returns the
    launches of the two runs."""
    from cgs_tpu_torch import cli
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.utils.video import vidwrite

    old = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            frames, _ = synthetic_eval_set(n_frames=48, seed=3)
            # 128x128, so load_video resizes
            vidwrite("clip.mp4", frames.repeat(2, 1).repeat(2, 2),
                     framerate=16)
            _build.launches.clear()         # video main path starts
            cli.main(["-process", "--source-imgs", "clip.mp4",
                      "--mask-output-imgs", "out", "--chfak", "5",
                      "--model", "chip-smoke-video"])
            cli.main(["-vismasker", "-synthetic_data", "--datasize", "600",
                      "--testsize", "64", "--chfak", "5", "--visname",
                      "cv", "--model", "chip-smoke-vis"])
            launches = dict(_build.launches)  # ... and ends
            masks = {n: _frame_count(Path("out") / n)
                     for n in sorted(os.listdir("out"))}
            curves = {n: _frame_count(Path("chip-smoke-vis") / n)
                      for n in sorted(os.listdir("chip-smoke-vis"))
                      if n.endswith(".mp4")}
        finally:
            os.chdir(old)
    check(masks == {"clip-raw-mask.mp4": 48,
                    "clip-thresholded-mask.mp4": 48},
          f"video -process wrote {masks}")
    check(curves == {"cv.mp4": 64, "cv-pred-sorted.mp4": 64,
                     "cv-GT-sorted.mp4": 64},
          f"-vismasker wrote {curves}")
    log(f"[video] chfak 5: -process on a 48-frame 128x128 mp4 wrote "
        f"{masks}; -vismasker wrote {curves}")
    return launches


def phase_zoo(_build) -> dict:
    """The zoo's main path: `models/zoo.py:Unet` at chfak 5 (40/40/40/80
    encoder, bottleneck 32), seeded torch-default weights, f32, TF32 off,
    deterministic cuDNN. One `make_pair_merge_step` (live, l1 0.1,
    inject) over A = ZOO_N synthetic frames and ZOO_N negatives through
    the kernels and through their plain versions: the loss terms and
    every gradient bit-equal, every decoder gradient non-zero, the
    launches ZOO_STEP_LAUNCHES. Then the main path itself, with the
    launch counts cleared before and read after: ZOO_STEPS Adam pair
    steps with finite losses, a `sum_segm` chunk over the frames as a
    uint8 bank,
    and `unet_embeddings.project_embeddings` (the U-Net's embeds, the
    PCA on the card). Returns the launches."""
    import cgs_tpu_torch.sandbox.merge_variants as mv
    import cgs_tpu_torch.sandbox.sum_segm as ss
    import cgs_tpu_torch.sandbox.unet_embeddings as ue
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.models.zoo import Unet
    from cgs_tpu_torch.ops.kernels import normalize_u8

    frames, _ = synthetic_eval_set(n_frames=2 * ZOO_N, seed=7)
    bank = torch.from_numpy(frames).cuda()
    x = normalize_u8(bank).permute(0, 3, 1, 2)      # NCHW channels_last
    a, b = x[:ZOO_N], x[ZOO_N:]
    y = torch.rand(ZOO_N, device="cuda",
                   generator=torch.Generator(device="cuda").manual_seed(8))
    torch.manual_seed(40)
    unet = Unet(chfak=5).to("cuda", memory_format=torch.channels_last)
    state0 = {k: v.clone() for k, v in unet.state_dict().items()}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        def one_step(kernels: bool):
            unet.load_state_dict(state0)
            opt = torch.optim.SGD(unet.parameters(), lr=0.0)
            step = mv.make_pair_merge_step(unet, opt, l1=0.1, live=True)
            _build.launches.clear()
            if kernels:
                terms = step(a, y, b)
            else:
                with _plain_kernels():
                    terms = step(a, y, b)
            torch.cuda.synchronize()
            return ({k: float(v) for k, v in terms.items()},
                    {k: p.grad.detach().clone()
                     for k, p in unet.named_parameters()},
                    dict(_build.launches))

        k_terms, k_grads, k_launches = one_step(True)
        p_terms, p_grads, p_launches = one_step(False)
        check(k_launches == ZOO_STEP_LAUNCHES,
              f"zoo pair step launched {k_launches}, want "
              f"{ZOO_STEP_LAUNCHES}")
        check(p_launches == {}, f"zoo plain path launched {p_launches}")
        check(k_terms == p_terms, f"zoo pair step terms: kernel path "
              f"{k_terms} != plain path {p_terms}")
        for k, g in k_grads.items():
            check(torch.equal(_bits(g), _bits(p_grads[k])),
                  f"zoo pair step gradient {k} differs between the kernel "
                  "and plain paths")
            if k.startswith("dec"):
                check(float(g.abs().max()) > 0, f"zoo decoder gradient {k} "
                      "is zero")

        # the zoo main path
        unet.load_state_dict(state0)
        opt = torch.optim.Adam(unet.parameters(), lr=2e-4)
        step = mv.make_pair_merge_step(unet, opt, l1=0.1, live=True)
        _build.launches.clear()
        losses = torch.stack([step(a, y, b)["loss"]
                              for _ in range(ZOO_STEPS)]).cpu().numpy()
        check(np.isfinite(losses).all(), f"zoo pair losses {losses}")
        chunk = ss.make_sum_segm_chunk(unet, torch.optim.Adam(
            unet.parameters(), lr=1e-3))
        s_steps, s_batch = ZOO_SUM_SEGM
        idx = torch.randint(0, bank.shape[0], (s_steps, s_batch),
                            device="cuda", generator=torch.Generator(
                                device="cuda").manual_seed(9))
        ss_losses = chunk(bank, idx).cpu().numpy()
        check(np.isfinite(ss_losses).all(), f"sum_segm losses {ss_losses}")
        proj = ue.project_embeddings(
            unet, frames[:10].astype(np.float32),
            frames[10:12].astype(np.float32),
            np.random.default_rng(10).integers(0, 3, (2, 64, 64)))
        torch.cuda.synchronize()
        launches = dict(_build.launches)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    std = proj["standard"]
    check(std.shape == (10 * 32 * 32, 2) and np.isfinite(std).all(),
          f"unet_embeddings projection {std.shape}")
    log(f"[zoo] one chfak-5 zoo.Unet pair step (A {ZOO_N} + B {ZOO_N}, "
        f"live, inject, l1 0.1): terms and all {len(k_grads)} gradients "
        f"bit-equal between the kernel and plain paths, every decoder "
        f"gradient non-zero, launches {k_launches}")
    log(f"[zoo] {ZOO_STEPS} Adam pair steps, loss {losses[0]:.4f} -> "
        f"{losses[-1]:.4f}; sum_segm chunk {s_steps} x {s_batch} losses "
        f"{np.round(ss_losses, 1).tolist()}; unet_embeddings projection "
        f"{std.shape} of {proj['mask'].shape[0]} frames; main-path "
        f"launches {launches}")
    return launches


def _train_models(dtype, seed: int, chfak: int = 5, dropout: float = 0.5):
    """Train-mode critic and masker (chfak 5 unless asked) on the card,
    random weights."""
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    critic = Critic(chfak=chfak, dropout=dropout, compute_dtype=dtype)
    masker = UnetDecoder(chfak=chfak, compute_dtype=dtype)
    params = _random_params(critic, masker, seed)
    out = {}
    for name, template in (("critic", critic), ("masker", masker)):
        m = copy.deepcopy(template).to("cuda",
                                       memory_format=torch.channels_last)
        m.load_state_dict(params[name])
        out[name] = m.train()
    return out


def _plain_kernels():
    """A context in which a train step, or `MaskPipeline`, runs every
    port kernel's plain version (the ingest, the merges and their
    gradient, the fused upsample-into-concat pair, the convolution
    epilogue, the mask heads) on the card."""
    import contextlib
    from unittest import mock

    import cgs_tpu_torch.models.epilogue as epilogue_mod
    import cgs_tpu_torch.ops.merge as merge_mod
    import cgs_tpu_torch.ops.upsample as upsample_mod
    import cgs_tpu_torch.pipeline as pipeline_mod
    import cgs_tpu_torch.train.losses as losses_mod
    from cgs_tpu_torch.ops.kernels import (
        bias_act_pool_plain, conv_mask_head_plain, gather_normalize_u8_plain,
        mask_head_plain, merge_pair_bwd_plain, merge_pair_plain,
        normalize_u8_plain,
    )
    stack = contextlib.ExitStack()
    for mod, name, plain in (
            (epilogue_mod, "bias_act_pool", bias_act_pool_plain),
            (epilogue_mod, "conv_mask_head_op", conv_mask_head_plain),
            (epilogue_mod, "mask_head", mask_head_plain),
            (losses_mod, "gather_normalize_u8", gather_normalize_u8_plain),
            (pipeline_mod, "normalize_u8", normalize_u8_plain),
            (merge_mod, "merge_pair", merge_pair_plain),
            (merge_mod, "merge_pair_bwd", merge_pair_bwd_plain),
            (upsample_mod, "upcat_fwd", upsample_mod.upcat_plain),
            (upsample_mod, "upcat_bwd", upsample_mod.upcat_bwd_plain)):
        stack.enter_context(mock.patch.object(mod, name, plain))
    return stack


def _deterministic(fn):
    """fn() with cuDNN deterministic, the flag restored after."""
    before = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        return fn()
    finally:
        torch.backends.cudnn.deterministic = before


def _pipeline_vs_plain(_build, pipe, frames) -> dict:
    """`pipe.run_device(frames)` on the kernel path and on the plain
    path (deterministic cuDNN): predictions bit-equal, the plain path
    launching nothing; the mask head's kernel sums in another order than
    cuDNN, so its masks are held to twice the plain path's worst gap to
    the head evaluated in float64 on the same inputs. Returns the kernel
    path's launches."""
    from unittest import mock

    import cgs_tpu_torch.models.epilogue as epilogue_mod
    from cgs_tpu_torch.ops.kernels import (
        conv_mask_head, conv_mask_head_plain, mask_head, mask_head_plain,
    )

    heads = []           # (the head's plain version, its inputs)

    def spy(kernel, plain):
        def run(*args):
            heads.append((plain, args))
            return kernel(*args)
        return run

    def run(kernels: bool):
        _build.launches.clear()
        if kernels:
            whole = spy(conv_mask_head, conv_mask_head_plain)
            with mock.patch.object(epilogue_mod, "conv_mask_head_op",
                                   whole), \
                    mock.patch.object(epilogue_mod, "mask_head",
                                      spy(mask_head, mask_head_plain)):
                pred, mask, _ = pipe.run_device(frames)
        else:
            with _plain_kernels():
                pred, mask, _ = pipe.run_device(frames)
        torch.cuda.synchronize()
        return pred, mask, dict(_build.launches)

    pred, mask, launches = _deterministic(lambda: run(True))
    ppred, pmask, plain = _deterministic(lambda: run(False))
    check(not plain, f"plain path launched {plain}")
    check(torch.equal(_bits(pred), _bits(ppred)),
          f"MaskPipeline batch {len(frames)}: kernel path vs plain path "
          f"preds {float((pred - ppred).abs().max()):.3g} apart")
    check(len(heads) == 1, f"MaskPipeline batch {len(frames)}: "
          f"{len(heads)} mask head calls")
    plain, (x, *rest) = heads[0]
    # the head in float64 a slice of frames at a time: a whole batch's
    # join in float64 would not fit beside the pipeline (18 GB at C = 67)
    rest = [a.double() if torch.is_tensor(a) else a for a in rest]
    exact = torch.cat([plain(x[lo:lo + 1024].double(), *rest)
                       for lo in range(0, len(x), 1024)])[..., None]
    gap, plain_gap = (float((m.double() - exact).abs().max())
                      for m in (mask, pmask))
    check(gap <= 2 * plain_gap,
          f"MaskPipeline batch {len(frames)}: the mask head's kernel "
          f"{gap:.3g} from float64, the plain path {plain_gap:.3g}")
    return launches


def _steps_vs_plain(_build, cfg, models, critic_rows: int, fuses) -> dict:
    """One critic step (`critic_rows` labelled frames; none at 0) and one
    masker step (K = MASKER_N / 2 high and low frames, 2K negatives) for
    each fuse mode in `fuses`, of `models` on the card, kernel path against
    plain path: loss terms and every gradient bit-equal (deterministic
    cuDNN; SGD at lr 0 keeps the weights; every run draws from the
    same seeded StepRng), the plain path launching nothing, the kernel
    path every kernel of its step. Returns each step's launches."""
    from cgs_tpu_torch.ops.kernels import Segment
    from cgs_tpu_torch.train.steps import StepRng, critic_step, masker_step

    dev = torch.device("cuda")
    banks = _step_banks(torch.Generator(device=dev).manual_seed(8), n=256)
    segs = _step_segments(banks, 0)
    crit = Segment(banks[0], banks[6][:critic_rows], 0, banks[1])
    opt = torch.optim.SGD([p for m in models.values()
                           for p in m.parameters()], lr=0.0)
    steps = {}
    if critic_rows:
        steps["critic"] = (("normalize_u8",), lambda rng: (critic_step(
            cfg, models["critic"], opt, crit, rng),))
    for fuse in fuses:
        steps[f"masker fuse {fuse}"] = (
            tuple(STEP_LAUNCHES), lambda rng, fuse=fuse: masker_step(
                cfg, models, opt, segs[:2], segs[2], rng, fuse=fuse))

    def run(step, kernels: bool):
        _build.launches.clear()
        if kernels:
            out = step(StepRng.seeded(0, dev))
        else:
            with _plain_kernels():
                out = step(StepRng.seeded(0, dev))
        torch.cuda.synchronize()
        return ([float(v) for v in out],
                {f"{n}.{k}": p.grad.detach().clone()
                 for n, m in models.items()
                 for k, p in m.named_parameters() if p.grad is not None},
                dict(_build.launches))

    launched = {}
    for name, (kernels, step) in steps.items():
        k_terms, k_grads, launched[name] = _deterministic(
            lambda: run(step, True))
        p_terms, p_grads, plain = _deterministic(lambda: run(step, False))
        check(not plain, f"{name} step: the plain path launched {plain}")
        check(all(launched[name].get(k, 0) > 0 for k in kernels),
              f"{name} step launched {launched[name]}, want each of "
              f"{kernels}")
        check(all(np.isfinite(k_terms)) and k_grads
              and k_grads.keys() == p_grads.keys(),
              f"{name} step: terms {k_terms}, {len(k_grads)} gradients")
        check(k_terms == p_terms and all(
            torch.equal(_bits(k_grads[k]), _bits(p_grads[k]))
            for k in k_grads),
            f"{name} step: kernel path vs plain path terms {k_terms} / "
            f"{p_terms}, grads " + str(max(float(
                (k_grads[k] - p_grads[k]).abs().max()) for k in k_grads)))
    return launched


def phase_train(seed: int) -> None:
    """The paper's synthetic protocol, -frozen, at chfak 5, through the
    N-seed runner and the CLI, writing no files but the runner's
    `results.txt` line (in a temporary directory)."""
    from cgs_tpu_torch.sandbox.multirun import run_seeds

    old = os.getcwd()
    seen = {}
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            summary = run_seeds(
                PROTOCOL, 1, results_path="results.txt", base_seed=seed,
                primary=False,
                on_seed=lambda s, h: seen.update(seed=s, handler=h))
            with open("results.txt") as fp:
                line = fp.read()
            files = sorted(os.listdir(d))
        finally:
            os.chdir(old)
    handler = seen["handler"]
    check(seen["seed"] == seed and files == ["results.txt"],
          f"run_seeds ran seed {seen['seed']} and left {files}")
    check(line.startswith(f"runs=1 args={' '.join(PROTOCOL)} ious=[")
          and summary["ious"] == handler.last_ious[:1],
          f"results.txt line {line!r}, summary {summary}")
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
        f"results.txt: {line.strip()!r}")
    check(iou >= MIN_IOU, f"seed {seed}: eval IoU {iou} < {MIN_IOU}")


def phase_train_primary(_build) -> dict:
    """`-train -eval` as a user runs it: `cli.main(PRIMARY_ARGV)` with
    primary=True, in a temporary directory, at chfak 1 and a small size.
    Both phases' `_loss.png` and the two contrastive histograms must be
    valid PNGs (drawn by matplotlib where it is installed, else by PIL),
    beside the two checkpoints. Then, outside the counted run, one critic
    step at its batch and one masker step (K = 32) at chfak 1, kernel
    path against plain path. Returns the launches of the run."""
    from PIL import Image

    from cgs_tpu_torch import cli
    from cgs_tpu_torch.core.config import parse_args

    try:
        import matplotlib                                # noqa: F401
        drawer = "matplotlib"
    except ImportError:
        drawer = "PIL (matplotlib absent)"
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            _build.launches.clear()         # the main path starts
            handler = cli.main(PRIMARY_ARGV, primary=True)
            launches = dict(_build.launches)    # ... and ends
            run = Path(d) / "chip-smoke-primary"
            sizes = {}
            for art in PRIMARY_PNGS:
                with Image.open(run / art) as img:
                    img.load()              # decodes: a broken PNG raises
                    sizes[art] = img.size
            saves = sorted(p.name.split("-")[0]
                           for p in (run / "saves").glob("*.pt"))
        finally:
            os.chdir(old)
    check(saves == ["critic", "masker"], f"checkpoints written: {saves}")
    iou = handler.last_ious
    check(len(iou) == 1 and 0.0 <= iou[0] <= 1.0, f"eval IoU {iou}")
    log(f"[train-primary] -train -eval primary=True at chfak 1 (1100 "
        f"frames, critic 6 / masker 1 epochs): figures by {drawer}, "
        f"{json.dumps(sizes)}; eval IoU {iou}; launches {launches}")
    cfg = parse_args(PRIMARY_ARGV)
    steps = _steps_vs_plain(
        _build, cfg, _train_models(torch.float32, seed=9, chfak=cfg.chfak,
                                   dropout=cfg.dropout),
        cfg.batch_size, ("both",))
    log(f"[train-primary] chfak {cfg.chfak} critic step (batch "
        f"{cfg.batch_size}) and masker step (K = {MASKER_N // 2}): kernel "
        f"path bit-equal to plain path; launches {json.dumps(steps)}")
    return launches


def phase_swin(_build) -> dict:
    """The `--critic swin_v2_t` pair through `-train -eval`, `-process`
    and the HTTP server, and its train steps against their plain path
    (module docstring); returns the launches of the primary `-train
    -eval` run."""
    import urllib.request

    from PIL import Image

    from cgs_tpu_torch import cli
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.models.build import build_pair
    from cgs_tpu_torch.models.swin import SwinV2Critic
    from cgs_tpu_torch.serve import MaskServer
    from cgs_tpu_torch.train.steps import set_masker_modes
    from cgs_tpu_torch.utils.profiling import counts

    old = os.getcwd()
    frames, _ = synthetic_eval_set(n_frames=8, seed=11)     # uint8 NHWC
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            attns = counts["model.window_attns"]
            _build.launches.clear()         # the main path starts
            handler = cli.main(SWIN_ARGV, primary=True)
            launches = dict(_build.launches)    # ... and ends
            check(isinstance(handler.critic, SwinV2Critic),
                  f"--critic swin_v2_t built {type(handler.critic)}")
            n_attn = counts["model.window_attns"] - attns
            check(n_attn > 0 and n_attn % 12 == 0,
                  f"model.window_attns moved by {n_attn}")
            saves = sorted(p.name for p in
                           (Path(d) / "chip-smoke-swin" / "saves")
                           .glob("*.pt"))
            check(len(saves) == 2 and all(n.endswith("-critic=swin_v2_t.pt")
                                          or n.startswith("masker")
                                          for n in saves),
                  f"checkpoints written: {saves}")
            iou = handler.last_ious
            check(len(iou) == 1 and 0.0 <= iou[0] <= 1.0, f"eval IoU {iou}")
            for name in ("critic", "masker"):
                loss = handler.loss_log[name]
                check(loss.size > 0 and bool(np.isfinite(loss).all()),
                      f"{name} losses {loss.shape}")
            frozen = cli.main(SWIN_ARGV[:-1] + ["chip-smoke-swin-frozen",
                                                "-frozen"], primary=False)
            check(bool(np.isfinite(frozen.loss_log["masker"]).all())
                  and 0.0 <= frozen.last_ious[0] <= 1.0,
                  f"-frozen: IoU {frozen.last_ious}")

            src, out = Path(d) / "src", Path(d) / "out"
            src.mkdir()
            for i, f in enumerate(frames):
                Image.fromarray(f).save(src / f"img{i:03d}.png")
            # the run's flags name its checkpoints
            run = [a for a in SWIN_ARGV if a not in ("-train", "-eval")]
            proc = cli.main(run + ["-cload", "1", "-mload", "1",
                                   "-process", "--source-imgs", str(src),
                                   "--mask-output-imgs", str(out)],
                            primary=True)
            pipe = proc._pipeline(salience=False)
            soft = pipe.run(frames).masks[..., 0]
            for i in range(len(frames)):
                raw = np.asarray(Image.open(out / f"img{i:03d}-raw-mask.png"))
                _same_png(raw[..., 0].astype(np.int16),
                          (255 * np.clip(soft[i], 0, 1)).astype(np.int16))
                check((out / f"img{i:03d}-thresholded-mask.png").is_file(),
                      f"no hard mask for frame {i}: {sorted(out.iterdir())}")

            srv = MaskServer(parse_args(run + ["--infer-batch", "4"]))
            try:
                base, _ = _http(srv)
                for i, f in enumerate(frames):
                    got = _levels(_post(f"{base}/segment", _png(f)))
                    _same_png(got if got.ndim == 2 else got[..., 0],
                              (255 * np.clip(soft[i], 0, 1)
                               ).astype(np.int16))
                stats = json.loads(urllib.request.urlopen(
                    f"{base}/stats", timeout=30).read())
                check(stats["frames"] == len(frames), f"/stats {stats}")
            finally:
                srv.shutdown()
        finally:
            os.chdir(old)
    dev_frames = torch.from_numpy(frames).cuda()
    ops = {}
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        pipe.run_device(dev_frames)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ops[e.key] = e.count
    attn = sum(n for k, n in ops.items() if "fmha_cutlassF" in k)
    check(attn == 12 and not [k for k in ops if "softmax" in k.lower()],
          f"eval forward: {attn} fmha_cutlassF launches, ops {ops}")
    log(f"[swin] -train -eval (critic live in the masker phase) IoU {iou}, "
        f"-frozen IoU {frozen.last_ious}; -process and the server on its "
        f"checkpoints within one level of MaskPipeline.run ({len(frames)} "
        f"frames); the eval forward: 12 fmha_cutlassF launches, no "
        f"softmax; launches {launches}")

    critic, masker = build_pair(parse_args(SWIN_ARGV))
    params = _random_params(critic, masker, 23)
    models = {}
    for name, m in (("critic", critic), ("masker", masker)):
        m = m.to("cuda", memory_format=torch.channels_last)
        m.load_state_dict(params[name])
        models[name] = m
    steps = {}
    for mode, flags in (("live", []), ("frozen", ["-frozen"])):
        cfg = parse_args(SWIN_ARGV + flags)
        set_masker_modes(cfg, models)
        got = _steps_vs_plain(_build, cfg, models,
                              cfg.batch_size if cfg.live else 0, ("both",))
        steps.update({f"{mode} {k}": v for k, v in got.items()})
    del models, critic, masker
    torch.cuda.empty_cache()
    log(f"[swin] critic step (batch {parse_args(SWIN_ARGV).batch_size}) "
        f"and masker step (K = {MASKER_N // 2}) with the critic live, "
        f"masker step with it frozen: kernel path bit-equal to plain "
        f"path; launches {json.dumps(steps)}")
    return launches


def phase_cluster() -> None:
    """The sandbox clustering at realistic size: `cluster_frames` (per-
    pixel HSV KMeans) over KMEANS_FRAMES synthetic frames (4096 pixels
    each, K = 20, 25 iterations) on the card and on the CPU from the
    same initial indices: labels equal on >= 99.9% of pixels, centroids
    within 1e-4, the same target cluster. Then
    `create_patch_embedding_clusters` at the reference config (700 + 700
    frames, embed_dim 100, 100 clusters, pw 10, stride 2) on the card:
    every raw patch histogram sums to pw^2 = 100, tree-prob column 2
    peaks at 1, and the 7-tuple round-trips."""
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.sandbox import cluster
    from cgs_tpu_torch.sandbox.patch_embed import (
        PatchEmbedder, create_patch_embedding_clusters,
    )

    x, gt = synthetic_eval_set(n_frames=KMEANS_FRAMES, seed=7)
    y = gt.any(axis=(1, 2)).astype(np.float64)
    init = torch.randperm(x[..., 0].size,
                          generator=torch.Generator().manual_seed(0))
    init = init[:KMEANS_K].numpy()
    res = {dev: cluster.cluster_frames(x, y, KMEANS_K, iters=KMEANS_ITERS,
                                       init_idx=init, device=dev)
           for dev in ("cuda", "cpu")}
    agree = float((res["cuda"]["labels"] == res["cpu"]["labels"]).mean())
    gap = float(np.abs(res["cuda"]["centroids"]
                       - res["cpu"]["centroids"]).max())
    check(agree >= KMEANS_AGREE, f"kmeans card vs CPU: labels equal on "
          f"{agree:.6f} of pixels")
    check(gap <= KMEANS_TOL, f"kmeans card vs CPU: centroids {gap:.3g} apart")
    check(res["cuda"]["target"] == res["cpu"]["target"],
          f"target cluster {res['cuda']['target']} on the card, "
          f"{res['cpu']['target']} on the CPU")
    log(f"[cluster] cluster_frames {KMEANS_FRAMES} frames "
        f"({x[..., 0].size} pixels), K = {KMEANS_K}, {KMEANS_ITERS} "
        f"iterations, card against CPU: labels equal on {agree:.6f}, "
        f"centroids {gap:.3g} apart, target {res['cuda']['target']}")

    hsv = cluster.rgb_to_hsv(torch.from_numpy(x).float() / 255.0).numpy()
    has = y > 0
    check(has.sum() > 0 and (~has).sum() > 0,
          f"{int(has.sum())} frames with the object, {int((~has).sum())} "
          "without")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "embed.pickle")
        emb = create_patch_embedding_clusters(
            hsv[has], y[has], hsv[~has], np.zeros(int((~has).sum())), path,
            device="cuda", **EMBED_CFG)
        sub = hsv[:256]
        flat, pshape = emb.embed_batch(sub)
        check(pshape == (len(sub), 28, 28, 100) and bool(
            (flat.sum(-1) == EMBED_CFG["patch_width"] ** 2).all()),
            f"patch histograms {pshape}: sums {np.unique(flat.sum(-1))}")
        probs = emb.patch_embed_cluster_tree_probs
        check(probs.shape == (100, 4) and np.isclose(probs[:, 2].max(), 1.0)
              and bool(np.isfinite(probs).all()),
              f"tree-prob table {probs.shape}, column 2 max "
              f"{probs[:, 2].max()}")
        p1, l1 = emb.predict_batch(sub)
        back = PatchEmbedder(device="cuda").load_embed_tuple(path)
        p2, l2 = back.predict_batch(sub)
        check(back.n_cluster == 100 and np.array_equal(l1, l2)
              and np.array_equal(p1, p2), "the 7-tuple does not round-trip")
    log(f"[cluster] create_patch_embedding_clusters 700 + 700 frames, "
        f"embed_dim 100, 100 clusters, pw 10, stride 2, on the card: "
        f"histograms sum to 100; tree-prob column 2 max 1; the 7-tuple "
        f"round-trips")


def phase_bench_width(_build) -> dict:
    """`sandbox/bench_width.py` at chfak 5: `main(BENCH_WIDTH_ARGV)`
    (inference f32 / bf16 at its auto batch), then its `bench_training`
    at BENCH_WIDTH_STEPS x BENCH_WIDTH_ROUNDS (critic and masker chunks
    f32 / bf16, the masker chunk at fuse none / merges); every line
    finite and positive (the lines it prints are its timings, and are
    not shown). Then, outside the counted run, the kernels at
    this path's and the cells' shapes, kernel path against plain path,
    bit-equal: `MaskPipeline.run_device` at the auto batch and at the
    serve batch (BATCH, the process cells' batch) in f32 and bf16, the
    chfak 1 pair at BATCH in f32, the
    resnet18, convnext_t and swin_v2_t pairs (`build_pair`, eval mode)
    at BATCH in f32 with their launches a batch (ARCH_LAUNCHES), and one
    critic step
    (batch 64) and one masker step (K = 32) at fuse both (the masker
    cell's step), none and merges, on the sweep's models; the
    pipelines' masks within twice the plain path's gap to float64
    (`_pipeline_vs_plain`). Returns the launches of the sweep."""
    import contextlib
    import importlib
    import io

    from cgs_tpu_torch.pipeline import MaskPipeline

    bench_width = importlib.import_module(
        "cgs_tpu_torch.sandbox.bench_width")
    chunks = dict(steps=BENCH_WIDTH_STEPS, rounds=BENCH_WIDTH_ROUNDS)
    _build.launches.clear()             # the main path starts
    with contextlib.redirect_stdout(io.StringIO()):
        results = bench_width.main(BENCH_WIDTH_ARGV)
        for bf16 in (False, True):
            results += bench_width.bench_training(5, 0.5, bf16, **chunks)
        for fuse in ("none", "merges"):
            results += bench_width.bench_training(
                5, 0.5, False, fuse=fuse, phases=("masker",), **chunks)
    launches = dict(_build.launches)    # ... and ends
    check(len(results) == 8 and all(
        np.isfinite(r["value"]) and r["value"] > 0 for r in results),
        f"bench_width results {results}")
    log(f"[bench-width] {[r['metric'] for r in results]}: finite and "
        f"positive; launches {launches}")

    dev = torch.device("cuda")
    batches = sorted({results[0]["batch"], BATCH})
    frames = torch.randint(0, 256, (batches[-1], 64, 64, 3),
                           dtype=torch.uint8, device=dev,
                           generator=torch.Generator(device=dev)
                           .manual_seed(0))
    checked = {}
    for dtype in (torch.float32, torch.bfloat16):
        critic, masker = bench_width._models(5, 0.5, dtype, dev, train=False)
        for batch in batches:
            pipe = MaskPipeline(critic, masker,
                                {"critic": critic.state_dict(),
                                 "masker": masker.state_dict()},
                                batch_size=batch, device=dev)
            checked[f"MaskPipeline {_name(dtype)} batch {batch}"] = (
                _pipeline_vs_plain(_build, pipe, frames[:batch]))
            del pipe
    # the chfak1.process cell's pair, its join 11 channels wide
    critic, masker = bench_width._models(1, 0.3, torch.float32, dev,
                                         train=False)
    pipe = MaskPipeline(critic, masker, {"critic": critic.state_dict(),
                                         "masker": masker.state_dict()},
                        batch_size=BATCH, device=dev)
    checked[f"MaskPipeline chfak 1 float32 batch {BATCH}"] = (
        _pipeline_vs_plain(_build, pipe, frames[:BATCH]))
    del pipe, critic, masker
    torch.cuda.empty_cache()
    for arch in ("resnet18", "convnext_t", "swin_v2_t"):
        pipe = _arch_pipeline(arch, dev)
        got = _pipeline_vs_plain(_build, pipe, frames[:BATCH])
        check(got == ARCH_LAUNCHES,
              f"--critic {arch} batch {BATCH}: launches {got}, "
              f"expected {ARCH_LAUNCHES}")
        checked[f"MaskPipeline {arch} float32 batch {BATCH}"] = got
        del pipe
        torch.cuda.empty_cache()
    critic, masker = bench_width._models(5, 0.5, torch.float32, dev,
                                         train=True)
    checked.update(_steps_vs_plain(
        _build, bench_width._train_config(5, 0.5),
        {"critic": critic, "masker": masker}, 64,
        ("both", "none", "merges")))
    torch.cuda.empty_cache()
    log(f"[bench-width] chfak 5, kernel path against plain path: "
        f"{json.dumps(checked)}")
    return launches


def _arch_pipeline(arch: str, dev):
    """An f32 `MaskPipeline` at BATCH on `build_pair`'s `--critic arch`
    pair in eval mode, random weights; ConvNeXt-T's layer scales and
    block LayerNorm weights drawn from U(0.5, 1.5), as the process cell's
    are (at the published 1e-6 every block is an identity); Swin V2-T's
    post-norms keep weight 1 and its temperatures log 10."""
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.build import build_pair
    from cgs_tpu_torch.pipeline import MaskPipeline

    critic, masker = build_pair(Config(critic_arch=arch).derive())
    params = _random_params(critic, masker, 21)
    gen = torch.Generator().manual_seed(22)
    for k, t in params["critic"].items():
        if k.endswith("layer_scale") or (".block.2." in k
                                         and k.endswith("weight")):
            t.uniform_(0.5, 1.5, generator=gen)
    critic.eval()
    masker.eval()
    return MaskPipeline(critic, masker, params, batch_size=BATCH,
                        device=dev)


def _seeded_models(seeds, dropout: float, dtype=torch.float32):
    """Train-mode chfak-5 seeded critic and decoder on the card holding
    the given seeds' default-init weights, and those weights (CPU)."""
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.models.seeded import SeededCritic, SeededDecoder
    from cgs_tpu_torch.sandbox.seed_parallel import (
        _on_device, init_seed_params,
    )
    r = len(seeds)
    init = init_seed_params(Critic(chfak=5), UnetDecoder(chfak=5), seeds)
    return {"critic": _on_device(
        SeededCritic(r, chfak=5, dropout=dropout, compute_dtype=dtype),
        init["critic"], "cuda"),
        "masker": _on_device(SeededDecoder(r, chfak=5, compute_dtype=dtype),
                             init["masker"], "cuda")}, init


def _seeded_indices(gen, r: int, n: int, s: int = 1):
    """(R, S, 2K) A rows, (R, S, 2K) B rows into a bank of n frames."""
    return (torch.randint(0, n, (r, s, 2 * MASKER_N // 2), device="cuda",
                          generator=gen),
            torch.randint(0, n, (r, s, MASKER_N), device="cuda",
                          generator=gen))


def _seeded_masker_run(cfg, models, opt, bank, y, a_idx, b_idx, rng,
                       shifts=None):
    """Seeded masker steps over the (R, S, 2K) rows: returns the (R, S,
    4) terms."""
    from cgs_tpu_torch.ops.kernels import Segment
    from cgs_tpu_torch.sandbox.seed_parallel import seeded_masker_step
    terms = [seeded_masker_step(
        cfg, models, opt, Segment(bank, a_idx[:, s].contiguous(), labels=y),
        Segment(bank, b_idx[:, s].contiguous()), rng,
        None if shifts is None else shifts[s])
        for s in range(a_idx.shape[1])]
    return torch.stack(terms, 1)


def _seeded_vs_serial(a_idx, b_idx, shifts, bank, y, optim: str) -> dict:
    """Three seeded masker steps of R = 2 seeds against three serial
    `masker_step`s per seed (dropout 0, the given shifts, f32), under
    "sgd" (lr 0.1) or "adam" (the trainer's `make_optimizer`). Returns
    the worst |diff| of the loss terms, of the parameters after the
    three steps, and of the first step's gradients relative to each
    tensor's largest; under Adam also where the parameters part most,
    with that element's first-step gradients. Adam steps by about lr
    whatever a gradient's size, so an element whose gradient is 0 or
    within rounding of it (a ReLU unit at its edge) can part by lr in a
    step while the gradients, the loss terms and the SGD parameters
    agree: the caller holds the parameters to SP_TOL under SGD."""
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.models.interop import unstack_seed
    from cgs_tpu_torch.ops.kernels import Segment
    from cgs_tpu_torch.sandbox.seed_parallel import SeedRng
    from cgs_tpu_torch.train.steps import (
        StepRng, make_optimizer, masker_step,
    )

    def make_opt(models):
        if optim == "sgd":
            return torch.optim.SGD([p for m in models.values()
                                    for p in m.parameters()], lr=0.1)
        return make_optimizer(models)

    def grads(models):
        return {n: {k: p.grad.detach().clone()
                    for k, p in m.named_parameters()}
                for n, m in models.items()}

    dev = torch.device("cuda")
    cfg0 = parse_args(["-train", "--chfak", "5", "--dropout", "0"])
    seeds = [11, 12]
    models, init = _seeded_models(seeds, 0.0)
    opt, rng = make_opt(models), SeedRng.seeded(seeds, dev)
    terms = []
    for s in range(3):
        terms.append(_seeded_masker_run(
            cfg0, models, opt, bank, y, a_idx[:, s:s + 1],
            b_idx[:, s:s + 1], rng, shifts[s:s + 1])[:, 0].cpu())
        if s == 0:
            g1 = grads(models)
    worst = {"terms": 0.0, "params": 0.0, "grads": 0.0}
    k = MASKER_N // 2
    cfg_serial = parse_args(["-train", "--chfak", "5", "--dropout", "0",
                             "--shift", "0"])
    for r in range(2):
        smodels = {}
        for name, tmpl in (("critic", Critic(chfak=5, dropout=0.0)),
                           ("masker", UnetDecoder(chfak=5))):
            tmpl.load_state_dict(unstack_seed(init[name], r, 2))
            smodels[name] = tmpl.to(dev,
                                    memory_format=torch.channels_last).train()
        sopt = make_opt(smodels)
        for s in range(3):
            a = [Segment(bank, a_idx[r, s, :k].contiguous(), shifts[s][r], y),
                 Segment(bank, a_idx[r, s, k:].contiguous(), shifts[s][r], y)]
            want = torch.stack(masker_step(
                cfg_serial, smodels, sopt, a,
                Segment(bank, b_idx[r, s].contiguous()),
                StepRng.seeded(0, dev))).cpu()
            worst["terms"] = max(worst["terms"],
                                 float((terms[s][r] - want).abs().max()))
            if s == 0:
                sg1 = grads(smodels)
        for name, model in models.items():
            got = unstack_seed(model.state_dict(), r, 2)
            gg = unstack_seed(g1[name], r, 2)
            for key, v in smodels[name].state_dict().items():
                want_g = sg1[name][key].cpu()
                scale = float(want_g.abs().max())
                worst["grads"] = max(worst["grads"], float(
                    (gg[key] - want_g).abs().max()) / max(scale, 1e-30))
                diff = (got[key] - v.cpu()).abs()
                if float(diff.max()) > worst["params"]:
                    worst["params"] = float(diff.max())
                    if optim == "adam":
                        i = int(diff.argmax())
                        worst["at"] = {
                            "seed": seeds[r], "param": f"{name}.{key}",
                            "diff": float(diff.max()),
                            "step1_grad_seeded": float(gg[key].flatten()[i]),
                            "step1_grad_serial": float(want_g.flatten()[i]),
                            "tensor_max_grad": scale}
    return worst


def _seeded_dropout_checks(bank, y, gen, runs: int) -> dict:
    """Dropout 0.5, shifts drawn, chfak 5, f32, SGD (lr 0.1): three
    seeded masker steps and three seeded critic steps of R = runs seeds
    (0..R-1) against three serial `masker_step`s / `critic_step`s of
    each seed with `StepRng.seeded(seed)`, which draws the same shifts
    and dropout masks: the worst |diff| of the terms (losses), and of
    the first step's gradients relative to each tensor's largest; then
    the last seed alone (R = 1) against its slot at R after three masker
    steps: terms and parameters. Each is held to SP_TOL by the
    caller."""
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.models.interop import unstack_seed
    from cgs_tpu_torch.ops.kernels import Segment
    from cgs_tpu_torch.sandbox.seed_parallel import (
        SeedRng, seeded_critic_step,
    )
    from cgs_tpu_torch.train.steps import StepRng, critic_step, masker_step

    dev = torch.device("cuda")
    cfg = parse_args(["-train", "--chfak", "5", "--dropout", "0.5"])
    seeds, k, nb = list(range(runs)), MASKER_N // 2, bank.shape[0]
    last = runs - 1
    a_idx, b_idx = _seeded_indices(gen, runs, nb, s=3)
    c_idx = torch.randint(0, nb, (runs, 3, 64), device=dev, generator=gen)

    def sgd(models):
        return torch.optim.SGD([p for m in models.values()
                                for p in m.parameters()], lr=0.1)

    def grads(models):
        return {f"{n}.{key}": p.grad.detach().clone()
                for n, m in models.items() for key, p in m.named_parameters()}

    def rel(a, b):
        return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)

    def seeded_masker(rs):
        rs = list(rs)
        models, init = _seeded_models([seeds[r] for r in rs], 0.5)
        opt, rng = sgd(models), SeedRng.seeded([seeds[r] for r in rs], dev)
        terms, g1 = [], None
        for s in range(3):
            terms.append(_seeded_masker_run(
                cfg, models, opt, bank, y, a_idx[rs, s:s + 1],
                b_idx[rs, s:s + 1], rng)[:, 0].cpu())
            g1 = g1 or grads(models)
        return models, init, terms, g1

    models, init, terms, g1 = seeded_masker(range(runs))
    worst = {"masker terms": 0.0, "masker step-1 gradients": 0.0,
             "critic losses": 0.0, "critic step-1 gradients": 0.0}
    for r, seed in enumerate(seeds):
        smodels = {}
        for name, tmpl in (("critic", Critic(chfak=5, dropout=0.5)),
                           ("masker", UnetDecoder(chfak=5))):
            tmpl.load_state_dict(unstack_seed(init[name], r, runs))
            smodels[name] = tmpl.to(dev,
                                    memory_format=torch.channels_last).train()
        sopt, rng = sgd(smodels), StepRng.seeded(seed, dev)
        for s in range(3):
            a = [Segment(bank, a_idx[r, s, :k].contiguous(), labels=y),
                 Segment(bank, a_idx[r, s, k:].contiguous(), labels=y)]
            want = torch.stack(masker_step(
                cfg, smodels, sopt, a, Segment(bank, b_idx[r, s].contiguous()),
                rng)).cpu()
            worst["masker terms"] = max(worst["masker terms"], float(
                (terms[s][r] - want).abs().max()))
            if s == 0:
                sg = grads(smodels)
                for name in ("critic", "masker"):
                    got = unstack_seed({key[len(name) + 1:]: v
                                        for key, v in g1.items()
                                        if key.startswith(name + ".")}, r,
                                       runs)
                    for key, v in got.items():
                        worst["masker step-1 gradients"] = max(
                            worst["masker step-1 gradients"],
                            rel(v, sg[f"{name}.{key}"].cpu()))
    del models
    # critic steps
    cmodels, cinit = _seeded_models(seeds, 0.5)
    critic = cmodels["critic"]
    copt, rng = sgd({"critic": critic}), SeedRng.seeded(seeds, dev)
    closses, cg1 = [], None
    for s in range(3):
        closses.append(seeded_critic_step(
            cfg, critic, copt, Segment(bank, c_idx[:, s].contiguous(),
                                       labels=y), rng).cpu())
        cg1 = cg1 or {key: p.grad.detach().clone()
                      for key, p in critic.named_parameters()}
    for r, seed in enumerate(seeds):
        scritic = Critic(chfak=5, dropout=0.5)
        scritic.load_state_dict(unstack_seed(cinit["critic"], r, runs))
        scritic = scritic.to(dev, memory_format=torch.channels_last).train()
        sopt, srng = sgd({"critic": scritic}), StepRng.seeded(seed, dev)
        for s in range(3):
            loss = critic_step(cfg, scritic, sopt,
                               Segment(bank, c_idx[r, s].contiguous(),
                                       labels=y), srng)
            worst["critic losses"] = max(worst["critic losses"], abs(
                float(closses[s][r]) - float(loss)))
            if s == 0:
                got = unstack_seed(cg1, r, runs)
                for key, p in scritic.named_parameters():
                    worst["critic step-1 gradients"] = max(
                        worst["critic step-1 gradients"],
                        rel(got[key], p.grad.detach().cpu()))
    del cmodels, critic
    # the last seed alone against its slot at R
    alone, _, t1, _ = seeded_masker([last])
    many, _, tr, _ = seeded_masker(range(runs))
    worst[f"seed {last} terms, R = 1 vs R = {runs}"] = max(
        float((a[0] - b[last]).abs().max()) for a, b in zip(t1, tr))
    worst[f"seed {last} parameters, R = 1 vs R = {runs}"] = max(
        float((unstack_seed(many[n].state_dict(), last, runs)[key]
               - v.cpu()).abs().max())
        for n in ("critic", "masker")
        for key, v in alone[n].state_dict().items())
    return worst


def phase_seeded_step(_build) -> None:
    """At R = 2 and 3 a seeded masker step's kernel path is bit-equal to
    its plain path (terms and gradients, deterministic cuDNN); three
    seeded steps of R = 2 at dropout 0 with given shifts agree with
    three serial `masker_step`s per seed within SP_TOL
    (`_seeded_vs_serial`); at dropout 0.5, R = 3 and 10 seeded steps
    against each seed's serial steps (`_seeded_dropout_checks`)."""
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.sandbox.seed_parallel import SeedRng

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(21)
    nb = 4096
    bank = torch.randint(0, 256, (nb, 64, 64, 3), dtype=torch.uint8,
                         device=dev, generator=gen)
    y = torch.rand(nb, device=dev, generator=gen)
    cfg = parse_args(["-train", "--chfak", "5", "--dropout", "0.5"])
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        # kernel path against plain path at the seed-major batches the
        # seeded step hands the kernels (R * 2K frames into the ingest's
        # A, the merges and the decoder's joins, a 2R * 2K joined
        # gradient): the (R, 4) terms and every gradient bit-equal; lr 0,
        # so the step's gradients stay in .grad
        for r in (2, SP_R):
            models, _ = _seeded_models(list(range(r)), 0.5)
            opt = torch.optim.SGD([p for m in models.values()
                                   for p in m.parameters()], lr=0.0)
            a_idx, b_idx = _seeded_indices(gen, r, nb)

            def run():
                terms = _seeded_masker_run(cfg, models, opt, bank, y, a_idx,
                                           b_idx, SeedRng.seeded(range(r),
                                                                 dev))
                torch.cuda.synchronize()
                return terms[:, 0].cpu(), {
                    f"{n}.{k}": p.grad.detach().clone()
                    for n, m in models.items()
                    for k, p in m.named_parameters()}

            _build.launches.clear()
            k_terms, k_grads = run()
            check(dict(_build.launches) == STEP_LAUNCHES,
                  f"R = {r}: kernel path launched {dict(_build.launches)}")
            with _plain_kernels():
                _build.launches.clear()
                p_terms, p_grads = run()
                check(sum(_build.launches.values()) == 0,
                      f"R = {r}: plain path launched "
                      f"{dict(_build.launches)}")
            d_terms = float((k_terms - p_terms).abs().max())
            d_grads = max(float((k_grads[k] - p_grads[k]).abs().max())
                          for k in k_grads)
            check(bool(torch.isfinite(k_terms).all()),
                  f"R = {r}: seeded terms not finite: {k_terms}")
            check(torch.equal(_bits(k_terms), _bits(p_terms)) and all(
                torch.equal(_bits(k_grads[k]), _bits(p_grads[k]))
                for k in k_grads),
                f"R = {r} seeded step, kernel path vs plain path: terms "
                f"{d_terms}, grads {d_grads}")
            zero = [k for k, v in k_grads.items()
                    if k.startswith("masker.") and not bool(v.abs().sum() > 0)]
            check(not zero, f"R = {r}: decoder gradients all zero: {zero}")
            log(f"[seeded step] R = {r} kernel path vs plain path, one "
                f"masker step (dropout 0.5, shifts drawn): (R, 4) terms and "
                f"all {len(k_grads)} gradients bit-equal (max |diff| terms "
                f"{d_terms:.3g}, grads {d_grads:.3g})")
            del models, opt

        # seeded R = 2 against serial steps per seed: the same index
        # stacks and shifts, dropout 0, under SGD and under Adam
        a_idx, b_idx = _seeded_indices(gen, 2, nb, s=3)
        shifts = [[5, -9], [0, 31], [-63, 2]]
        sgd = _seeded_vs_serial(a_idx, b_idx, shifts, bank, y, "sgd")
        adam = _seeded_vs_serial(a_idx, b_idx, shifts, bank, y, "adam")
        log("[seeded step] R = 2 seeded vs serial, 3 masker steps, dropout "
            f"0, f32 TF32 off (tolerance {SP_TOL}): SGD {json.dumps(sgd)}; "
            f"Adam {json.dumps(adam)}")
        gated = {"sgd terms": sgd["terms"], "sgd params": sgd["params"],
                 "step-1 gradients": max(sgd["grads"], adam["grads"]),
                 "adam terms": adam["terms"]}
        check(max(gated.values()) <= SP_TOL,
              f"seeded vs serial masker steps differ by {gated}")

        # dropout 0.5, shifts drawn: each seed's own streams
        # at R = 3, and at R = 10, the runner's R in the 10-seed runs
        for runs in (3, 10):
            drop = _seeded_dropout_checks(bank, y, gen, runs)
            log(f"[seeded step] R = {runs} seeded vs serial per seed, "
                "dropout 0.5, shifts drawn, 3 steps, SGD, f32 TF32 off "
                f"(tolerance {SP_TOL}): {json.dumps(drop)}")
            check(max(drop.values()) <= SP_TOL,
                  f"seeded steps at dropout 0.5, R = {runs}, differ from "
                  f"serial by {drop}")

    finally:
        torch.backends.cudnn.deterministic = deterministic


def phase_seed_parallel(_build) -> dict:
    """The seed-parallel runner's main path: `run_parallel` of R = 3
    seeds (base seed 0) on the easy protocol, -frozen, chfak 5, in a
    temporary directory; every seed's IoU >= MIN_IOU, the ensemble IoU
    finite, the common masker step count. Returns the path's launches."""
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.data.collect import collect_data
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.sandbox.seed_parallel import K, run_parallel

    cfg = parse_args(SP_PROTOCOL)
    x, y, _ = collect_data(cfg, write=False)
    xe, gt = synthetic_eval_set(n_frames=5000, seed=99)
    xe, gt = xe[100:5000:2], gt[100:5000:2]
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            _build.launches.clear()         # seed-parallel main path
            out = run_parallel(cfg, x, y, SP_R, base_seed=0, x_eval=xe,
                               gt_eval=gt, results_path="results.txt",
                               verbose=False)
            launches = dict(_build.launches)  # ... ends
            line = open("results.txt").read()
        finally:
            os.chdir(old)
            torch.backends.cudnn.deterministic = deterministic
    n_pos = max(p for p, _ in out["contrastive"])
    last = out["masker_losses"][:, -(out["steps"]["masker"] // 12):]
    log(f"[seed-parallel] R = {SP_R}, chfak 5 -frozen, 20k frames, critic "
        f"10 / masker 12 epochs: IoUs {out['ious']}, ensemble "
        f"{out['ensemble_iou']}; steps {out['steps']}; contrastive "
        f"{out['contrastive']}; last masker epoch's mean (replace, inject, "
        f"norm, critic) per seed {last.mean(1).round(5).tolist()}; critic "
        f"loss of the last epoch per seed "
        f"{out['critic_losses'][:, -313:].mean(1).round(5).tolist()}; "
        f"results.txt: {line.strip()!r}")
    check(out["steps"]["masker"] == 12 * -(-n_pos // K),
          f"masker steps {out['steps']}, want 12 * ceil({n_pos} / {K})")
    check(out["steps"]["critic"] == 10 * 313, f"critic steps {out['steps']}")
    check(line.startswith(f"runs={SP_R} seed-parallel base_seed=0 ious=["),
          f"results.txt line {line!r}")
    check(bool(np.isfinite(out["ensemble_iou"])),
          f"ensemble IoU {out['ensemble_iou']}")
    check(all(v >= MIN_IOU for v in out["ious"]),
          f"seed-parallel IoUs {out['ious']} below {MIN_IOU}")
    return launches


def phase_resume(_build) -> dict:
    """-orbax: a small chfak-5 `-train` (dropout 0.5, shift on,
    deterministic cuDNN) broken after its second masker chunk and
    resumed in a fresh Handler ends with the critic and masker
    parameters of an uninterrupted run, bit for bit. Returns the
    path's launches."""
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.handler import CRITIC, MASKER, Handler

    def run(name, break_at=None):
        h = Handler(parse_args(RESUME_ARGV + ["--model", name]),
                    primary=False)
        h.load_data()
        h.critic_pipe()
        if break_at is None:
            h.segmentation_training()
            return h
        real, seen = h.metrics.write, {"n": 0}

        def write(kind, **kw):
            real(kind, **kw)
            if kind == "masker_loss":
                seen["n"] += 1
                if seen["n"] == break_at:
                    raise KeyboardInterrupt("simulated crash")
        h.metrics.write = write
        try:
            h.segmentation_training()
        except KeyboardInterrupt:
            return h
        raise SmokeFailure("the masker phase was not broken")

    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            _build.launches.clear()         # resume main path starts
            ref = run("ref")
            broken = run("res", break_at=3)
            saved = broken.train_states[MASKER].steps()
            res = run("res")
            launches = dict(_build.launches)  # ... ends
        finally:
            os.chdir(old)
            torch.backends.cudnn.deterministic = deterministic
    spe = -(-ref.contrastive.n_pos // 32)
    ends = [e * spe + min(d + RESUME_CHUNK, spe) for e in range(2)
            for d in range(0, spe, RESUME_CHUNK)]   # the chunk boundaries
    same = {name: all(torch.equal(ref.params[name][k], res.params[name][k])
                      for k in ref.params[name]) for name in (CRITIC, MASKER)}
    log(f"[resume] chfak 5, 2k frames, critic 2 / masker 2 epochs of {spe} "
        f"steps: broken after masker chunk 2 (saved steps {saved}); the "
        f"resumed run trained {res.loss_log[MASKER].shape[0]} masker steps; "
        f"bit-equal to the uninterrupted run: {same}")
    check(saved == ends[:2], f"saved masker steps {saved}, want {ends[:2]}")
    check(res.loss_log[MASKER].shape[0] == 2 * spe - ends[1],
          f"resumed masker steps {res.loss_log[MASKER].shape}")
    check(all(same.values()), f"resumed run differs: {same}")
    return launches


def phase_drift_ablation(_build):
    """The drift probe (full, frozen; 2 masker epochs) and the paired
    ablation (R = 2, the four variants) at chfak 5 and a small depth, in
    a temporary directory: frozen rows read 0 drift exactly, full rows
    more. Returns the two paths' launches."""
    from cgs_tpu_torch.sandbox import ablation, drift

    old = os.getcwd()
    with tempfile.TemporaryDirectory() as d:
        os.chdir(d)
        try:
            _build.launches.clear()         # drift main path
            rows = drift.main(list(DRIFT_ARGV), primary=False)
            drift_launches = dict(_build.launches)
            _build.launches.clear()         # ablation main path
            res = ablation.run_ablation(list(ABLATION_ARGV), runs=2,
                                        results_path="results.txt")
            ablation_launches = dict(_build.launches)
        finally:
            os.chdir(old)
    for epoch in (1, 2):
        fr, fu = rows["frozen"][epoch], rows["full"][epoch]
        check(fr["param_drift"] == 0.0 and fr["embeds_drift"] == [0.0] * 5,
              f"frozen drift at epoch {epoch}: {fr}")
        check(fu["param_drift"] > 0.0 and min(fu["embeds_drift"]) > 0.0,
              f"full drift at epoch {epoch}: {fu}")
    summary = ablation.paired_summary(res)
    check(all(len(v["ious"]) == 2 for v in res.values()),
          f"ablation variants {list(res)}")
    log(f"[drift] rows {json.dumps(rows)}")
    log(f"[ablation] R = 2, chfak 5:\n{summary}")
    return drift_launches, ablation_launches


# ---------------------------------------------------------------------
# dp: data parallelism over ranks
# ---------------------------------------------------------------------

def _digest(obj) -> str:
    """A sha256 over every tensor and array in obj, in key order."""
    import hashlib
    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, dict):
            for k in sorted(o):
                h.update(str(k).encode())
                walk(o[k])
        elif isinstance(o, (list, tuple)):
            for v in o:
                walk(v)
        elif isinstance(o, torch.Tensor):
            h.update(o.detach().cpu().contiguous().numpy().tobytes())
        elif isinstance(o, np.ndarray):
            h.update(np.ascontiguousarray(o).tobytes())
        else:
            h.update(repr(o).encode())
    walk(obj)
    return h.hexdigest()


def _dp_rank(argv, dirs, params, a, y, b, frames, members, sp):
    """The meshed half of every dp check, on one rank of the world (a
    module-level function: rank 1 imports it from this file). Rank 0
    returns what the checks compare, rank 1 the digests of it."""
    from cgs_tpu_torch.ops import _build
    from cgs_tpu_torch.parallel import probes
    from cgs_tpu_torch.parallel.mesh import current_mesh

    out = {"adam": probes.steps(params, a, y, b, chfak=5),
           "sgd": probes.steps(params, a, y, b, chfak=5, optim="sgd")}
    _build.launches.clear()                 # the dp main path starts
    out["cli"] = probes.cli_run(argv, dirs, primary=False)
    out["launches"] = dict(_build.launches)  # ... and ends
    out["pipe"] = probes.pipeline(out["cli"]["params"], frames, DP_PIPE_B,
                                  chfak=5)
    out["ens"] = probes.pipeline(members, frames, DP_PIPE_B, chfak=5,
                                 ensemble=True)
    out["sp"] = probes.run_parallel(*sp, masker_steps=2)
    if current_mesh().rank == 0:
        return out
    return {"params": _digest(out["cli"]["params"]),
            "files": out["cli"]["files"], "pipe": _digest(out["pipe"]),
            "ens": _digest(out["ens"]),
            "adam": _digest(out["adam"]["masker"]),
            "sp": {"seeds": out["sp"]["seeds"],
                   "mlosses": out["sp"]["mlosses"]}}


def _rel_gaps(got, want, prefix="") -> dict:
    """{tensor name: its largest |got - want| over its largest |want|}
    of nested dicts of tensors (or one tensor)."""
    if isinstance(want, dict):
        out = {}
        for k in want:
            out.update(_rel_gaps(got[k], want[k], f"{prefix}{k}."))
        return out
    g, w = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return {prefix.rstrip("."): float(
        (g - w).abs().max() / w.abs().max().clamp_min(1e-30))}


def _doubled(a, y, b):
    """The steps probe's inputs with every row of each half twice, the
    pairs of A and B kept: the same means (the same math) at twice the
    batch, which cuDNN sums in another way."""
    k = a.shape[0] // 2

    def twice(t):
        return np.concatenate([t[:k], t[:k], t[k:2 * k], t[k:2 * k]])

    return twice(a), twice(y), twice(b)


def _untimed(d: dict) -> dict:
    """A steps probe's result without its timings."""
    return {k: v for k, v in d.items() if k not in (
        "critic_s", "masker_s", "allreduce_ms", "allreduce_bytes")}


def _dp_checks(tag, ranks, ref) -> dict:
    """(b)'s checks of one two-rank world against the unmeshed runs."""
    got, other = ranks
    keys = ("critic_loss", "masker_terms", "critic_grads", "masker_grads")

    def gaps(run, base):
        out = {}
        for key in keys:
            out.update(_rel_gaps(run["adam"][key], base["adam"][key],
                                 key + "."))
        for key in ("critic", "masker"):
            out.update(_rel_gaps(run["sgd"][key], base["sgd"][key],
                                 "sgd_" + key + "."))
        return out

    dp, floor = gaps(got, ref), gaps(ref["doubled"], ref)
    adam_gap = max(float((got["adam"]["masker"][n][k] - v).abs().max())
                   for n, st in ref["adam"]["masker"].items()
                   for k, v in st.items())
    worst = sorted(dp, key=lambda t: dp[t] / max(DP_TOL, DP_FLOOR
                                                 * floor[t]))[-3:]
    log(f"[dp {tag}] first steps against the whole batch, gap over each "
        f"tensor's largest |value|: largest {max(dp.values()):.3e} "
        f"(the doubled batch: {max(floor.values()):.3e}); nearest their "
        f"bound: " + ", ".join(f"{t} {dp[t]:.3e} (doubled {floor[t]:.3e})"
                               for t in worst)
        + f"; Adam's masker params |gap| {adam_gap:.3e} (logged only)")
    for t, gap in dp.items():
        check(gap <= max(DP_TOL, DP_FLOOR * floor[t]),
              f"dp {tag}: {t} gap {gap:.3e} > {DP_TOL} and > {DP_FLOOR} x "
              f"the doubled batch's {floor[t]:.3e}")
    check(other["adam"] == _digest(got["adam"]["masker"]),
          f"dp {tag}: the ranks' masker params differ after a step")

    cli, cli1 = got["cli"], ref["cli"]
    check(other["params"] == _digest(cli["params"]),
          f"dp {tag}: the ranks' trained params differ")
    check(other["files"] == [] and cli["files"]
          and all("/orbax-" in f for f in cli["files"]),
          f"dp {tag}: rank 0 wrote {cli['files']}, rank 1 {other['files']}")
    check(cli["ious"][0] == cli["eval_host_iou"],
          f"dp {tag}: reduced IoU {cli['ious']} != host IoU "
          f"{cli['eval_host_iou']}")
    log(f"[dp {tag}] -train -eval, chfak 5, 2k frames: eval IoU "
        f"{cli['ious']} over 2 ranks (host numpy IoU of the assembled "
        f"masks {cli['eval_host_iou']}), {cli1['ious']} on 1")

    pipe, half, full = got["pipe"], ref["pipe_half"], ref["pipe_full"]
    check(other["pipe"] == _digest(pipe),
          f"dp {tag}: the ranks' pipeline outputs differ")
    check(np.array_equal(pipe["masks"], half["masks"])
          and np.array_equal(pipe["preds"], half["preds"]),
          f"dp {tag}: pipeline masks not bit-equal to the unmeshed run at "
          f"the per-rank batch")
    gap = float(np.abs(pipe["masks"] - full["masks"]).max())
    near = np.abs(full["masks"] - DP_EVAL_THRESH) <= DP_TOL
    flips = ((pipe["masks"] > DP_EVAL_THRESH)
             != (full["masks"] > DP_EVAL_THRESH)) & ~near
    check(gap <= DP_TOL and not flips.any(),
          f"dp {tag}: pipeline masks {gap:.3e} from the whole batch's, "
          f"{int(flips.sum())} hard pixels flipped away from the threshold")
    check(other["ens"] == _digest(got["ens"])
          and all(np.array_equal(got["ens"][k], ref["ens"][k])
                  for k in ref["ens"]),
          f"dp {tag}: seed-sharded --ensemble 2 not bit-equal to unmeshed")

    sp, sp2 = got["sp"], ref["sp"]
    check(sp["seeds"] == [0, 1] and other["sp"]["seeds"] == [1],
          f"dp {tag}: run_parallel seeds {sp['seeds']}")
    for r, single in enumerate(ref["sp_singles"]):
        for key in ("critic_losses", "masker_losses"):
            check(np.array_equal(sp[key][r:r + 1], single[key]),
                  f"dp {tag}: run_parallel seed {r}'s {key} differ from "
                  f"its unmeshed R = 1 run")
    first = float(np.abs(sp["critic_losses"][:, 0]
                         - sp2["critic_losses"][:, 0]).max())
    steps = np.abs(np.concatenate([sp["critic_losses"], sp["masker_losses"][
        ..., 0]], 1) - np.concatenate([sp2["critic_losses"], sp2[
            "masker_losses"][..., 0]], 1)).max(0)
    log(f"[dp {tag}] run_parallel R = 2 over 2 ranks: bit-equal to each "
        f"seed's unmeshed R = 1 run; against the unmeshed R = 2 run, the "
        f"first step's losses {first:.3e} apart, then the largest gap by "
        f"step (critic, then the masker's replace term) "
        f"{np.round(steps, 6).tolist()}; IoUs {sp['ious']} / {sp2['ious']}, "
        f"ensemble {sp['ensemble_iou']} / {sp2['ensemble_iou']}")
    check(first <= SP_TOL, f"dp {tag}: run_parallel's first critic losses "
          f"{first:.3e} from the unmeshed R = 2 run > {SP_TOL}")

    for name in TRAIN_KERNELS:
        check(got["launches"].get(name, 0) > 0,
              f"{name} never launched on the dp main path ({tag})")
    return got["launches"]


def phase_dp(_build) -> dict:
    """Data parallelism over ranks (`cgs_tpu_torch/parallel/`): (a) NCCL
    at world 1, (b) two ranks on cuda:0 over gloo, (c) NCCL over two
    cards when there are two. Returns the launches of (b)'s main path
    (rank 0's process)."""
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.data.collect import collect_data
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.parallel import multihost, probes

    params = _random_params(Critic(chfak=5), UnetDecoder(chfak=5), 21)
    members = [params, _random_params(Critic(chfak=5), UnetDecoder(chfak=5),
                                      22)]
    gen = np.random.default_rng(5)
    a = gen.integers(0, 256, (MASKER_N, 64, 64, 3), dtype=np.uint8)
    b = gen.integers(0, 256, (MASKER_N, 64, 64, 3), dtype=np.uint8)
    y = gen.random(MASKER_N).astype(np.float32)
    frames = gen.integers(0, 256, (DP_FRAMES, 64, 64, 3), dtype=np.uint8)
    sp_cfg = parse_args(["-synthetic_data", "--chfak", "5", "--datasize",
                         "2000", "--cepochs", "1", "--dropout", "0",
                         "--high-rew-thresh", "0.0", "--low-rew-thresh",
                         "1.0", "--model", "chip-smoke-dpsp"])
    x, yy, _ = collect_data(sp_cfg, write=False)
    xe, gt = synthetic_eval_set(n_frames=5000, seed=99)
    xe, gt = xe[100:5000:2], gt[100:5000:2]

    # (a) NCCL at world 1: bit-equal to the unmeshed chunks
    _build.launches.clear()
    ref_adam = probes.steps(params, a, y, b, chfak=5, meshed=False,
                            device="cuda")
    da, dy, db = _doubled(a, y, b)
    plain = dict(_build.launches)
    _build.launches.clear()
    w1 = multihost.launch(probes.steps, 1, (params, a, y, b, 5),
                          device="cuda")
    w1_launches = dict(_build.launches)
    want = {k: v * (2 if k == "normalize_u8" else 1)
            for k, v in STEP_LAUNCHES.items()}
    check(plain == w1_launches == want,
          f"dp world 1: launches {w1_launches}, unmeshed {plain}, "
          f"want {want}")
    check(_digest(_untimed(w1)) == _digest(_untimed(ref_adam)),
          "dp world 1 over NCCL: not bit-equal to the unmeshed chunks")
    log(f"[dp nccl-1] world 1 through the DP code bit-equal to the "
        f"unmeshed critic and masker chunks; launches {w1_launches}")

    # the unmeshed references of (b) and (c)
    with tempfile.TemporaryDirectory() as d:
        ref = {"adam": ref_adam,
               "sgd": probes.steps(params, a, y, b, chfak=5, optim="sgd",
                                   meshed=False, device="cuda"),
               "doubled": {"adam": probes.steps(params, da, dy, db, chfak=5,
                                                meshed=False, device="cuda"),
                           "sgd": probes.steps(params, da, dy, db, chfak=5,
                                               optim="sgd", meshed=False,
                                               device="cuda")},
               "cli": probes.cli_run(DP_ARGV + ["--data-parallel", "1"],
                                     [d], primary=False, meshed=False)}
    sp = (sp_cfg, x, yy, 2, 0, xe, gt)

    def worlds(tag, **kw):
        with tempfile.TemporaryDirectory() as d0, \
                tempfile.TemporaryDirectory() as d1:
            ranks = multihost.launch(
                _dp_rank, 2, (DP_ARGV, [d0, d1], params, a, y, b, frames,
                              members, sp), device="cuda", gather=True,
                **kw)
        # the pipeline references read the weights the world trained
        dp_params = ranks[0]["cli"]["params"]
        ref.update(
            pipe_half=probes.pipeline(dp_params, frames, DP_PIPE_B // 2,
                                      chfak=5, meshed=False, device="cuda"),
            pipe_full=probes.pipeline(dp_params, frames, DP_PIPE_B,
                                      chfak=5, meshed=False, device="cuda"))
        return _dp_checks(tag, ranks, ref)

    ref.update(
        ens=probes.pipeline(members, frames, DP_PIPE_B, chfak=5,
                            ensemble=True, meshed=False, device="cuda"),
        sp=probes.run_parallel(*sp, meshed=False, masker_steps=2),
        sp_singles=[probes.run_parallel(sp_cfg, x, yy, 1, s, xe, gt,
                                        meshed=False, masker_steps=2)
                    for s in (0, 1)])
    launches = worlds("gloo", backend="gloo", device_indices=[0, 0])
    if torch.cuda.device_count() >= 2:
        worlds("nccl")
    else:
        log("[dp nccl-2] (c) NCCL across cards did not run: this machine "
            "has one card")
    return launches


if __name__ == "__main__":
    try:
        sys.exit(main())
    except (SmokeFailure, AssertionError) as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        sys.exit(1)
