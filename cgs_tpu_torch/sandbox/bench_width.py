"""Width-sweep benchmark (PyTorch port of `cgs_tpu/sandbox/bench_width.py`):
inference and the two training chunks at any --chfak.

The code default is chfak 1 (an 8/8/8/16-channel encoder, nets.py:161);
the paper's published architecture is chfak 5, an encoder of "40, 40,
40, 80 and 160 channels" with 0.5 dropout. This times the port's paths
at any width, on the card unless `--device cpu`:

    python -m cgs_tpu_torch.sandbox.bench_width --chfak 5 --dropout 0.5
    python -m cgs_tpu_torch.sandbox.bench_width --chfak 1 --dropout 0.3

Prints one JSON line per measurement (inference f32/bf16, critic
chunk f32/bf16, masker chunk f32/bf16 x fuse modes), then a summary
line, as the JAX module does. Frames are made on the device from a
seeded generator; the models take PyTorch's default init from a fixed
seed (`models/interop.py:init_torch_default`). On the card the run
turns TF32 off (f32 means f32) and makes cuDNN deterministic, as
`-train` does; it prints both switches.

- Inference: `MaskPipeline.run_device` at f32 and bf16, batch `--batch`
  (0: max(2048, 32768 // chfak)), the median of 3 groups of --iters
  dispatches, each group synchronised once by reading back the sum of
  its dispatches' predictions. A dispatch launches 1 ingest
  (`normalize_u8`) and 5 joins (`upsample2x`).
- Training: `train/loops.py:critic_chunk` (batch 64) and `masker_chunk`
  (K = 32: 64 + 64 frames) over a 1024-frame uint8 bank on the device;
  one warm chunk, then `rounds` timed chunks synchronised by one
  `.cpu()` of the last chunk's losses. A masker step launches the
  ingest, the merge and its gradient, and 5 + 5 joins.
- `--fuse-sweep`: the masker chunk at fuse none / merges as well
  (`train/losses.py:build_masker_loss`).
- `--int8-ab`: bf16 against int8 inference with dynamic and calibrated
  scales (`ops/quant.py`).

The JAX module's `--pallas-upsample-ab` has no counterpart: in the port
the join kernel is always the path on the card, and its plain version
the path on the CPU.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def _models(chfak: int, dropout: float, dtype, device, train: bool):
    """The critic and masker at `chfak`, PyTorch's default init from
    seed 0, on `device` (channels_last)."""
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.models.interop import init_torch_default

    gen = torch.Generator().manual_seed(0)
    critic = init_torch_default(
        Critic(chfak=chfak, dropout=dropout, compute_dtype=dtype), gen)
    masker = init_torch_default(UnetDecoder(chfak=chfak, compute_dtype=dtype),
                                gen)
    if train:
        critic, masker = (m.to(device, memory_format=torch.channels_last)
                          .train() for m in (critic, masker))
    return critic, masker


def _train_config(chfak: int, dropout: float):
    """The training chunks' config: shift 12, inject (the defaults of
    `-train`)."""
    from cgs_tpu_torch.core.config import Config
    return Config(shift=12, dropout=dropout, chfak=chfak,
                  inject=True).derive()


def bench_inference(chfak: int, dropout: float, batch: int,
                    n_iter: int, bf16: bool, quantize=None,
                    calibrated: bool = False, device=None) -> dict:
    """Device-resident -process throughput: the median of 3 groups of
    n_iter dispatches of `MaskPipeline.run_device`, each group
    synchronised once (the sum of its predictions read back).
    quantize: None or 'int8' (`ops/quant.py`); calibrated=True bakes
    static activation scales from a 512-frame batch (else dynamic
    per-dispatch scales)."""
    from cgs_tpu_torch.core.device import resolve_device
    from cgs_tpu_torch.pipeline import MaskPipeline

    dev = resolve_device(device)
    dtype = torch.bfloat16 if bf16 else torch.float32
    critic, masker = _models(chfak, dropout, dtype, dev, train=False)
    params = {"critic": critic.state_dict(), "masker": masker.state_dict()}
    calib = None
    if quantize and calibrated:
        calib = np.random.default_rng(2).integers(
            0, 256, (512, 64, 64, 3), dtype=np.uint8)
    pipe = MaskPipeline(critic, masker, params, batch_size=batch,
                        device=dev, quantize=quantize, calib=calib)
    frames = torch.randint(0, 256, (batch, 64, 64, 3), dtype=torch.uint8,
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(0))
    for _ in range(2):                       # warm
        float(pipe.run_device(frames)[0].sum())
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        checksum = torch.zeros((), device=dev)
        for _ in range(n_iter):
            checksum += pipe.run_device(frames)[0].sum()
        float(checksum)
        times.append((time.perf_counter() - t0) / n_iter)
    dt = sorted(times)[1]
    out = {"metric": "process_fps", "chfak": chfak,
           "dtype": "bf16" if bf16 else "f32", "batch": batch,
           "value": round(batch / dt, 1),
           "ms_per_dispatch": round(dt * 1e3, 2), "device": str(dev)}
    if quantize is not None:
        out["quantize"] = quantize
        out["act_scales"] = "static" if calibrated else "dynamic"
    return out


def bench_training(chfak: int, dropout: float, bf16: bool,
                   fuse: str = "both", steps: int = 100,
                   rounds: int = 6, phases=("critic", "masker"),
                   device=None) -> list:
    """Critic/masker chunk steps/s at the reference batch shapes (critic
    batch 64; masker K = 32 -> 64 + 64) over a 1024-frame uint8 bank on
    the device: one warm chunk, then `rounds` chunks of `steps` steps,
    synchronised by one readback."""
    from cgs_tpu_torch.core.device import resolve_device
    from cgs_tpu_torch.train.loops import critic_chunk, masker_chunk
    from cgs_tpu_torch.train.steps import (
        StepRng, make_optimizer, trained_param_keys,
    )

    dev = resolve_device(device)
    dtype = torch.bfloat16 if bf16 else torch.float32
    cfg = _train_config(chfak, dropout)
    rng = np.random.default_rng(1)
    gen = torch.Generator(device=dev).manual_seed(7)
    x_all = torch.randint(0, 256, (1024, 64, 64, 3), dtype=torch.uint8,
                          device=dev, generator=gen)
    y_all = torch.rand(1024, device=dev, generator=gen)
    step_rng = StepRng.seeded(0, dev)

    def time_chunk(chunk, *args):
        chunk(*args, step_rng).cpu()                 # warm
        t0 = time.perf_counter()
        for _ in range(rounds):
            losses = chunk(*args, step_rng)
        losses.cpu()                                 # hard sync
        return rounds * steps / (time.perf_counter() - t0)

    out = []
    tag = {"chfak": chfak, "dtype": "bf16" if bf16 else "f32"}
    if "critic" in phases:
        critic, _ = _models(chfak, dropout, dtype, dev, train=True)
        opt = make_optimizer({"critic": critic})
        idx = rng.integers(0, 1024, (steps, 64), dtype=np.int32)
        out.append({"metric": "critic_train_steps_per_sec", **tag,
                    "value": round(time_chunk(
                        lambda *a: critic_chunk(cfg, critic, opt, *a),
                        x_all, y_all, idx), 3)})
        print(json.dumps(out[-1]), flush=True)
    if "masker" in phases:
        critic, masker = _models(chfak, dropout, dtype, dev, train=True)
        models = {"critic": critic, "masker": masker}
        opt = make_optimizer({k: models[k] for k in trained_param_keys(cfg)})
        xpos, xneg = x_all[:512], x_all[512:]
        ypos, yneg = y_all[:512], y_all[512:]
        h = rng.integers(0, 512, (steps, 32), np.int32)
        l = rng.integers(0, 512, (steps, 32), np.int32)
        c = rng.integers(0, 512, (steps, 64), np.int32)
        out.append({"metric": "masker_train_steps_per_sec", **tag,
                    "fuse": fuse,
                    "value": round(time_chunk(
                        lambda *a: masker_chunk(cfg, models, opt, *a,
                                                fuse=fuse),
                        xpos, ypos, xneg, yneg, h, l, c), 3)})
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None):
    from cgs_tpu_torch.core.device import resolve_device, train_switches

    p = argparse.ArgumentParser(prog="bench_width")
    p.add_argument("--chfak", type=int, default=5)
    p.add_argument("--dropout", type=float, default=0.5)
    p.add_argument("--batch", type=int, default=0,
                   help="inference batch (0 = auto: 32768/chfak-scaled)")
    p.add_argument("--iters", type=int, default=32)
    p.add_argument("--skip-inference", action="store_true")
    p.add_argument("--skip-training", action="store_true")
    p.add_argument("--fuse-sweep", action="store_true",
                   help="masker chunk at fuse=none/merges/both")
    p.add_argument("--int8-ab", action="store_true",
                   help="bf16 vs int8-quantized inference (ops/quant.py "
                        "end-to-end)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    if dev.type == "cuda":
        print(json.dumps({"switches": train_switches(bf16=False),
                          "card": torch.cuda.get_device_name(dev)}),
              flush=True)

    # auto batch: decoder activations scale ~chfak
    batch = a.batch or max(2048, 32768 // max(a.chfak, 1))
    results = []
    infer = []
    if not a.skip_inference:
        infer += [dict(bf16=False), dict(bf16=True)]
    if a.int8_ab:
        infer += [dict(bf16=True, quantize=q, calibrated=cal)
                  for q, cal in ((None, False), ("int8", False),
                                 ("int8", True))]
    for kw in infer:
        r = bench_inference(a.chfak, a.dropout, batch, a.iters, device=dev,
                            **kw)
        results.append(r)
        print(json.dumps(r), flush=True)
    if not a.skip_training:
        for bf16 in (False, True):
            results += bench_training(a.chfak, a.dropout, bf16, device=dev)
        if a.fuse_sweep:
            for fuse in ("none", "merges"):
                results += bench_training(a.chfak, a.dropout, False,
                                          fuse=fuse, phases=("masker",),
                                          device=dev)
    print(json.dumps({"metric": "width_bench_done", "chfak": a.chfak,
                      "n": len(results)}), flush=True)
    return results


if __name__ == "__main__":
    main()
