#!/usr/bin/env python3
"""The paper's multi-seed protocol on the PyTorch port, for comparison
with the JAX package's published spreads (`RESULTS.md`).

    python3 ten_seeds.py --protocol A B --out runs/ten_seeds
    python3 ten_seeds.py --protocol B --runner seed-parallel --out runs/sp
    python3 ten_seeds.py --protocol B --runner seed-parallel \
        --base-seed 19 --runs 1 --masker-steps 108 --out runs/sp19
    python3 ten_seeds.py --protocol B --runner seed-parallel \
        --base-seed 19 --masker-steps 108 --tf32 --out runs/sp19tf32
    python3 ten_seeds.py --protocol B --runner seed-parallel \
        --base-seed 19 --masker-steps 108 --log-logits 30 --out runs/sp19l

runs, on the CUDA card, each protocol over seeds base..base+runs-1
through `cgs_tpu_torch.sandbox.multirun.run_seeds(..., primary=False)`,
or, with `--runner seed-parallel`, all of them at once through
`cgs_tpu_torch.sandbox.seed_parallel.run_parallel`, the runner the JAX
package's B figures come from (every seed trained for the largest
seed's masker step count, every seed scored on seed 99's eval set, and
the ensemble IoU of the seeds' mean mask; each seed draws its shifts
and dropout masks from generators of its own, seeded with the seed, but
its masker step count is the R seeds' common one, which also sets the
chunks its index stacks are drawn in, and R sets the grouped
convolutions' rounding, so a seed's result depends on --runs and
--base-seed; `--masker-steps N` reruns a seed for the N steps an epoch
it ran beside others; `--tf32` lets cuDNN run the f32 convolutions in
TF32, nearer the TPU's default f32 convolution precision than the
port's full f32):

  A  the default (live) model, chfak 1, easy fixture, 20k frames,
     critic 10 / masker 12 epochs (`RESULTS.md:90-99`: JAX 0.707 +-
     0.080 over seeds 0-9);
  B  chfak 5, dropout 0.5, -frozen, hard fixture, 40k frames, critic
     15 / masker 12 epochs (`RESULTS.md:641-661`: JAX 0.860 +- 0.030
     over 20 seeds, 0.868 over seeds 0-9 and 0.852 over 10-19), then
     the `--ensemble N` eval, raw, with `-crf` and with `-crf_rescale`,
     on its N checkpoints (`RESULTS.md:689-698`: seeds 0-9 raw 0.857,
     CRF 0.741, rescaled 0.743; seeds 10-19 raw 0.838).

Every seed trains on the dataset of seed 0, as the JAX package's runs
did: its multirun's first seed writes the dataset cache that later
seeds load, and its seed-parallel runner collects once. So the cache
(`runs/data/straight/`, under the working directory) is written once
here before the seeds run. Each seed evaluates in its run on its own
eval set (`--seed` + 99), as the JAX multirun does (A's comparison);
B's seeds are also evaluated on seed 99's, the one eval set the JAX
seed-parallel runner scored every seed and the ensemble on (B's
comparison).

Nothing but checkpoints (B's, under `{model}-seed{s}/saves/`, for the
ensemble; the seed-parallel runner's model names end in `-sp`) and the
data cache is written in the working directory; the results go to
--out: `results.txt` (the runner's lines), `seeds.jsonl`
(one line per seed, written as each seed ends), `summary.jsonl`
(one line per protocol) and, from the seed-parallel runner,
`masker_losses_<protocol>.npy`, every seed's (replace, inject, norm,
critic) terms per masker step, (R, steps, 4), and, with `--log-logits N`,
`masker_logits_<protocol>.npy`: for each seed and each of the first N
masker steps, the largest and the mean of the decoder's pre-sigmoid
logits over the step's frames and pixels (a forward hook on the final
mask convolution, `models/seeded.py:SeededDecoder.masker[2]`), then the
step's L1 norm term and replace term, (R, N, 4). Every line carries the
card's name and power limit from nvidia-smi.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
COMMON = ["-train", "-eval", "-synthetic_data", "--mepochs", "12"]
PROTOCOLS = {
    "A": COMMON + ["--datasize", "20000", "--cepochs", "10",
                   "--model", "ten-seeds-A"],
    "B": COMMON + ["--chfak", "5", "--dropout", "0.5",
                   "--synthetic-variant", "hard", "--datasize", "40000",
                   "--cepochs", "15", "-frozen", "--model", "ten-seeds-B"],
}
# the JAX figures each protocol is compared with (RESULTS.md)
JAX = {"A": {"mean": 0.707, "std": 0.080, "line": "RESULTS.md:90-99"},
       "B": {"mean": 0.860, "std": 0.030, "line": "RESULTS.md:641-661",
             "ensemble_raw": 0.857, "ensemble_crf": 0.741,
             "ensemble_crf_rescale": 0.743,
             "ensemble_line": "RESULTS.md:689-698"}}
DATA_SEED = 0


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def append_json(path: Path, rec: dict) -> None:
    with open(path, "a") as fp:
        fp.write(json.dumps(rec) + "\n")


def write_data_cache(argv) -> float:
    """The dataset of DATA_SEED into the cache every seed reads."""
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.data.collect import collect_data
    t = time.time()
    collect_data(parse_args(argv + ["--seed", str(DATA_SEED)]), write=True)
    return time.time() - t


def run_protocol(name: str, base_seed: int, runs: int, out: Path,
                 gpu: str) -> dict:
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.eval.harness import evaluate, load_eval_set
    from cgs_tpu_torch.sandbox.multirun import run_seeds
    from cgs_tpu_torch.train.checkpoints import save_model_pt

    argv = PROTOCOLS[name]
    # seed 99's eval set: the eval set of --seed DATA_SEED
    cfg99 = parse_args(argv + ["--seed", str(DATA_SEED)])
    x99, gt99 = load_eval_set(cfg99) if name == "B" else (None, None)
    cache_s = write_data_cache(argv)
    print(f"[ten_seeds] {name}: data cache written in {cache_s:.1f} s",
          flush=True)
    t_seed = [time.time()]
    e99 = []

    def on_seed(seed, handler):
        extra = {}
        if name == "B":     # the ensemble's members; under -frozen the
            # critic is the one phase 1 trained
            for kind in ("critic", "masker"):
                save_model_pt(handler.params[kind], kind,
                              handler.save_paths[kind])
            pipe = handler._pipeline(salience=False)
            extra["iou_eval99"] = evaluate(cfg99, pipe, x99, gt99,
                                           write=False)["ious"][0]
            e99.append(extra["iou_eval99"])
        now = time.time()
        sets = handler.contrastive
        rec = {"protocol": name, "seed": seed,
               "iou": handler.last_ious[0], "ious": handler.last_ious,
               **extra,
               "critic_steps": int(handler.loss_log["critic"].shape[0]),
               "masker_steps": int(handler.loss_log["masker"].shape[0]),
               "contrastive": [int(sets.n_pos), int(sets.n_neg)],
               "seconds": round(now - t_seed[0], 1), "card": gpu}
        t_seed[0] = now
        append_json(out / "seeds.jsonl", rec)
        print(f"[ten_seeds] {json.dumps(rec)}", flush=True)

    summary = run_seeds(argv, runs, results_path=str(out / "results.txt"),
                        base_seed=base_seed, primary=False,
                        on_seed=on_seed)
    summary.update(protocol=name, seeds=[base_seed, base_seed + runs - 1],
                   argv=argv, jax=JAX[name], card=gpu,
                   data_cache_s=round(cache_s, 1))
    if e99:
        summary["eval99"] = {"ious": e99, "mean": float(np.mean(e99)),
                             "std": float(np.std(e99))}
    return summary


def seed_parallel_argv(name: str):
    """The protocol's flags for the seed-parallel runner: no -train or
    -eval, and its own run names."""
    argv = [a for a in PROTOCOLS[name] if a not in ("-train", "-eval")]
    i = argv.index("--model")
    argv[i + 1] += "-sp"
    return argv


class LogitLog:
    """The first `steps` training forwards of every `SeededDecoder`
    built while it is open: per seed, the largest and the mean of the
    final mask convolution's output (the pre-sigmoid logits), kept on
    the device until `read`. A global forward pre-hook finds each
    decoder before its first forward and hooks its last convolution, so
    no module changes."""

    def __init__(self, steps: int):
        import torch
        from cgs_tpu_torch.models.seeded import SeededDecoder

        self.steps, self.rows = steps, []
        hooked = set()

        def on_conv(module, args, out):
            if module.training and len(self.rows) < self.steps:
                h = out.detach().float()            # (n, R, H, W) grouped
                self.rows.append(torch.stack([h.amax((0, 2, 3)),
                                              h.mean((0, 2, 3))], 1))

        def on_decoder(module, args):
            if isinstance(module, SeededDecoder) and id(module) not in hooked:
                hooked.add(id(module))
                module.masker[2].register_forward_hook(on_conv)

        self._global = torch.nn.modules.module.register_module_forward_pre_hook(
            on_decoder)

    def close(self) -> None:
        self._global.remove()

    def read(self, masker_losses: np.ndarray) -> np.ndarray:
        """(R, N, 4): logit max, logit mean, then the norm and replace
        terms of the same steps from the runner's (R, steps, 4) terms."""
        import torch
        n = len(self.rows)
        logits = torch.stack(self.rows, 1).cpu().numpy()       # (R, N, 2)
        return np.concatenate([logits, masker_losses[:, :n, 2:3],
                               masker_losses[:, :n, 0:1]], 2)


def run_protocol_parallel(name: str, base_seed: int, runs: int, out: Path,
                          gpu: str, masker_steps=None,
                          tf32: bool = False, log_logits: int = 0) -> dict:
    """The protocol's seeds in one `run_parallel` on the data of
    DATA_SEED, scored on seed 99's eval set, with the switches the CLI's
    -train sets (tf32: then cuDNN's TF32 back on); B also saves each
    seed's checkpoints for the `--ensemble` evals. masker_steps:
    run_parallel's masker steps per epoch (None: the common count).
    Writes every seed's masker terms per step to --out, and with
    log_logits = N > 0 the first N steps' logits (`LogitLog`)."""
    import torch
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.core.device import train_switches
    from cgs_tpu_torch.data.collect import collect_data
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.sandbox.seed_parallel import run_parallel

    argv = seed_parallel_argv(name)
    cfg = parse_args(argv + ["--seed", str(DATA_SEED)])
    switches = train_switches(cfg.bf16)
    if tf32:
        torch.backends.cudnn.allow_tf32 = True
        switches["cudnn.allow_tf32"] = True
    print(f"[ten_seeds] switches: {switches}", flush=True)
    t = time.time()
    x, y, _ = collect_data(cfg, write=False)
    x99, gt99 = synthetic_eval_set(n_frames=5000, seed=99,
                                   variant=cfg.synthetic_variant)
    x99, gt99 = x99[100:5000:2], gt99[100:5000:2]
    data_s = time.time() - t
    logit_log = LogitLog(log_logits) if log_logits else None
    try:
        res = run_parallel(cfg, x, y, runs, base_seed=base_seed,
                           x_eval=x99, gt_eval=gt99,
                           results_path=str(out / "results.txt"),
                           save_checkpoints=name == "B",
                           masker_steps=masker_steps)
    finally:
        if logit_log is not None:
            logit_log.close()
    np.save(out / f"masker_losses_{name}.npy", res["masker_losses"])
    if logit_log is not None:
        logits = logit_log.read(res["masker_losses"])
        np.save(out / f"masker_logits_{name}.npy", logits)
        for r, seed in enumerate(res["seeds"]):
            print(f"[ten_seeds] seed {seed} first {logits.shape[1]} masker "
                  "steps (logit max, logit mean, norm, replace): "
                  f"{np.round(logits[r], 5).tolist()}", flush=True)
    for r, seed in enumerate(res["seeds"]):
        rec = {"protocol": name, "runner": "seed-parallel", "seed": seed,
               "iou_eval99": res["ious"][r],
               "contrastive": res["contrastive"][r],
               "critic_steps": res["steps"]["critic"],
               "masker_steps": res["steps"]["masker"], "card": gpu}
        append_json(out / "seeds.jsonl", rec)
        print(f"[ten_seeds] {json.dumps(rec)}", flush=True)
    return {"protocol": name, "runner": "seed-parallel",
            "seeds": [base_seed, base_seed + runs - 1], "argv": argv,
            "eval99": {"ious": res["ious"], "mean": res["mean"],
                       "std": res["std"]},
            "ensemble_iou_seed_parallel": res["ensemble_iou"],
            "steps": res["steps"],
            "phase_seconds": {k: round(v, 1)
                              for k, v in res["seconds"].items()},
            "data_s": round(data_s, 1), "switches": switches,
            "jax": JAX[name], "card": gpu}


def run_ensemble(base_seed: int, runs: int, gpu: str,
                 argv=None) -> dict:
    """The `--ensemble N` eval of B's checkpoints of seeds base_seed..,
    through a Handler, raw, with -crf and with -crf_rescale."""
    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.handler import Handler
    from cgs_tpu_torch.train.checkpoints import load_seed_ensemble

    if argv is None:
        argv = [a for a in PROTOCOLS["B"] if a not in ("-train", "-eval")]
    res = {"members": [base_seed, base_seed + runs - 1], "card": gpu,
           "jax": JAX["B"]}
    for key, extra in (("raw", []), ("crf", ["-crf"]),
                       ("crf_rescale", ["-crf", "-crf_rescale"])):
        t = time.time()
        handler = Handler(parse_args(argv + ["-eval", "--ensemble",
                                             str(runs)] + extra),
                          primary=False)
        # `--ensemble N` reads seeds 0..N-1; other bases load here
        handler._ensemble_params = load_seed_ensemble(
            handler.cfg, runs, base_seed=base_seed)
        res[key] = handler.eval()
        res[f"{key}_s"] = round(time.time() - t, 1)
        print(f"[ten_seeds] ensemble {key}: {res[key]}", flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--protocol", nargs="+", choices=sorted(PROTOCOLS),
                    default=["A", "B"])
    ap.add_argument("--runs", type=int, default=10)
    ap.add_argument("--base-seed", type=int, default=0)
    ap.add_argument("--out", default="runs/ten_seeds")
    ap.add_argument("--runner", choices=["serial", "seed-parallel"],
                    default="serial")
    ap.add_argument("--masker-steps", type=int, default=None,
                    help="seed-parallel only: masker steps per epoch in "
                    "place of the common count, to rerun a seed alone for "
                    "the steps it ran beside others")
    ap.add_argument("--tf32", action="store_true",
                    help="seed-parallel only: cuDNN runs the f32 "
                    "convolutions in TF32")
    ap.add_argument("--log-logits", type=int, default=0, metavar="N",
                    help="seed-parallel only: log each seed's decoder "
                    "logits (max, mean) with the norm and replace terms "
                    "over the first N masker steps")
    args = ap.parse_args(argv)
    if args.masker_steps is not None and args.runner != "seed-parallel":
        ap.error("--masker-steps needs --runner seed-parallel")
    if args.tf32 and args.runner != "seed-parallel":
        ap.error("--tf32 needs --runner seed-parallel")
    if args.log_logits and args.runner != "seed-parallel":
        ap.error("--log-logits needs --runner seed-parallel")
    import torch
    if not torch.cuda.is_available():
        print("ten_seeds: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    out = Path(args.out).resolve()
    out.mkdir(parents=True, exist_ok=True)
    gpu = card()
    print(f"[ten_seeds] {gpu}; torch {torch.__version__}", flush=True)
    for name in args.protocol:
        t = time.time()
        parallel = args.runner == "seed-parallel"
        if parallel:
            summary = run_protocol_parallel(name, args.base_seed, args.runs,
                                            out, gpu, args.masker_steps,
                                            args.tf32, args.log_logits)
        else:
            summary = run_protocol(name, args.base_seed, args.runs, out, gpu)
        summary["seconds"] = round(time.time() - t, 1)
        if name == "B":
            summary["ensemble"] = run_ensemble(
                args.base_seed, args.runs, gpu,
                seed_parallel_argv(name) if parallel else None)
        append_json(out / "summary.jsonl", summary)
        print(f"[ten_seeds] {json.dumps(summary)}", flush=True)
    print(gpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
