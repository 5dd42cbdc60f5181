"""Paired ablation sweep over the paper's three ablation flags (PyTorch
port of `cgs_tpu/sandbox/ablation.py`).

The reference's ablation table ("IoU mean over 10 training seeds",
docs/index.html; the flags at main.py:1468-1476) compares the full
model against `-noinject` / `-frozen` / `-separate`, each trained
independently per seed. This module runs all four variants through
`sandbox.seed_parallel` with the same base seeds (identical data,
identical per-seed streams), so the per-seed IoU deltas are paired.

    python -m cgs_tpu_torch.sandbox.ablation --runs 10 -synthetic_data \\
        --synthetic-variant hard --datasize 20000 --cepochs 10 \\
        --mepochs 12 --model abl

runs on the card (`--device cpu` for the CPU). `--base-seed 10` trains
seeds 10-19; `--slow-critic 0.1` adds a fifth paired 'slow' variant,
the full model with `--critic-lr-scale 0.1`. Each variant saves its
per-seed checkpoints under `{model}-{variant}-seed{s}/saves/` and
appends its row to results.txt; the sweep then appends the paired
summary.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

#: variant -> extra CLI flag (the reference's spellings,
#: main.py:1468-1476); the full model adds none.
VARIANT_FLAGS = {
    "full": [],
    "noinject": ["-noinject"],
    "frozen": ["-frozen"],
    "separate": ["-separate"],
}


def _reject_variant_flags(argv: Sequence[str]) -> None:
    present = [f for flags in VARIANT_FLAGS.values()
               for f in flags if f in argv]
    if present:
        raise SystemExit(
            f"ablation sweeps all of -noinject/-frozen/-separate "
            f"itself — drop {present} from the base args")


def _with_variant(argv: List[str], variant: str) -> List[str]:
    """Base args + the variant flag, with --model suffixed so the
    variants' run directories (and their per-seed checkpoint dirs)
    cannot collide."""
    out = list(argv)
    for i, tok in enumerate(out):
        if tok == "--model" and i + 1 < len(out):
            out[i + 1] = f"{out[i + 1]}-{variant}"
            break
        if tok.startswith("--model="):
            out[i] = f"{tok}-{variant}"
            break
    else:
        out += ["--model", f"ablation-{variant}"]
    return out + VARIANT_FLAGS.get(variant, [])


def paired_summary(results: Dict[str, dict]) -> str:
    """Paired-delta table against the full model: per-variant mean ±
    std and the paired delta mean ± sem with the count of seeds above
    full. results: variant -> the seed_parallel output (needs 'ious')."""
    full = np.asarray(results["full"]["ious"], dtype=np.float64)
    n = len(full)
    for variant, out in results.items():
        if len(out.get("ious", [])) != n:
            raise ValueError(
                f"variant {variant!r} returned "
                f"{len(out.get('ious', []))} IoUs, expected {n} — the "
                "deltas are only paired if every variant trained the "
                "same seeds")
    lines = [f"paired ablation over {n} shared seeds "
             "(delta = variant - full, per seed):"]
    for variant, out in results.items():
        v = np.asarray(out["ious"], dtype=np.float64)
        # sample std (ddof=1), matching the paired-delta sem convention
        std = v.std(ddof=1) if n > 1 else 0.0
        row = (f"  {variant:9s} mean {v.mean():.3f} +- {std:.3f}")
        if variant != "full":
            d = v - full
            sem = (d.std(ddof=1) / np.sqrt(n)) if n > 1 else 0.0
            row += (f"  paired d {d.mean():+.3f} +- {sem:.3f}sem "
                    f"({int((d > 0).sum())}/{n} above full)")
        lines.append(row)
    return "\n".join(lines)


def run_ablation(argv: List[str], runs: int,
                 variants: Sequence[str] = tuple(VARIANT_FLAGS),
                 results_path: Optional[str] = "results.txt",
                 slow_critic: Optional[float] = None,
                 ) -> Dict[str, dict]:
    """Train `runs` seeds of every variant (`seed_parallel.main` per
    variant, the same base seeds in each) and append the paired summary
    to results_path. Returns {variant: seed_parallel output}.
    slow_critic: also train a fifth 'slow' variant, the full model
    with `--critic-lr-scale S`, paired like the others."""
    from cgs_tpu_torch.sandbox import seed_parallel

    _reject_variant_flags(argv)
    if "full" not in variants:
        raise SystemExit("the paired summary needs the 'full' baseline")
    extra = {}
    if slow_critic is not None:
        extra["slow"] = ["--critic-lr-scale", str(float(slow_critic))]
    results: Dict[str, dict] = {}
    for variant in list(variants) + sorted(extra):
        vargv = _with_variant(argv, variant) + ["--runs", str(runs)]
        vargv += extra.get(variant, [])
        print(f"[ablation] {variant}: {' '.join(vargv)}", flush=True)
        results[variant] = seed_parallel.main(vargv)

    summary = paired_summary(results)
    print(summary, flush=True)
    if results_path:
        with open(results_path, "a") as fp:
            fp.write(summary + "\n")
    return results


def main(argv: Optional[List[str]] = None) -> Dict[str, dict]:
    """`python -m cgs_tpu_torch.sandbox.ablation --runs N [--slow-critic
    S] [--base-seed B] <cli args>` (--base-seed passes through to
    seed_parallel)."""
    import sys

    from cgs_tpu_torch.sandbox.multirun import pop_runs

    argv = list(argv if argv is not None else sys.argv[1:])
    runs = pop_runs(argv)
    slow = None
    for i, tok in enumerate(list(argv)):     # --slow-critic S | =S
        if tok == "--slow-critic" and i + 1 < len(argv):
            slow = float(argv[i + 1])
            del argv[i:i + 2]
            break
        if tok.startswith("--slow-critic="):
            slow = float(tok.split("=", 1)[1])
            del argv[i]
            break
    return run_ablation(argv, runs, slow_critic=slow)


if __name__ == "__main__":
    main()
