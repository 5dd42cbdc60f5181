"""Multi-seed run aggregation (PyTorch port of
`cgs_tpu/sandbox/multirun.py:14-96`; reference TrainHandler.py `main()`
multi-run loop, 4024-4056): run the full CLI pipeline over `--runs`
seeds and append mean/std/best IoU to `results.txt`, the mechanism
behind the paper's "IoU mean over 10 training seeds".

    python -m cgs_tpu_torch.sandbox.multirun --runs 10 -train -eval \\
        -synthetic_data --model m

runs on the card (`--device cpu` for the CPU). Seed s trains as run
`{model}-seed{s}`, the layout `--ensemble N` loads
(`train/checkpoints.py:load_seed_ensemble`). The `results.txt` line is
the JAX package's, byte for byte.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np


def run_seeds(argv: List[str], runs: int,
              results_path: str = "results.txt", base_seed: int = 0,
              primary: bool = True,
              on_seed: Optional[Callable] = None) -> dict:
    """Run `cli.main` `runs` times, seeds base_seed.., and aggregate the
    mask IoU (`last_ious[0]`). argv: CLI args without --seed.
    primary=False runs every seed without writing its files (the
    `results.txt` line is still appended). on_seed(seed, handler), if
    given, sees each seed's Handler before it is closed. Returns
    {'ious', 'mean', 'std', 'best'}."""
    from cgs_tpu_torch.cli import main

    ious = []
    for r in range(runs):
        seed = base_seed + r
        handler = main(argv + ["--seed", str(seed),
                               "--model", _seeded_name(argv, seed)],
                       primary=primary)
        # last_ious, not handler.ious: the reference's best tracker is
        # never updated by eval() (main.py:1018)
        ious.append(handler.last_ious[0] if handler.last_ious
                    else float(handler.ious[0]))
        if on_seed is not None:
            on_seed(seed, handler)
        handler.close()
        print(f"[multirun] seed {seed}: IoU {ious[-1]}")

    arr = np.asarray(ious)
    summary = {"ious": ious, "mean": float(arr.mean()),
               "std": float(arr.std()), "best": float(arr.max())}
    line = (f"runs={runs} args={' '.join(argv)} "
            f"ious={[round(v, 3) for v in ious]} "
            f"mean={summary['mean']:.3f} std={summary['std']:.3f} "
            f"best={summary['best']:.3f}\n")
    with open(results_path, "a") as fp:
        fp.write(line)
    return summary


def _seeded_name(argv: List[str], seed: int) -> str:
    """Run name for one seed, from '--model X' or '--model=X' (the last
    one wins, as in argparse)."""
    name = "default-model"
    for i, tok in enumerate(argv):
        if tok == "--model" and i + 1 < len(argv):
            name = argv[i + 1]
        elif tok.startswith("--model="):
            name = tok.split("=", 1)[1]
    return f"{name}-seed{seed}"


def pop_int(argv: List[str], flag: str, default: int) -> int:
    """Remove `<flag> N` or `<flag>=N` from argv in place and return N.
    Both spellings: `--runs` is also a dead flag of the Config grammar,
    which would swallow a missed `--runs=5` and train one seed."""
    for i, tok in enumerate(argv):
        if tok == flag:
            if i + 1 >= len(argv):
                raise SystemExit(f"{flag} requires a value")
            value = int(argv[i + 1])
            del argv[i:i + 2]
            return value
        if tok.startswith(flag + "="):
            value = int(tok.split("=", 1)[1])
            del argv[i]
            return value
    return default


def pop_runs(argv: List[str], default: int = 1) -> int:
    """Remove `--runs N` from argv in place (TrainHandler.py:4024)."""
    return pop_int(argv, "--runs", default)


def main(argv: Optional[List[str]] = None) -> None:
    """`python -m cgs_tpu_torch.sandbox.multirun --runs N <cli args>`."""
    import sys
    argv = list(argv if argv is not None else sys.argv[1:])
    runs = pop_runs(argv)
    run_seeds(argv, runs)


if __name__ == "__main__":
    main()
