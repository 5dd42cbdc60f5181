"""The benchmark of the PyTorch / CUDA port `cgs_tpu_torch`: one run of
one cell of `BENCHMARK.json`.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Runs from the root of a checkout on a machine with the cell's cards. It
sets up (the kernels from `build/kernels/` in the checkout, weights and
inputs made from the seed, the cell's shapes warmed), measures for
`--seconds`, checks the window's outputs against the plain reference,
and prints one JSON object as the last line of standard output (the
numbers compared, each beside its limit, also as the last lines of
standard error). Exits 2 without the cards the cell asks for, 3 if a
module of JAX or of the JAX package is loaded once the window has
closed, 1 on any other failure; the result is printed only on success.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
CACHES = {"TRITON_CACHE_DIR": "build/triton",
          "TORCH_EXTENSIONS_DIR": "build/torch_extensions",
          "CUDA_CACHE_PATH": "build/cuda_cache"}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    for k, v in CACHES.items():
        os.environ[k] = str(ROOT / v)
    sys.path.insert(0, str(ROOT))
    out = sys.stdout
    sys.stdout = sys.stderr            # the program's prints stay off stdout
    try:
        from portbench.lib.harness import forbidden_modules, run_cell
        from portbench.lib.manifest import Manifest

        man = Manifest(ROOT)
        cell = man.cell(args.workload)
        import torch
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < cell.chips):
            print(f"portbench: {args.workload} needs {cell.chips} CUDA "
                  f"card(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        result = run_cell(man, cell, args.seed, args.seconds,
                          bool(args.trace), device="cuda", t_start=T_START)
        bad = forbidden_modules()
        if bad:
            print(f"portbench: loaded modules of JAX or the JAX package: "
                  f"{bad}", file=sys.stderr)
            return 3
    except Exception:
        traceback.print_exc()
        return 1
    finally:
        sys.stdout = out
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
