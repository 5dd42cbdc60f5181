#!/usr/bin/env python3
"""Time the port's ingest kernel (`normalize_u8`) at the serve batch,
uint8 (8192, 64, 64, 3) to f32 and to bf16, for one or more checkouts,
each in a process of its own and in the order given, so that two
commits are compared on one card in one run:

    python3 time_ingest.py --tree build/parent --tree . --tree . \\
        --tree build/parent

Each tree's `cgs_tpu_torch` builds its own kernels (into the tree's
`build/kernels/`), checks the kernel bit-equal to its plain version,
then times it with CUDA events: `--reps` blocks of `--iters` calls
after a warm-up. One JSON line per tree gives the per-call ms of each
block (median, min, max) and the card's name and power limit from
nvidia-smi. Needs a CUDA card and `nvcc`.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (8192, 64, 64, 3)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def time_tree(tree: Path, iters: int, reps: int) -> dict:
    """The ingest's per-call ms at SHAPE for the checkout at tree."""
    sys.path.insert(0, str(tree))
    import torch

    import cgs_tpu_torch
    from cgs_tpu_torch.ops import _build
    from cgs_tpu_torch.ops.kernels import normalize_u8, normalize_u8_plain
    if Path(cgs_tpu_torch.__file__).resolve().parents[1] != tree:
        raise RuntimeError(f"imported {cgs_tpu_torch.__file__}, not {tree}")
    _build.build_kernels()
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randint(0, 256, SHAPE, dtype=torch.uint8, device="cuda",
                      generator=gen)
    rec = {"tree": str(tree), "shape": list(SHAPE)}
    for name, dt in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        got, want = normalize_u8(x, dt), normalize_u8_plain(x, dt)
        bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[dt]
        if not torch.equal(got.view(bits), want.view(bits)):
            raise RuntimeError(f"{tree}: {name} ingest differs from plain")
        del got, want
        for _ in range(5):
            normalize_u8(x, dt)
        blocks = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                normalize_u8(x, dt)
            end.record()
            end.synchronize()
            blocks.append(start.elapsed_time(end) / iters)
        ranked = sorted(blocks)
        rec[name] = {"median_ms": ranked[len(ranked) // 2],
                     "min_ms": ranked[0], "max_ms": ranked[-1],
                     "blocks_ms": blocks}
    rec["card"] = card()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout's root (repeat; timed in order)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(time_tree(Path(args.one).resolve(), args.iters,
                                   args.reps)), flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("time_ingest: no CUDA device", file=sys.stderr)
        return 2
    rc = 0
    for tree in args.tree or ["."]:
        rc |= subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--one",
             str(Path(tree).resolve()), "--iters", str(args.iters),
             "--reps", str(args.reps)], timeout=900).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
