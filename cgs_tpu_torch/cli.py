"""CLI entry point with the reference's flag grammar and dispatch order
(PyTorch port of `cgs_tpu/cli.py`; main.py:1548-1570):

    load data -> load ckpts -> critic train -> masker train -> eval ->
    visualize -> process

`python -m cgs_tpu_torch.cli -train -eval -synthetic_data ...` runs on
the CUDA card; `--device cpu` runs on the CPU. In f32 mode both TF32
switches are turned off, so f32 convs run in full f32 (`--bf16` is the
fast mode). With `-train`, cuDNN runs deterministically, so one seed
trains to the same result on every run. `--profile DIR` traces every
dispatched phase into one trace (`utils/profiling.py`).

Over several cards (port of `cgs_tpu/cli.py:17-24`): under torchrun
each process joins its rank first (`parallel/multihost.py:
ensure_initialized`); otherwise, when --data-parallel asks for N > 1
ranks (0, the default, means every card of the host, and one rank on
the CPU), this process becomes rank 0 and starts ranks 1..N-1 itself,
one process per card. `--device cpu --data-parallel N` runs N gloo
ranks on the CPU. Every rank runs the same phases on its rows of each
batch; `main` returns rank 0's Handler.
"""

from __future__ import annotations

from typing import Optional

from cgs_tpu_torch.core.config import parse_args
from cgs_tpu_torch.core.device import train_switches
from cgs_tpu_torch.handler import CRITIC, MASKER, Handler
from cgs_tpu_torch.parallel.mesh import run_over_ranks
from cgs_tpu_torch.parallel.multihost import ensure_initialized


def main(argv: Optional[list] = None, primary: bool = True) -> Handler:
    """Parse argv and run it. primary=False runs every phase but writes
    no file (no checkpoints, data cache, plots or videos) except the
    train states that -orbax asks for. Over several ranks, returns rank
    0's Handler."""
    cfg = parse_args(argv)
    # torchrun's ranks join before any device is resolved
    ensure_initialized(cfg.device)
    return run_over_ranks(cfg, _run, cfg, primary)


def _run(cfg, primary: bool) -> Handler:
    """One rank's run (the whole run on one rank)."""
    handler = Handler(cfg, primary=primary)
    if handler.device.type == "cuda":
        print("[cgs-tpu-torch] switches:",
              train_switches(cfg.bf16, train=cfg.train))
    # --profile: one trace over every dispatched phase, stopped and
    # written however the phases end
    with handler.profiler.trace():
        _dispatch(cfg, handler)
    return handler


def _dispatch(cfg, handler: Handler) -> None:
    if cfg.train:
        handler.load_data()
    if cfg.trainasvis:                 # main.py:1551-1553
        handler.visualize()
        return
    if cfg.cload:                      # main.py:1554-1557
        handler.load_models([CRITIC])
    if cfg.mload:
        handler.load_models([MASKER])
    if cfg.train:                      # main.py:1558-1564
        if cfg.critic:
            handler.critic_pipe(mode="train")
            handler.save_models([CRITIC])
        if cfg.masker:
            handler.segmentation_training()
            handler.save_models([MASKER])
    if cfg.eval:                       # main.py:1565-1566
        handler.eval()
    if cfg.viscritic or cfg.vismasker:  # main.py:1567-1568
        handler.visualize()
    if cfg.process:                    # main.py:1569-1570
        handler.segment(folder=cfg.source_imgs)


if __name__ == "__main__":
    main()
