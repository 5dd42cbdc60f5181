"""CLI entry point with the reference's flag grammar and dispatch order
(PyTorch port of `cgs_tpu/cli.py`; main.py:1548-1570):

    load data -> load ckpts -> critic train -> masker train -> eval ->
    visualize -> process

`python -m cgs_tpu_torch.cli -train -eval -synthetic_data ...` runs on
the CUDA card; `--device cpu` runs on the CPU. In f32 mode both TF32
switches are turned off, so f32 convs run in full f32 (`--bf16` is the
fast mode). With `-train`, cuDNN runs deterministically, so one seed
trains to the same result on every run. The visualisers are not ported
yet and raise.
"""

from __future__ import annotations

from typing import Optional

from cgs_tpu_torch.core.config import parse_args
from cgs_tpu_torch.core.device import (
    deterministic_cudnn, disable_tf32, tf32_state,
)
from cgs_tpu_torch.handler import CRITIC, MASKER, Handler


def main(argv: Optional[list] = None, primary: bool = True) -> Handler:
    """Parse argv and run it. primary=False runs every phase but writes
    no file (no checkpoints, data cache, plots or videos)."""
    cfg = parse_args(argv)
    handler = Handler(cfg, primary=primary)
    if handler.device.type == "cuda":
        print("[cgs-tpu-torch] tf32:",
              tf32_state() if cfg.bf16 else disable_tf32())
        if cfg.train:
            print("[cgs-tpu-torch] cudnn:", deterministic_cudnn())
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
