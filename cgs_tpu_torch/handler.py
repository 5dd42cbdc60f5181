"""Orchestrator (PyTorch port of `cgs_tpu/handler.py:65-213,529-648`;
reference `Handler`, main.py:66-1270).

Owns the model templates, their weights as state_dicts, the run layout
and the checkpoint fingerprints, and drives the inference phases:

    load ckpts -> eval / segment

Run layout parity (main.py:93-102): `{name}/saves/critic-<args>.pt`,
`{name}/saves/masker-<args>.pt`, eval artifacts under
`eval-results/{name}/`. Training (`-train`), the visualisers, CRF,
video `-process` and the ensemble are not ported yet; they raise
`NotImplementedError` naming their ROADMAP.md item.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch

from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.core.device import resolve_device
from cgs_tpu_torch.eval.harness import evaluate, load_eval_set
from cgs_tpu_torch.eval.segment import segment_folder
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.models.interop import init_torch_default
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.train.checkpoints import (
    checkpoint_paths, load_model_pt, save_model_pt)

CRITIC = "critic"
MASKER = "masker"
SEPCRIT = "sepcrit"

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to cgs_tpu_torch yet (ROADMAP.md {item}); "
        "the JAX package cgs_tpu has it")


class Handler:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        if cfg.ensemble:
            raise _not_ported("--ensemble", "queue 1 item 9")
        self.device = resolve_device(cfg.device)
        self.ious = (0.0, 0.0)      # best-so-far tracker (main.py:77)
        self.last_ious: List[float] = []  # most recent eval() result

        # --bf16: bfloat16 conv stacks, f32 params and sigmoid heads
        cdt = torch.bfloat16 if cfg.bf16 else torch.float32
        self.critic = Critic(bottleneck=cfg.neck, chfak=cfg.chfak,
                             dropout=cfg.dropout, compute_dtype=cdt)
        self.masker = UnetDecoder(bottleneck=cfg.neck, chfak=cfg.chfak,
                                  compute_dtype=cdt)
        self.reset_models()

        # run layout (main.py:93-102)
        self.save_paths = checkpoint_paths(cfg)
        self._pipes: Dict = {}       # inference pipelines per config
        self._eval_sets: Dict = {}   # folder -> (x, gt) eval data

    # -- model/param management ------------------------------------

    def reset_models(self) -> None:
        """Fresh weights (main.py:106-111) from PyTorch's default init,
        drawn from a generator seeded with --seed. self.params holds
        {name: state_dict} on the CPU."""
        gen = torch.Generator().manual_seed(self.cfg.seed)
        names = [CRITIC, MASKER] + ([SEPCRIT] if self.cfg.separate
                                    else [])
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        for name in names:
            template = self.masker if name == MASKER else self.critic
            init_torch_default(template, gen)
            self.params[name] = {k: v.detach().clone() for k, v in
                                 template.state_dict().items()}

    def load_models(self, modelnames: Optional[List[str]] = None) -> bool:
        """.pt checkpoint load; False if any file is missing
        (main.py:136-147)."""
        modelnames = modelnames or list(self.params.keys())
        for name in modelnames:
            loaded = load_model_pt(name, self.save_paths[name])
            if loaded is None:
                if not self.cfg.train:
                    print(f"{self.save_paths[name]} not found")
                return False
            print("loading:", self.save_paths[name])
            self.params[name] = loaded
        return True

    def save_models(self, modelnames: Optional[List[str]] = None) -> None:
        modelnames = modelnames or list(self.params.keys())
        for name in modelnames:
            print("saving:", self.save_paths[name])
            save_model_pt(self.params[name], name, self.save_paths[name])

    # -- eval / inference ---------------------------------------------

    def _pipeline(self, salience: bool, wire: str = "f32",
                  hard_threshold=None) -> MaskPipeline:
        """One pipeline per (salience, wire, hard_threshold); a reused
        pipeline only copies in the current weights."""
        cache_key = (salience, wire, hard_threshold)
        pipe = self._pipes.get(cache_key)
        if pipe is not None:
            pipe.update_params(self.params)
            return pipe
        batch = self.cfg.infer_batch or (
            8192 if self.device.type == "cuda" else 128)
        pipe = MaskPipeline(
            self.critic, self.masker, self.params,
            batch_size=batch,
            salience=salience,
            eval_mode=not self.cfg.noevalmode,   # main.py:900-909
            separate=self.cfg.separate,
            seed=self.cfg.seed,
            wire=wire,
            hard_threshold=hard_threshold,
            device=self.device)
        self._pipes[cache_key] = pipe
        return pipe

    def eval(self, folder: str = "") -> List[float]:
        """IoU eval (main.py:891-1101); with `folder`, evaluates a
        directory of images against an all-zero GT (main.py:917-918)."""
        cfg = self.cfg
        if cfg.crf:
            raise _not_ported("-crf", "queue 1 item 7")
        out_dir = f"eval-results/{cfg.name}/"
        if folder not in self._eval_sets:
            self._eval_sets[folder] = load_eval_set(
                cfg, evaldatapath=cfg.evaldatapath, folder=folder)
        x, gt = self._eval_sets[folder]
        pipe = self._pipeline(salience=cfg.salience)
        result = evaluate(cfg, pipe, x, gt, best_iou=self.ious[0],
                          out_dir=out_dir)
        ious = result["ious"]
        # the best-tracker update is absent on purpose, as in the
        # reference (main.py:1018)
        print("\nRESULTS", ious)
        self.last_ious = [float(v) for v in ious]
        return ious

    def segment(self, folder: str) -> Dict:
        """-process (main.py:1103-1223) on a folder of 64x64 images.
        The mask comes down the reduced wire: PNG-space uint8 plus the
        device-side binarisation (bit-identical PNGs, 1/4 the bytes)."""
        cfg = self.cfg
        if cfg.crf:
            raise _not_ported("-crf", "queue 1 item 7")
        if os.path.isfile(folder) and folder.lower().endswith(VIDEO_EXTS):
            raise _not_ported("video-file -process", "queue 1 item 7")
        hard = cfg.binarymaskthreshold or None
        pipe = self._pipeline(salience=cfg.process_salience,
                              wire="u8", hard_threshold=hard)
        return segment_folder(cfg, pipe, folder)

    def visualize(self) -> List[str]:
        raise _not_ported("-viscritic/-vismasker/--trainasvis",
                          "queue 1 item 7")

    def load_data(self) -> None:
        raise _not_ported("-train", "queue 1 items 3-5")

