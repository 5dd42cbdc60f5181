"""Orchestrator (PyTorch port of `cgs_tpu/handler.py`; reference
`Handler`, main.py:66-1270).

Owns the model templates, their weights as CPU state_dicts, the run
layout, the checkpoint fingerprints, and the phase drivers:

    load_data -> critic_pipe -> segmentation_training -> eval / segment

Run layout parity (main.py:93-102): `{name}/saves/critic-<args>.pt`,
`{name}/saves/masker-<args>.pt`, results under `{name}/critic/` and
`{name}/segment/`, eval artifacts under `eval-results/{name}/`. Every
file write is gated on `primary` (True in a single process; a caller
that wants no files, such as `chip_smoke.py`, passes False).

Training runs on the device: the uint8 frames stay there for the whole
run, each chunk of steps gathers its batches there, and only the index
stacks go up and the losses come down once per chunk
(`train/loops.py`). The numpy streams are the JAX package's: `self.rng`
(`default_rng(seed)`) drives the critic's batch order and the random
split, and the masker phase draws its index stacks from
`SeedSequence([seed, 0x6d61736b, epoch, done])`, so for one seed both
packages see the same batches. The shift and dropout draws come from
`torch.Generator`s seeded with --seed. The visualisers, CRF, video
`-process`, the ensemble, `-orbax` and `--profile` are not ported yet;
they raise `NotImplementedError` naming their ROADMAP.md item.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.core.device import resolve_device
from cgs_tpu_torch.data.collect import collect_data
from cgs_tpu_torch.data.loader import DataBundle, EpochLoader
from cgs_tpu_torch.eval.harness import evaluate, load_eval_set
from cgs_tpu_torch.eval.segment import segment_folder
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.models.interop import init_torch_default
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.train.checkpoints import (
    checkpoint_paths, load_model_pt, save_model_pt)
from cgs_tpu_torch.train.contrastive import (
    extract_contrastive_sets, sample_index_stacks,
)
from cgs_tpu_torch.train.loops import (
    critic_chunk, critic_viz, masker_chunk, masker_viz,
)
from cgs_tpu_torch.train.steps import (
    StepRng, make_optimizer, trained_param_keys,
)
from cgs_tpu_torch.utils.artifacts import (
    annotate_strip, save_histogram, save_loss_plot,
)
from cgs_tpu_torch.utils.metrics import MetricsWriter, write_log_header
from cgs_tpu_torch.utils.profiling import nan_guard

CRITIC = "critic"
MASKER = "masker"
SEPCRIT = "sepcrit"

VIDEO_EXTS = (".mp4", ".avi", ".mov", ".mkv", ".webm")
MASK_STREAM = 0x6d61736b        # 'mask': the masker phase's numpy stream


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to cgs_tpu_torch yet (ROADMAP.md {item}); "
        "the JAX package cgs_tpu has it")


class Handler:
    def __init__(self, cfg: Config, primary: bool = True):
        self.cfg = cfg
        if cfg.ensemble:
            raise _not_ported("--ensemble", "queue 1 item 9")
        if cfg.orbax:
            raise _not_ported("-orbax (train-state resume)",
                              "queue 1 item 9")
        if cfg.profile:
            raise _not_ported("--profile (a torch.profiler trace)",
                              "queue 1 item 9")
        self.device = resolve_device(cfg.device)
        self.primary = primary      # gates every file write
        self.rng = np.random.default_rng(cfg.seed)
        self.ious = (0.0, 0.0)      # best-so-far tracker (main.py:77)
        self.last_ious: List[float] = []  # most recent eval() result
        self.bestepoch = 0

        # --bf16: bfloat16 conv stacks, f32 params and sigmoid heads
        cdt = torch.bfloat16 if cfg.bf16 else torch.float32
        self.critic = Critic(bottleneck=cfg.neck, chfak=cfg.chfak,
                             dropout=cfg.dropout, compute_dtype=cdt)
        self.masker = UnetDecoder(bottleneck=cfg.neck, chfak=cfg.chfak,
                                  compute_dtype=cdt)
        self.reset_models()

        # run layout (main.py:93-102)
        self.path = f"{cfg.name}/"
        self.save_paths = checkpoint_paths(cfg)
        self.metrics = MetricsWriter(self.path, enabled=self.primary)
        self.data: Optional[DataBundle] = None
        self.contrastive = None
        # per-step losses of the last training phases: critic (S,),
        # masker (S, 4) = replace, inject, norm, critic
        self.loss_log: Dict[str, np.ndarray] = {}
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
        if not self.primary:
            return
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
            raise _not_ported("-crf", "queue 1 item 9")
        out_dir = f"eval-results/{cfg.name}/"
        if folder not in self._eval_sets:
            self._eval_sets[folder] = load_eval_set(
                cfg, evaldatapath=cfg.evaldatapath, folder=folder)
        x, gt = self._eval_sets[folder]
        pipe = self._pipeline(salience=cfg.salience)
        result = evaluate(cfg, pipe, x, gt, best_iou=self.ious[0],
                          out_dir=out_dir, write=self.primary)
        ious = result["ious"]
        # the best-tracker update is absent on purpose, as in the
        # reference (main.py:1018)
        print("\nRESULTS", ious)
        self.last_ious = [float(v) for v in ious]
        self.metrics.write("eval", iou=ious[0], all_ious=self.last_ious)
        return ious

    def segment(self, folder: str) -> Dict:
        """-process (main.py:1103-1223) on a folder of 64x64 images.
        The mask comes down the reduced wire: PNG-space uint8 plus the
        device-side binarisation (bit-identical PNGs, 1/4 the bytes)."""
        cfg = self.cfg
        if cfg.crf:
            raise _not_ported("-crf", "queue 1 item 9")
        if os.path.isfile(folder) and folder.lower().endswith(VIDEO_EXTS):
            raise _not_ported("video-file -process", "queue 1 item 9")
        hard = cfg.binarymaskthreshold or None
        pipe = self._pipeline(salience=cfg.process_salience,
                              wire="u8", hard_threshold=hard)
        return segment_folder(cfg, pipe, folder, write=self.primary)

    def visualize(self) -> List[str]:
        raise _not_ported("-viscritic/-vismasker/--trainasvis",
                          "queue 1 item 9")

    # -- data --------------------------------------------------------

    def load_data(self) -> None:
        """collect -> split -> device (main.py:113-134)."""
        x, y, i = collect_data(self.cfg, write=self.primary)
        self.data = DataBundle.from_arrays(x, y, i, self.cfg)
        self.data.to_device(self.cfg, self.device)
        print("dataset shapes", x.shape, y.shape,
              self.data.x_train.shape, self.data.y_train.shape)

    # -- training models ----------------------------------------------

    def _device_model(self, name: str) -> torch.nn.Module:
        """A train-mode copy of model `name` on the device, channels_last,
        holding self.params[name]."""
        template = self.masker if name == MASKER else self.critic
        model = copy.deepcopy(template).to(
            self.device, memory_format=torch.channels_last)
        model.load_state_dict(self.params[name])
        return model.train()

    @staticmethod
    def _cpu_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
        return {k: v.detach().cpu().clone()
                for k, v in model.state_dict().items()}

    def _sync_params(self, models: Dict[str, torch.nn.Module]) -> None:
        """Copy EVERY model of the phase (trained and pass-through) back
        into self.params."""
        for name, model in models.items():
            self.params[name] = self._cpu_state(model)

    # -- phase 1: critic ----------------------------------------------

    def critic_pipe(self, mode: str = "train") -> None:
        """Critic training (main.py:158-236). mode="test" runs exactly
        one epoch (main.py:182 `range(int(testf) or cepochs)`)."""
        cfg = self.cfg
        n_epochs = 1 if mode == "test" else cfg.cepochs
        if cfg.cload and self.load_models([CRITIC]):
            print("loaded critic, no new training")
            return

        result_path = self.path + "critic/"
        if self.primary:
            os.makedirs(result_path, exist_ok=True)
            write_log_header(result_path, cfg)
        if cfg.directeval:                    # main.py:179-180
            self.eval()

        critic = self._device_model(CRITIC)
        opt = make_optimizer({CRITIC: critic})
        rng = StepRng.seeded(cfg.seed, self.device)
        viz_rng = StepRng.seeded(cfg.seed + 1, self.device)
        loader = EpochLoader(self.data.n_train, cfg.batch_size, self.rng)
        x_dev, y_dev = self.data.x_train_dev, self.data.y_train_dev

        llog: List[float] = []
        steps = 0
        t0 = time.time()
        for epoch in range(n_epochs):
            b_idx = 0
            # the critic-phase chunk (= viz cadence) is the reference's
            # hard-coded 100 batches (main.py:204); --visevery drives
            # only the masker phase (main.py:466)
            for idx in loader.chunks(100):
                losses = critic_chunk(cfg, critic, opt, x_dev, y_dev, idx,
                                      rng).cpu().numpy()
                steps += len(idx)
                if cfg.debug_nan:
                    nan_guard({"losses": losses,
                               "params": critic.state_dict()}, "critic/")
                llog.extend(losses.tolist())
                print(f"critic e{epoch + 1} b{b_idx} "
                      f"{losses[-1]:.5f}", end="\r")
                if self.primary:   # annotated strip (main.py:204-226)
                    xb, yb, pred = critic_viz(cfg, critic, x_dev, y_dev,
                                              idx[0], viz_rng)
                    annotate_strip(
                        [xb.cpu().numpy()],
                        [yb.cpu().numpy().tolist(),
                         pred.cpu().numpy().tolist()],
                        result_path + f"e{epoch}_b{b_idx}.png",
                        row_offset=33)
                self.metrics.write("critic_loss", step=steps,
                                   loss=float(losses.mean()))
                b_idx += len(idx)

            if not (epoch + 1) % cfg.saveevery:   # main.py:228
                self.params[CRITIC] = self._cpu_state(critic)
                self.save_models([CRITIC])
            if self.primary:
                save_loss_plot(result_path + "_loss.png", llog,
                               ["Train Loss"])
        dt = time.time() - t0
        if llog:
            self.metrics.write("critic_throughput",
                               steps_per_sec=len(llog) / dt,
                               frames_per_sec=len(llog)
                               * cfg.batch_size / dt)
        print()
        self.loss_log[CRITIC] = np.asarray(llog, np.float32)
        self.params[CRITIC] = self._cpu_state(critic)

    # -- phase 2: masker ----------------------------------------------

    def extract_contrastive_data(self):
        """Sweep + split + histogram artifacts (main.py:238-312)."""
        cfg = self.cfg
        sets = extract_contrastive_sets(
            cfg, self._device_model(CRITIC), self.data.x_train_dev,
            self.data.y_train[cfg.rewidx].astype(np.float32),
            self.rng, min_count=cfg.contrastive_min)
        idx = cfg.rewidx
        if self.primary:
            save_histogram(self.path + f"pred_idx{idx}_hist.png",
                           sets.preds)
            save_histogram(self.path + f"GT_idx{idx}_hist.png",
                           self.data.y_train[idx])
            # count marker file (main.py:274-276)
            marker = (f"{int(sets.pos_mask.sum())}"
                      f">{cfg.high_rew_thresh}__"
                      f"{int(sets.neg_mask.sum())}"
                      f"<{cfg.low_rew_thresh}.txt")
            with open(self.path + marker, "w") as fp:
                fp.write("")
        self.contrastive = sets
        return sets

    def segmentation_training(self) -> None:
        """Masker training (main.py:314-575)."""
        cfg = self.cfg
        sets = self.extract_contrastive_data()
        train_path = self.path + "segment/"
        if self.primary:
            os.makedirs(train_path, exist_ok=True)
            write_log_header(train_path, cfg)
        if cfg.directeval:                    # main.py:337-338
            self.eval()

        trained = trained_param_keys(cfg)
        models = {name: self._device_model(name) for name in self.params}
        for name, model in models.items():
            model.requires_grad_(name in trained)
        opt = make_optimizer({n: models[n] for n in trained},
                             cfg.critic_lr_scale)
        rng = StepRng.seeded(cfg.seed, self.device)
        viz_rng = StepRng.seeded(cfg.seed + 1, self.device)

        k = 32  # contrastive batch (main.py:309)
        steps_per_epoch = -(-sets.n_pos // k)     # main.py:342
        log_rows: List[np.ndarray] = []
        steps = 0
        t0 = time.time()
        for epoch in range(cfg.mepochs):
            done = 0
            while done < steps_per_epoch:
                s = min(cfg.visevery, steps_per_epoch - done)
                # the JAX package's per-(epoch, step) numpy stream, so
                # both packages draw the same index stacks
                crng = np.random.default_rng(np.random.SeedSequence(
                    [cfg.seed, MASK_STREAM, epoch, done]))
                h, l, c = sample_index_stacks(crng, sets.n_pos,
                                              sets.n_neg, s, k)
                losses = masker_chunk(
                    cfg, models, opt, sets.xpos, sets.ypos, sets.xneg,
                    sets.yneg, h, l, c, rng).cpu().numpy()   # (s, 4)
                steps += s
                if cfg.debug_nan:
                    nan_guard({"losses": losses,
                               "params": {n: m.state_dict() for n, m in
                                          models.items()}}, "masker/")
                log_rows.append(losses)
                r, i, nm, cl = losses[-1]
                print(f"masker e{epoch} b{done} replace {r:.5f} "
                      f"inject {i:.5f} norm {nm:.5f} critic {cl:.5f}",
                      end="\r")
                if self.primary:   # 7-row merge viz (main.py:466-530)
                    viz = masker_viz(cfg, models, sets.xpos, sets.ypos,
                                     sets.xneg, sets.yneg, h[0], l[0],
                                     c[0][:2 * k], viz_rng)
                    viz = {kk: v.cpu().numpy() for kk, v in viz.items()}
                    annotate_strip(
                        [np.zeros_like(viz["a"]),
                         np.zeros_like(viz["a"]),
                         viz["a"], viz["b"][:2 * k], viz["replaced"],
                         viz["injected"],
                         np.repeat(viz["z"], 3, axis=-1)],
                        [viz["y"], viz["pred"], viz["negpred"],
                         viz["replacevalue"]]
                        + ([viz["injectvalue"]] if cfg.inject else []),
                        train_path + f"e{epoch}_b{done}.png")
                self.metrics.write(
                    "masker_loss", step=steps,
                    replace=float(losses[:, 0].mean()),
                    inject=float(losses[:, 1].mean()),
                    norm=float(losses[:, 2].mean()),
                    critic=float(losses[:, 3].mean()))
                done += s

            if self.primary:
                save_loss_plot(
                    train_path + "_loss.png",
                    np.concatenate(log_rows, axis=0),
                    ["replace", "inject", "norm", "live-critic"],
                    ymin_zero=False)
            if not (epoch + 1) % cfg.saveevery:   # main.py:565
                self._sync_params(models)
                self.save_models([MASKER])
            if cfg.directeval:
                # per-epoch eval + best-IoU tracking (the sandbox's
                # TrainHandler.py:1077-1080, behind -directeval)
                self._sync_params(models)
                epoch_ious = self.eval()
                if epoch_ious[0] > self.ious[0]:
                    self.ious = tuple(epoch_ious[:2]) if \
                        len(epoch_ious) > 1 else (epoch_ious[0], 0.0)
                    self.bestepoch = epoch

        dt = time.time() - t0
        if steps:
            self.metrics.write("masker_throughput",
                               steps_per_sec=steps / dt)
        print()
        self.loss_log[MASKER] = (np.concatenate(log_rows, axis=0)
                                 if log_rows else np.zeros((0, 4)))
        # the live critic stays in self.params but is not saved
        # (main.py:565-575 saves the masker only)
        self._sync_params(models)
        self.save_models([MASKER])

    def close(self) -> None:
        """Release the metrics.jsonl handle."""
        self.metrics.close()
