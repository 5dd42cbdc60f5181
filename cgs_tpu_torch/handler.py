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
`torch.Generator`s seeded with --seed.

Inference extensions, as in the JAX package: `-crf` refines the eval
and `-process` masks on the host (`eval/crf.py`); `--ensemble N` serves
the mean of the N per-seed runs `{model}-seed{s}`, loaded once per
Handler; a video file as --source-imgs goes to `segment_video`;
`-viscritic`/`-vismasker`/`--trainasvis` render the curve videos;
`--profile DIR` traces the run (`utils/profiling.py:Profiler`, started
by `cli.main`); the chunks and steps name themselves in it
(`cgs.train.*`, `train/loops.py`).

`-orbax` saves each phase's full train state (`train/checkpoints.py:
TrainStateManager`, under `{name}/saves/orbax-critic/` and
`orbax-masker/`) and resumes from the newest: the critic phase at every
epoch boundary, the masker phase at every chunk boundary, keyed by the
global step, so it resumes mid-epoch. The states hold the models, the
Adam state and every random source drawn after that point (the
StepRngs' generators and, in the critic phase, `self.rng`, which orders
the batches), so a resumed run ends with the parameters of an
uninterrupted one. The JAX package does not save `self.rng`, so its
resumed critic phase draws other batches (ROADMAP.md queue 3 item 2).
The train states are written whatever `primary` says, as the JAX
package writes its orbax states on every process.

Data parallelism (port of `cgs_tpu/handler.py:70-71,103-130,165-228,
340-356,542-575`): under `cli.main --data-parallel N` or torchrun each
rank builds its own Handler, whose `mesh` (`parallel/mesh.py`) is that
rank's place, None on one rank. Every rank holds the whole frame banks
and the same `self.rng`, so all draw the same index stacks and each
takes its rows (`train/loops.py`). Rank 0 decides what comes from disk:
its checkpoints, train states and ensemble members are broadcast, even
when a load fails (disks can differ, and a rank that skipped a load
would sit in collectives the others never enter); fresh weights are
broadcast from it too. Only rank 0 writes files (`primary` is the
caller's `primary` and rank 0), -orbax states included, which hold
every rank's dropout-generator state; rank 0 writes the data cache and
builds the CRF library before the others look for them.
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
from cgs_tpu_torch.eval.segment import (
    VIDEO_EXTS, segment_folder, segment_video,
)
from cgs_tpu_torch.models.build import build_pair
from cgs_tpu_torch.models.interop import init_torch_default
from cgs_tpu_torch.parallel.mesh import (
    ensemble_mesh_or_none, local_mesh_or_none, rank0_first, rank0_value,
    replicate_tree,
)
from cgs_tpu_torch.parallel.multihost import is_primary
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.train.checkpoints import (
    TrainStateManager, checkpoint_paths, load_model_pt, load_seed_ensemble,
    save_model_pt,
)
from cgs_tpu_torch.train.contrastive import (
    extract_contrastive_sets, sample_index_stacks,
)
from cgs_tpu_torch.train.loops import (
    critic_chunk, critic_viz, masker_chunk, masker_viz,
)
from cgs_tpu_torch.train.steps import (
    StepRng, make_optimizer, set_masker_modes, trained_param_keys,
)
from cgs_tpu_torch.utils.artifacts import (
    annotate_strip, save_histogram, save_loss_plot,
)
from cgs_tpu_torch.utils.metrics import MetricsWriter, write_log_header
from cgs_tpu_torch.utils.profiling import Profiler, nan_guard

CRITIC = "critic"
MASKER = "masker"
SEPCRIT = "sepcrit"

MASK_STREAM = 0x6d61736b        # 'mask': the masker phase's numpy stream


class Handler:
    def __init__(self, cfg: Config, primary: bool = True):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.mesh = local_mesh_or_none(cfg)
        # gates every file write: the caller's word, and rank 0 only
        self.primary = primary and is_primary()
        self.rng = np.random.default_rng(cfg.seed)
        self.ious = (0.0, 0.0)      # best-so-far tracker (main.py:77)
        self.last_ious: List[float] = []  # most recent eval() result
        self.bestepoch = 0

        # --critic: the pair; --bf16: bfloat16 conv stacks, f32 params
        # and sigmoid heads
        self.critic, self.masker = build_pair(
            cfg, torch.bfloat16 if cfg.bf16 else torch.float32)
        self.reset_models()

        # run layout (main.py:93-102)
        self.path = f"{cfg.name}/"
        self.save_paths = checkpoint_paths(cfg)
        self.metrics = MetricsWriter(self.path, enabled=self.primary)
        # --profile: the trace is written whatever `primary` says
        self.profiler = Profiler(cfg.profile or None, device=self.device)
        self.data: Optional[DataBundle] = None
        self.contrastive = None
        # per-step losses of the last training phases: critic (S,),
        # masker (S, 4) = replace, inject, norm, critic
        self.loss_log: Dict[str, np.ndarray] = {}
        self._pipes: Dict = {}       # inference pipelines per config
        self._eval_sets: Dict = {}   # folder -> (x, gt) eval data
        self._ensemble_params = None  # --ensemble members, loaded once
        self.train_states: Dict[str, TrainStateManager] = {}  # -orbax

    # -- model/param management ------------------------------------

    def reset_models(self) -> None:
        """Fresh weights (main.py:106-111) from PyTorch's default init,
        drawn from a generator seeded with --seed. self.params holds
        {name: state_dict} on the CPU; over a mesh, rank 0's."""
        gen = torch.Generator().manual_seed(self.cfg.seed)
        names = [CRITIC, MASKER] + ([SEPCRIT] if self.cfg.separate
                                    else [])
        self.params: Dict[str, Dict[str, torch.Tensor]] = {}
        for name in names:
            template = self.masker if name == MASKER else self.critic
            init_torch_default(template, gen)
            self.params[name] = {k: v.detach().clone() for k, v in
                                 template.state_dict().items()}
        self.params = replicate_tree(self.mesh, self.params)

    def load_models(self, modelnames: Optional[List[str]] = None) -> bool:
        """.pt checkpoint load; False if any file is missing
        (main.py:136-147). Over a mesh rank 0's disk decides: its flag
        and its params are broadcast, on the failure path too (a load
        that fails part-way leaves rank 0 holding some loaded models,
        main.py:136-147)."""
        modelnames = modelnames or list(self.params.keys())
        if self.mesh is None:
            return self._load_models_local(modelnames)
        ok, params = rank0_value(self.mesh, lambda: (
            self._load_models_local(modelnames),
            {name: self.params[name] for name in modelnames}))
        self.params.update(params)
        return ok

    def _load_models_local(self, modelnames: List[str]) -> bool:
        for name in modelnames:
            loaded = load_model_pt(name, self.save_paths[name],
                                   self.cfg.critic_arch)
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
            save_model_pt(self.params[name], name, self.save_paths[name],
                          self.cfg.critic_arch)

    # -- eval / inference ---------------------------------------------

    def _pipeline(self, salience: bool, wire: str = "f32",
                  hard_threshold=None) -> MaskPipeline:
        """One pipeline per (salience, wire, hard_threshold); a reused
        pipeline only copies in the current weights.

        --ensemble N serves the mean of the N per-seed runs
        `{model}-seed{s}` (cgs_tpu/handler.py:548-580): the members are
        read from disk once per Handler and never refreshed from
        self.params."""
        ensemble = self.cfg.ensemble > 0
        mesh = (ensemble_mesh_or_none(self.mesh, self.cfg.ensemble)
                if ensemble else self.mesh)
        cache_key = (salience, wire, hard_threshold)
        pipe = self._pipes.get(cache_key)
        if pipe is not None:
            if not ensemble:
                pipe.update_params(self.params)
            return pipe
        batch = self.cfg.infer_batch or (
            8192 if self.device.type == "cuda" else 128)
        params = self.params
        if ensemble:
            if self._ensemble_params is None:   # rank 0's disk decides
                self._ensemble_params = rank0_value(
                    self.mesh, lambda: load_seed_ensemble(
                        self.cfg, self.cfg.ensemble))
            params = self._ensemble_params
        pipe = MaskPipeline(
            self.critic, self.masker, params,
            batch_size=batch,
            salience=salience,
            eval_mode=not self.cfg.noevalmode,   # main.py:900-909
            separate=self.cfg.separate and not ensemble,
            seed=self.cfg.seed,
            ensemble=ensemble,
            wire=wire,
            hard_threshold=hard_threshold,
            device=self.device, mesh=mesh)
        self._pipes[cache_key] = pipe
        return pipe

    def _crf_fn(self):
        """The DenseCRF under -crf; None without it, or, with a message,
        when the library cannot be built or loaded
        (cgs_tpu/handler.py:582-592)."""
        if not self.cfg.crf:
            return None
        from cgs_tpu_torch.eval.crf import DenseCRF
        try:   # rank 0 builds the library before the others load it
            return rank0_first(self.mesh, lambda: DenseCRF(
                rescale=self.cfg.crf_rescale))
        except (OSError, RuntimeError) as e:
            print(f"[cgs-tpu-torch] CRF unavailable ({e}); skipping "
                  "refinement (the reference ships with its pydensecrf "
                  "import commented out, main.py:8,23)")
            return None

    def eval(self, folder: str = "") -> List[float]:
        """IoU eval (main.py:891-1101); with `folder`, evaluates a
        directory of images against an all-zero GT (main.py:917-918)."""
        cfg = self.cfg
        out_dir = f"eval-results/{cfg.name}/"
        if folder not in self._eval_sets:
            self._eval_sets[folder] = load_eval_set(
                cfg, evaldatapath=cfg.evaldatapath, folder=folder)
        x, gt = self._eval_sets[folder]
        pipe = self._pipeline(salience=cfg.salience)
        result = evaluate(cfg, pipe, x, gt, crf_fn=self._crf_fn(),
                          best_iou=self.ious[0], out_dir=out_dir,
                          write=self.primary, mesh=self.mesh)
        ious = result["ious"]
        # the best-tracker update is absent on purpose, as in the
        # reference (main.py:1018)
        print("\nRESULTS", ious)
        self.last_ious = [float(v) for v in ious]
        self.metrics.write("eval", iou=ious[0], all_ious=self.last_ious)
        return ious

    def segment(self, folder: str) -> Dict:
        """-process (main.py:1103-1223) on a folder of 64x64 images, or
        on a video file (`segment_video`). Without -crf the mask comes
        down the reduced wire: PNG-space uint8 plus the device-side
        binarisation (bit-identical PNGs, 1/4 the bytes); the CRF reads
        f32 masks, so -crf keeps the f32 wire."""
        cfg = self.cfg
        wire = "f32" if cfg.crf else "u8"
        hard = (cfg.binarymaskthreshold
                if wire == "u8" and cfg.binarymaskthreshold else None)
        pipe = self._pipeline(salience=cfg.process_salience,
                              wire=wire, hard_threshold=hard)
        driver = (segment_video if os.path.isfile(folder)
                  and folder.lower().endswith(VIDEO_EXTS)
                  else segment_folder)
        return driver(cfg, pipe, folder, crf_fn=self._crf_fn(),
                      write=self.primary)

    def visualize(self) -> List[str]:
        """-viscritic/-vismasker curve videos (main.py:702-885).
        --trainasvis N shows the first N train frames instead of the
        test split, from clean_data under -cleaned (main.py:736-742)."""
        from cgs_tpu_torch.data.collect import clean_data
        from cgs_tpu_torch.eval.visualize import visualize as vis
        cfg = self.cfg
        if cfg.trainasvis:
            if cfg.cleaned:
                x, y, _ = rank0_first(self.mesh, lambda: clean_data(
                    cfg, write=self.primary))
                y = np.tile(y, (7, 1)) if y.ndim == 1 else y
            else:
                x, y, _ = rank0_first(self.mesh, lambda: collect_data(
                    cfg, write=self.primary))
            x = x[: cfg.trainasvis]
            y_mat = y[:, : cfg.trainasvis]
        else:
            if self.data is None:
                self.load_data()
            x = self.data.x_test
            y_mat = self.data.y_test
        pipe = self._pipeline(salience=False)
        return vis(cfg, pipe, x, y_mat[cfg.rewidx], self.path,
                   y_matrix=y_mat, write=self.primary)

    # -- data --------------------------------------------------------

    def load_data(self) -> None:
        """collect -> split -> device (main.py:113-134). Over a mesh
        every rank holds the whole banks; rank 0 collects (and writes the
        cache) first (`cgs_tpu/data/collect.py:93-94`)."""
        x, y, i = rank0_first(self.mesh, lambda: collect_data(
            self.cfg, write=self.primary))
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

    def _train_state(self, phase: str) -> Optional[TrainStateManager]:
        """The phase's train-state manager under -orbax (kept in
        self.train_states), else None; None off rank 0 too, which writes
        the states."""
        if not self.cfg.orbax or (self.mesh is not None
                                  and self.mesh.rank != 0):
            return None
        mgr = TrainStateManager(f"{self.path}saves/orbax-{phase}/")
        self.train_states[phase] = mgr
        return mgr

    def _restore(self, ckpt: Optional[TrainStateManager]):
        """(step, state) of the newest train state or None: rank 0 reads
        it and every rank gets it, with its own dropout-generator state
        in state['rng']."""
        restored = rank0_value(
            self.mesh, lambda: ckpt.restore() if ckpt is not None else None)
        if restored is None or self.mesh is None:
            return restored
        ranks = restored[1].get("dropout_ranks")
        if ranks is None or len(ranks) != self.mesh.world:
            raise ValueError(
                f"the -orbax state in {self.path}saves/ was saved by "
                f"{1 if ranks is None else len(ranks)} rank(s); this run "
                f"has {self.mesh.world}")
        restored[1]["rng"]["dropout"] = ranks[self.mesh.rank]
        return restored

    def _save_state(self, ckpt: Optional[TrainStateManager], step: int,
                    state: dict, rng: StepRng) -> None:
        """Rank 0 writes the train state, with every rank's
        dropout-generator state gathered over the host group."""
        if self.mesh is not None:
            state["dropout_ranks"] = self.mesh.gather_object(
                rng.dropout.get_state())
        if ckpt is not None:
            ckpt.save(step, state)

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
        rng = StepRng.seeded(cfg.seed, self.device, self.mesh)
        viz_rng = StepRng.seeded(cfg.seed + 1, self.device)
        loader = EpochLoader(self.data.n_train, cfg.batch_size, self.rng)
        x_dev, y_dev = self.data.x_train_dev, self.data.y_train_dev

        # -orbax: resume at the saved epoch, every random source included
        ckpt = self._train_state(CRITIC)
        start_epoch = 0
        restored = self._restore(ckpt) if cfg.orbax else None
        if restored is not None:
            start_epoch, state = restored
            critic.load_state_dict(state["models"][CRITIC])
            opt.load_state_dict(state["optimizer"])
            rng.set_state(state["rng"])
            viz_rng.set_state(state["viz_rng"])
            self.rng.bit_generator.state = state["loader"]
            print(f"orbax resume: critic epoch {start_epoch}")

        llog: List[float] = []
        steps = 0
        t0 = time.time()
        for epoch in range(start_epoch, n_epochs):
            b_idx = 0
            # the critic-phase chunk (= viz cadence) is the reference's
            # hard-coded 100 batches (main.py:204); --visevery drives
            # only the masker phase (main.py:466)
            for idx in loader.chunks(100):
                losses = critic_chunk(cfg, critic, opt, x_dev, y_dev, idx,
                                      rng, self.mesh).cpu().numpy()
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
            if cfg.orbax:
                self._save_state(ckpt, epoch + 1, {
                    "models": {CRITIC: critic.state_dict()},
                    "optimizer": opt.state_dict(), "rng": rng.get_state(),
                    "viz_rng": viz_rng.get_state(),
                    "loader": self.rng.bit_generator.state}, rng)
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
            self.rng, min_count=cfg.contrastive_min, mesh=self.mesh)
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

    def segmentation_training(self, on_epoch=None) -> None:
        """Masker training (main.py:314-575). on_epoch(epoch, models,
        losses), if given, sees the device models before the first
        masker epoch of a run that did not resume (epoch 0, losses None)
        and after each epoch e (epoch e + 1, that epoch's (steps, 4)
        losses): the drift probe's hook (`sandbox/drift.py`)."""
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
        set_masker_modes(cfg, models)
        opt = make_optimizer({n: models[n] for n in trained},
                             cfg.critic_lr_scale)
        rng = StepRng.seeded(cfg.seed, self.device, self.mesh)
        viz_rng = StepRng.seeded(cfg.seed + 1, self.device)

        k = 32  # contrastive batch (main.py:309)
        steps_per_epoch = -(-sets.n_pos // k)     # main.py:342

        # -orbax: the saved step is the global step, saved at every
        # chunk boundary, so a run resumes mid-epoch; the index stacks
        # are derived per (epoch, done) and the generators restored
        ckpt = self._train_state(MASKER)
        steps = 0
        restored = self._restore(ckpt) if cfg.orbax else None
        if restored is not None:
            steps, state = restored
            for name, model in models.items():
                model.load_state_dict(state["models"][name])
            opt.load_state_dict(state["optimizer"])
            rng.set_state(state["rng"])
            viz_rng.set_state(state["viz_rng"])
        start_epoch, start_done = divmod(steps, steps_per_epoch)
        if restored is not None:
            print(f"orbax resume: masker epoch {start_epoch} "
                  f"step {start_done}")
        log_rows: List[np.ndarray] = []
        resumed_at = steps
        if on_epoch is not None and restored is None:
            on_epoch(0, models, None)
        t0 = time.time()
        for epoch in range(start_epoch, cfg.mepochs):
            done = start_done if epoch == start_epoch else 0
            epoch_rows = len(log_rows)
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
                    sets.yneg, h, l, c, rng,
                    self.mesh).cpu().numpy()                    # (s, 4)
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
                if cfg.orbax:
                    self._save_state(ckpt, epoch * steps_per_epoch + done, {
                        "models": {n: m.state_dict()
                                   for n, m in models.items()},
                        "optimizer": opt.state_dict(),
                        "rng": rng.get_state(),
                        "viz_rng": viz_rng.get_state()}, rng)

            if on_epoch is not None:
                on_epoch(epoch + 1, models,
                         np.concatenate(log_rows[epoch_rows:], axis=0))
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
        if steps > resumed_at:
            self.metrics.write("masker_throughput",
                               steps_per_sec=(steps - resumed_at) / dt)
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
