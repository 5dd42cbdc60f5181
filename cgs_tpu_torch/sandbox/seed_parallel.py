"""Seed-parallel multirun: train all R seeds of the paper's multi-seed
protocol at once, one set of device launches per step (PyTorch port of
`cgs_tpu/sandbox/seed_parallel.py`).

The JAX package vmaps its two-phase training over a leading seed axis.
Here the seed axis is written out (`models/seeded.py`): R seeds'
weights stacked in one `SeededCritic` / `SeededDecoder`, every
convolution one grouped cuDNN call over the seeds, the head's linears
one `torch.bmm` each, and every port kernel (the ingest, the merges and
their gradient, the decoder's upsample-into-concat pair, the IoU count)
one launch over the R seeds' frames, which lie in its batch. A step
makes the same device operations for any R, each R times larger; the
loss is the sum of the seeds' losses and one Adam runs over the stacked
tensors, so each seed trains as it would alone. The frame bank is
shared: every seed indexes it with its own absolute index stacks.

    python -m cgs_tpu_torch.sandbox.seed_parallel --runs 10 -synthetic_data \\
        --synthetic-variant hard --datasize 40000 --cepochs 15 \\
        --chfak 5 --dropout 0.5 -frozen --model sp

runs on the card (`--device cpu` for the CPU); `--base-seed B` trains
seeds B..B+R-1, `--chunk-steps S` sets how many steps run between two
read-backs of the losses (eager PyTorch has no scan to bound, so a chunk
is only the read-back cadence).

Protocol, as the JAX runner (not silent deviations from the serial
runner, `sandbox/multirun.py`):
  * the masker phase runs a common step count ceil(max_r |pos_r| / K)
    for every seed (the serial runners use each seed's own);
  * the numpy streams are the JAX runner's: seed r draws its epoch
    permutations (with wrap) and its index stacks from
    `default_rng(base_seed + r)`, in the JAX order, and every seed
    trains on the data of `cfg.seed`;
  * eval is the mask IoU at --eval-thresh per seed and of the R-seed
    mean mask, on seed 99's synthetic eval set, without the CRF and
    saliency variants.
Seed r starts from the weights `Handler(--seed base_seed + r)` draws
(PyTorch's default init from a generator seeded with the seed) and
draws its shifts from a CPU generator of its own, seeded with its seed
and its dropout masks from a device generator of its own, seeded with
its seed too (`SeedRng`): seed r's shifts and masks are those of the
serial step of seed r (`train/steps.py:StepRng.seeded`), whatever R and
the base seed are. These streams differ from `jax.random`'s.

One JAX mechanism has no counterpart: the padded tail steps masked to
identities (`valid`) exist only to reuse one compiled shape, and the
port runs exactly the steps it needs.

`mesh=` (a `parallel.mesh.Mesh`; port of `cgs_tpu/sandbox/seed_parallel.
py:96-122,338-400,578-604`) shards the seed axis over the ranks, one
process per card: rank r trains seeds [rR/N, (r+1)R/N) (R % N == 0,
else ValueError), each with its own streams exactly as unmeshed; the
seeds never talk, so the only collectives are the masker phase's common
step count (an all-reduce MAX: every seed trains for the largest seed's
count) and, at the end, the per-seed parameters, losses and IoUs
gathered on rank 0, which evaluates the ensemble on all R seeds, writes
the checkpoints and the results line, and returns the whole result (the
other ranks return their own seeds'). This is the counterpart of JAX's
seed-per-device `shard_map` over a local mesh; JAX's `run_parallel`
refuses a multi-process world (`cgs_tpu/sandbox/seed_parallel.py:
368-374`), the port runs one.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from cgs_tpu_torch.core.device import resolve_device, train_switches
from cgs_tpu_torch.models.interop import (
    init_torch_default, stack_state_dicts, unstack_seed,
)
from cgs_tpu_torch.models.seeded import (
    SeededCritic, SeededDecoder, shared_seed_major,
)
from cgs_tpu_torch.ops.augment import draw_shift
from cgs_tpu_torch.ops.kernels import Segment, threshold_iou
from cgs_tpu_torch.ops.merge import merge_both, replace_merge
from cgs_tpu_torch.parallel.mesh import seed_shard_tree
from cgs_tpu_torch.train.loops import _upload
from cgs_tpu_torch.train.losses import (
    bce_rows, ingest, ingest_segments, masker_terms, mse_rows,
)
from cgs_tpu_torch.train.steps import (
    _apply, make_optimizer, trained_param_keys,
)

K = 32  # contrastive batch (main.py:309)


@dataclasses.dataclass
class SeedRng:
    """The generators a seeded step draws from, one pair per seed: a CPU
    generator for its shifts and a device generator for its dropout
    masks, both seeded with the seed, as the serial step's `StepRng`
    (`train/steps.py`) seeds its pair."""
    shifts: List[torch.Generator]
    dropout: List[torch.Generator]

    @classmethod
    def seeded(cls, seeds: Sequence[int], device) -> "SeedRng":
        seeds = [int(s) for s in seeds]
        return cls([torch.Generator().manual_seed(s) for s in seeds],
                   [torch.Generator(device=device).manual_seed(s)
                    for s in seeds])


# ---------------------------------------------------------------------
# init and models
# ---------------------------------------------------------------------

def init_seed_params(critic, masker, seeds: Sequence[int],
                     separate: bool = False) -> Dict[str, Dict]:
    """{critic, masker[, sepcrit]} seeded state_dicts (CPU) of the given
    seeds, seed r drawn as `Handler(--seed seeds[r])` draws its weights
    (`handler.py:reset_models`): PyTorch's default init from a generator
    seeded with the seed, critic, masker, then sepcrit. critic, masker:
    single-seed templates (`Critic`, `UnetDecoder`) of the run's
    widths; their weights are overwritten."""
    names = ["critic", "masker"] + (["sepcrit"] if separate else [])
    per = {name: [] for name in names}
    for seed in seeds:
        gen = torch.Generator().manual_seed(int(seed))
        for name in names:
            template = masker if name == "masker" else critic
            init_torch_default(template, gen)
            per[name].append({k: v.detach().clone()
                              for k, v in template.state_dict().items()})
    return {name: stack_state_dicts(states) for name, states in per.items()}


def require_paper_critic(cfg) -> None:
    """The runner stacks R seeds of the paper's critic
    (`models/seeded.py`) and no other: refuse any other `--critic`
    rather than train the paper's in its place."""
    if cfg.critic_arch != "paper":
        raise ValueError(
            f"--critic {cfg.critic_arch}: the seed-parallel runner trains "
            "the paper's critic only (models/seeded.py); run "
            "sandbox/multirun.py for the other critics")


def _build_models(cfg, seeds: int):
    """(SeededCritic, SeededDecoder) per the Config: neck and chfak
    widths, --dropout, --bf16 compute."""
    cdt = torch.bfloat16 if cfg.bf16 else torch.float32
    critic = SeededCritic(seeds, bottleneck=cfg.neck, chfak=cfg.chfak,
                          dropout=cfg.dropout, compute_dtype=cdt)
    masker = SeededDecoder(seeds, bottleneck=cfg.neck, chfak=cfg.chfak,
                           compute_dtype=cdt)
    return critic, masker


def _on_device(template: torch.nn.Module, state, device) -> torch.nn.Module:
    model = copy.deepcopy(template).to(device,
                                       memory_format=torch.channels_last)
    model.load_state_dict(state)
    return model.train()


def _cpu_state(model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone()
            for k, v in model.state_dict().items()}


# ---------------------------------------------------------------------
# steps and chunks
# ---------------------------------------------------------------------

def _shifted(cfg, seg: Segment, rng: SeedRng, shifts) -> Segment:
    """seg with each seed's roll: the given shifts, else one draw from
    each seed's generator (none when --shift is 0)."""
    if shifts is not None:
        return seg._replace(shift=[int(s) for s in shifts])
    if not cfg.shift:
        return seg
    return seg._replace(shift=[draw_shift(int(cfg.shift), g)
                               for g in rng.shifts])


def seeded_critic_step(cfg, critic: SeededCritic, optimizer, x: Segment,
                       rng: SeedRng, shifts=None) -> torch.Tensor:
    """One critic step of R seeds (main.py:182-199): x names seed r's
    batch in row r of its (R, B) index and carries the labels. Returns
    the detached (R,) losses."""
    r = x.seeds
    xf, y = ingest_segments([_shifted(cfg, x, rng, shifts)])
    pred = critic(xf, generators=rng.dropout)              # (R, B)
    y = y.view(r, -1)
    losses = (bce_rows if cfg.threshrew else mse_rows)(pred, y)
    _apply(optimizer, losses.sum())
    return losses.detach()


def seeded_masker_loss(cfg):
    """(models {'critic', 'masker'[, 'sepcrit']} seeded, ab the parted
    (2*R*n) batch A || B, y (R, n), one dropout generator per seed) ->
    (loss, terms (R, 4)): the critic passes of `train/losses.py:build_masker_loss`
    (fuse "both") over R seeds, each seed's loss from
    `train/losses.py:masker_terms`, the loss their sum. The terms are
    (replace, inject, norm, critic) per seed."""
    inject, separate = bool(cfg.inject), bool(cfg.separate)

    def loss_fn(models, ab, y, generators=None):
        critic = models["critic"]
        r, n = y.shape
        a, b = ab[:r * n], ab[r * n:]
        out, embeds = critic(ab, parts=2, collect=True,
                             generators=generators)
        pred, negpred = out[:, :n], out[:, n:].detach()
        embeds = [e[:n] for e in embeds]
        if separate:                               # main.py:389-390
            _, embeds = models["sepcrit"](a, collect=True,
                                          generators=generators)
        z = models["masker"](a, embeds)            # (R*n, 1, H, W)
        injectvalue = None
        if inject:                                 # main.py:395,406
            vals = critic(merge_both(a, b, z), parts=2,
                          generators=generators)
            replacevalue, injectvalue = vals[:, :n], vals[:, n:]
        else:
            replacevalue = critic(replace_merge(a, b, z),
                                  generators=generators)
        loss, *terms = masker_terms(cfg, pred, negpred, y, z, replacevalue,
                                    injectvalue)
        return loss.sum(), torch.stack(terms, 1)

    return loss_fn


def seeded_masker_step(cfg, models: Dict[str, torch.nn.Module], optimizer,
                       a: Segment, b: Segment, rng: SeedRng,
                       shifts=None) -> torch.Tensor:
    """One masker step of R seeds (main.py:340-463): a names seed r's
    A = [K high || K low] in row r of its (R, 2K) index, with labels; b
    its 2K contrast-negatives. Only A rolls, each seed by its own
    shift. One ingest launch writes A || B of every seed. Returns the
    detached (R, 4) loss terms."""
    ab, y = ingest_segments([_shifted(cfg, a, rng, shifts), b])
    loss, terms = seeded_masker_loss(cfg)(models, ab, y.view(a.seeds, -1),
                                          rng.dropout)
    _apply(optimizer, loss)
    return terms.detach()


def _per_step(idx: np.ndarray, bound: int, device) -> torch.Tensor:
    """(R, S, B) host index stacks -> (S, R, B) on the device, so step
    s reads one contiguous (R, B) block."""
    return _upload(np.ascontiguousarray(np.swapaxes(idx, 0, 1)), bound,
                   device)


def seeded_critic_chunk(cfg, critic: SeededCritic, optimizer, x_bank,
                        y_bank, idx: np.ndarray, rng: SeedRng,
                        shifts: Optional[np.ndarray] = None
                        ) -> torch.Tensor:
    """S critic steps of R seeds, seed r's batches in idx[r] (R, S, B);
    shifts (S, R) if given. Returns the (R, S) losses on the device."""
    idx_dev = _per_step(idx, x_bank.shape[0], x_bank.device)
    losses = [seeded_critic_step(
        cfg, critic, optimizer, Segment(x_bank, idx_dev[s], labels=y_bank),
        rng, None if shifts is None else shifts[s])
        for s in range(idx_dev.shape[0])]
    return torch.stack(losses, 1)


def seeded_masker_chunk(cfg, models, optimizer, x_bank, y_bank,
                        hidx: np.ndarray, lidx: np.ndarray,
                        cidx: np.ndarray, rng: SeedRng,
                        shifts: Optional[np.ndarray] = None
                        ) -> torch.Tensor:
    """S masker steps of R seeds over one shared bank with absolute
    index stacks hidx, lidx (R, S, K) and cidx (R, S, 2K); shifts (S, R)
    if given. Returns the (R, S, 4) loss terms on the device."""
    a_idx = _per_step(np.concatenate([hidx, lidx], axis=2),
                      x_bank.shape[0], x_bank.device)
    b_idx = _per_step(cidx, x_bank.shape[0], x_bank.device)
    terms = [seeded_masker_step(
        cfg, models, optimizer, Segment(x_bank, a_idx[s], labels=y_bank),
        Segment(x_bank, b_idx[s]), rng,
        None if shifts is None else shifts[s])
        for s in range(a_idx.shape[0])]
    return torch.stack(terms, 1)


# ---------------------------------------------------------------------
# sweep and eval
# ---------------------------------------------------------------------

def _sweep_batch(critic, runs: int, cap: int = 4096) -> int:
    """The JAX runner's sweep width: batch * R * chfak held at the
    chfak-1 / R-10 point (4096 x 10), in multiples of 256."""
    ch = int(getattr(critic, "chfak", 1) or 1)
    b = (cap * 10) // max(runs * ch, 1)
    return max(256, min(cap, (b // 256) * 256))


def seeded_sweep(critic: SeededCritic, x_dev: torch.Tensor, n: int,
                 batch: Optional[int] = None) -> np.ndarray:
    """(R, n) host preds of the first n frames of x_dev, every seed's
    critic in eval mode (main.py:245-253)."""
    batch = batch or _sweep_batch(critic, critic.seeds)
    was_training = critic.training
    critic.eval()
    try:
        with torch.no_grad():
            preds = [critic(ingest(x_dev[lo:min(lo + batch, n)]),
                            shared=True)
                     for lo in range(0, n, batch)]
    finally:
        critic.train(was_training)
    return torch.cat(preds, 1).cpu().numpy()


def _eval_loop(critic, masker, x_eval, gt, batch, sepcrit, count):
    """count(z, g) for each batch of the eval set: z (R, b, H*W) every
    seed's masks, in eval mode, from the sepcrit's features in a
    -separate run (pipeline.py:140-144) and the critic's otherwise; g
    (b, H*W) the batch's GT."""
    mods = [m for m in (critic, masker, sepcrit) if m is not None]
    was = [m.training for m in mods]
    for m in mods:
        m.eval()
    src = critic if sepcrit is None else sepcrit
    gt = torch.as_tensor(gt, device=x_eval.device)
    n = int(x_eval.shape[0])
    try:
        with torch.no_grad():
            for lo in range(0, n, batch):
                hi = min(lo + batch, n)
                xb = ingest(x_eval[lo:hi])
                _, em = src(xb, shared=True, collect=True)
                z = masker(shared_seed_major(xb, masker.seeds), em)
                count(z.reshape(masker.seeds, hi - lo, -1),
                      gt[lo:hi].reshape(hi - lo, -1))
    finally:
        for m, w in zip(mods, was):
            m.train(w)


def eval_seeds(critic: SeededCritic, masker: SeededDecoder, x_eval, gt,
               thresh: float = 0.05, batch: int = 256,
               sepcrit: Optional[SeededCritic] = None) -> np.ndarray:
    """(R,) mask IoUs against GT at --eval-thresh (main.py:964,
    1265-1270), the counts from `threshold_iou` (one launch per seed
    and batch) summed on the device. x_eval uint8 (N, 64, 64, 3) on the
    models' device, gt bool (N, 64, 64)."""
    r = masker.seeds
    inter = torch.zeros(r, dtype=torch.int64, device=x_eval.device)
    union = torch.zeros_like(inter)

    def count(z, g):
        for s in range(r):
            i, u = threshold_iou(z[s], g, thresh)
            inter[s] += i
            union[s] += u

    _eval_loop(critic, masker, x_eval, gt, batch, sepcrit, count)
    inter, union = inter.cpu().numpy(), union.cpu().numpy()
    return inter / np.maximum(union, 1)


def ensemble_iou(critic: SeededCritic, masker: SeededDecoder, x_eval, gt,
                 thresh: float = 0.05, batch: int = 256,
                 sepcrit: Optional[SeededCritic] = None) -> float:
    """IoU of the R-seed mean mask at --eval-thresh (one `threshold_iou`
    launch per batch)."""
    counts = torch.zeros(2, dtype=torch.int64, device=x_eval.device)

    def count(z, g):
        i, u = threshold_iou(z.mean(0).contiguous(), g, thresh)
        counts[0] += i
        counts[1] += u

    _eval_loop(critic, masker, x_eval, gt, batch, sepcrit, count)
    inter, union = (int(v) for v in counts.cpu())
    return inter / max(union, 1)


# ---------------------------------------------------------------------
# the runner
# ---------------------------------------------------------------------

def run_parallel(cfg, x, y, runs: int, base_seed: int = 0, mesh=None,
                 x_eval=None, gt_eval=None,
                 results_path: Optional[str] = "results.txt",
                 chunk_steps: int = 100, verbose: bool = True,
                 save_checkpoints: bool = False,
                 masker_steps: Optional[int] = None) -> dict:
    """Two-phase training of `runs` seeds at once on one bank, on
    cfg.device.

    cfg: a derived Config; x (N, 64, 64, 3) uint8 and y (7, N) labels as
    `collect_data` returns them. Critic phase: cfg.cepochs epochs of
    per-seed shuffled batches (main.py:182-199). Contrastive split per
    seed and masker phase per main.py:238-463, for the common step
    count. Eval, given (x_eval, gt_eval): each seed's mask IoU and the
    R-seed mean-mask IoU. save_checkpoints: reference-layout .pt files
    per seed under `{model}-seed{s}/saves/`, the phase-1 critic (the
    reference never saves the masker phase's live critic,
    main.py:565,575,1561-1564) and the final masker, which `--ensemble`
    loads. A -separate run's sepcrit is trained and used for eval
    features but not saved, as in the reference. masker_steps: the
    masker phase's steps per epoch in place of the common count (so one
    seed alone can run, and draw its index stacks in, the chunks it ran
    beside others).

    Returns {'params', 'elapsed_s', 'steps', 'critic_losses' (R, S),
    'masker_losses' (R, S, 4), 'seconds' per phase; with eval 'ious',
    'mean', 'std', 'best', 'ensemble_iou'}; the results.txt line is the
    JAX runner's.

    mesh: this rank's `parallel.mesh.Mesh` (module docstring): the
    seeds shard over the ranks, rank 0 returns the whole result and
    writes the files, the other ranks return their own seeds' 'seeds',
    'params', 'closses', 'mlosses', 'contrastive' and 'ious'."""
    from cgs_tpu_torch.data.loader import DataBundle
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder

    require_paper_critic(cfg)
    if runs < 1:
        raise ValueError(f"runs must be >= 1, got {runs}")
    if masker_steps is not None and masker_steps < 1:
        raise ValueError(f"masker_steps must be >= 1, got {masker_steps}")
    if mesh is not None and runs % mesh.world:
        raise ValueError(f"runs={runs} must divide over the {mesh.world} "
                         "ranks for seed-per-rank sharding")
    device = resolve_device(cfg.device)
    t0 = time.time()
    bundle = DataBundle.from_arrays(
        x, y, np.arange(x.shape[0], dtype=np.int64), cfg)
    bundle.to_device(cfg, device)
    x_dev, y_dev = bundle.x_train_dev, bundle.y_train_dev
    n_train = bundle.n_train

    all_seeds = list(range(base_seed, base_seed + runs))
    seeds = seed_shard_tree(mesh, all_seeds)    # this rank's seeds
    ccritic, cmasker = _build_models(cfg, len(seeds))
    init = init_seed_params(
        Critic(bottleneck=cfg.neck, chfak=cfg.chfak),
        UnetDecoder(bottleneck=cfg.neck, chfak=cfg.chfak), seeds,
        separate=cfg.separate)
    rngs = [np.random.default_rng(s) for s in seeds]
    rng = SeedRng.seeded(seeds, device)
    seconds = {}

    # ---- phase 1: critic (main.py:158-236) ---------------------------
    critic = _on_device(ccritic, init["critic"], device)
    opt = make_optimizer({"critic": critic})
    bsz = int(cfg.batch_size)
    steps_epoch = -(-n_train // bsz)
    cchunk_steps = min(chunk_steps, steps_epoch)
    closses = []
    t1 = time.time()
    for epoch in range(cfg.cepochs):
        stacks = []                 # per-seed shuffled epoch with wrap
        for g in rngs:
            perm = g.permutation(n_train).astype(np.int32)
            pad = steps_epoch * bsz - n_train
            if pad:
                perm = np.concatenate([perm, perm[:pad]])
            stacks.append(perm.reshape(steps_epoch, bsz))
        idx_all = np.stack(stacks)                  # (R, S_epoch, B)
        for s0 in range(0, steps_epoch, cchunk_steps):
            losses = seeded_critic_chunk(
                cfg, critic, opt, x_dev, y_dev,
                idx_all[:, s0:s0 + cchunk_steps], rng).cpu().numpy()
            closses.append(losses)
        if verbose:
            print(f"[seed-parallel] critic epoch {epoch + 1}/{cfg.cepochs} "
                  f"loss/seed {losses[:, -1].round(4)}", flush=True)
    seconds["critic"] = time.time() - t1
    critic_steps = cfg.cepochs * steps_epoch
    critic_p1 = _cpu_state(critic) if save_checkpoints else None

    # ---- contrastive split (main.py:238-312), per seed ----------------
    preds = seeded_sweep(critic, x_dev, n_train)
    pos_lists, neg_lists = [], []
    for r, seed in enumerate(seeds):
        pos = np.nonzero(preds[r] > cfg.high_rew_thresh)[0]
        neg = np.nonzero(preds[r] < cfg.low_rew_thresh)[0]
        assert len(pos) >= cfg.contrastive_min \
            and len(neg) >= cfg.contrastive_min, (
                f"seed {seed}: contrastive split too small ({len(pos)} pos "
                f"/ {len(neg)} neg, need >={cfg.contrastive_min} each, "
                "main.py:281)")
        assert preds[r][pos].mean() > cfg.high_rew_thresh  # main.py:302
        pos_lists.append(pos)
        neg_lists.append(neg)

    # ---- phase 2: masker (main.py:314-575) ----------------------------
    trained = trained_param_keys(cfg)
    models = {"critic": critic,
              "masker": _on_device(cmasker, init["masker"], device)}
    if cfg.separate:
        models["sepcrit"] = _on_device(ccritic, init["sepcrit"], device)
    for name, model in models.items():
        model.requires_grad_(name in trained)
    opt = make_optimizer({n: models[n] for n in trained},
                         cfg.critic_lr_scale)
    # common step count: ceil(max |pos| / K) (module docstring), the
    # largest over the ranks' seeds
    steps_masker = (-(-max(len(p) for p in pos_lists) // K)
                    if masker_steps is None else masker_steps)
    if mesh is not None:
        steps_masker = mesh.max_int(steps_masker)
    mchunk_steps = min(chunk_steps, steps_masker)
    mlosses = []
    t1 = time.time()
    for epoch in range(cfg.mepochs):
        for s0 in range(0, steps_masker, mchunk_steps):
            s = min(mchunk_steps, steps_masker - s0)
            # the JAX runner draws a full chunk each time, in this order
            h = np.stack([g.choice(p, (mchunk_steps, K))
                          for g, p in zip(rngs, pos_lists)])
            l = np.stack([g.choice(q, (mchunk_steps, K))
                          for g, q in zip(rngs, neg_lists)])
            c = np.stack([g.choice(q, (mchunk_steps, 2 * K))
                          for g, q in zip(rngs, neg_lists)])
            losses = seeded_masker_chunk(
                cfg, models, opt, x_dev, y_dev, h[:, :s], l[:, :s],
                c[:, :s], rng).cpu().numpy()
            mlosses.append(losses)
        if verbose:
            print(f"[seed-parallel] masker epoch {epoch + 1}/{cfg.mepochs} "
                  f"replace/seed {losses[:, -1, 0].round(4)}", flush=True)
    seconds["masker"] = time.time() - t1
    params = {name: _cpu_state(m) for name, m in models.items()}
    closses = np.concatenate(closses, axis=1)
    mlosses = np.concatenate(mlosses, axis=1)
    contrastive = [[len(p), len(q)] for p, q in zip(pos_lists, neg_lists)]
    ev = None
    if x_eval is not None and gt_eval is not None:
        t1 = time.time()
        xe = torch.from_numpy(np.ascontiguousarray(x_eval)).to(device)
        ge = torch.from_numpy(np.ascontiguousarray(gt_eval)).to(device)
        ev = dict(x_eval=xe, gt=ge, thresh=cfg.eval_thresh)
        arr = np.asarray(eval_seeds(critic, models["masker"],
                                    sepcrit=models.get("sepcrit"), **ev),
                         np.float64)
        seconds["eval"] = time.time() - t1
    if mesh is not None:
        mine = {"seeds": seeds, "params": params, "critic_p1": critic_p1,
                "closses": closses, "mlosses": mlosses,
                "contrastive": contrastive,
                "ious": None if ev is None else arr}
        parts = mesh.gather_object(mine)
        if mesh.rank != 0:
            mine.update(seconds=seconds, elapsed_s=time.time() - t0)
            return mine
        seeds = all_seeds
        params = {name: {k: torch.cat([p["params"][name][k] for p in parts])
                         for k in params[name]} for name in params}
        if save_checkpoints:
            critic_p1 = {k: torch.cat([p["critic_p1"][k] for p in parts])
                         for k in critic_p1}
        closses = np.concatenate([p["closses"] for p in parts])
        mlosses = np.concatenate([p["mlosses"] for p in parts])
        contrastive = [c for p in parts for c in p["contrastive"]]
        if ev is not None:
            arr = np.concatenate([p["ious"] for p in parts])
            # the ensemble's models: all R seeds, on rank 0
            ccritic, cmasker = _build_models(cfg, runs)
            critic = _on_device(ccritic, params["critic"], device)
            models = {"masker": _on_device(cmasker, params["masker"],
                                           device)}
            if cfg.separate:
                models["sepcrit"] = _on_device(ccritic, params["sepcrit"],
                                               device)

    if save_checkpoints:
        from cgs_tpu_torch.train.checkpoints import (
            checkpoint_paths, save_model_pt,
        )
        for r, seed in enumerate(seeds):
            paths = checkpoint_paths(dataclasses.replace(
                cfg, model=f"{cfg.model}-seed{seed}").derive())
            save_model_pt(unstack_seed(critic_p1, r, runs), "critic",
                          paths["critic"])
            save_model_pt(unstack_seed(params["masker"], r, runs),
                          "masker", paths["masker"])

    # ---- eval (main.py:891-1101, the mask variant) --------------------
    out = {"params": params, "seeds": seeds,
           "steps": {"critic": critic_steps,
                     "masker": cfg.mepochs * steps_masker},
           "critic_losses": closses, "masker_losses": mlosses,
           "contrastive": contrastive}
    if ev is not None:
        t1 = time.time()
        ens = ensemble_iou(critic, models["masker"],
                           sepcrit=models.get("sepcrit"), **ev)
        seconds["eval"] += time.time() - t1
        out.update(ious=arr.tolist(), mean=float(arr.mean()),
                   std=float(arr.std()), best=float(arr.max()),
                   ensemble_iou=ens)
        if results_path:
            line = (f"runs={runs} seed-parallel base_seed={base_seed} "
                    f"ious={[round(v, 3) for v in arr.tolist()]} "
                    f"mean={out['mean']:.3f} std={out['std']:.3f} "
                    f"best={out['best']:.3f} ensemble={ens:.3f}\n")
            with open(results_path, "a") as fp:
                fp.write(line)
    out["seconds"] = seconds
    out["elapsed_s"] = time.time() - t0
    return out


def main(argv: Optional[List[str]] = None) -> dict:
    """`python -m cgs_tpu_torch.sandbox.seed_parallel --runs N
    [--base-seed B] [--chunk-steps S] <cli args>`: synthetic or cached
    data per the standard flags, eval against seed 99's synthetic eval
    set, per-seed checkpoints written. On the card it sets what the
    CLI's -train sets: TF32 off in f32, deterministic cuDNN. Over the
    ranks --data-parallel asks for (as `cli.main` starts them) the seeds
    shard over the ranks; returns rank 0's result."""
    import sys

    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.parallel.mesh import run_over_ranks
    from cgs_tpu_torch.parallel.multihost import ensure_initialized
    from cgs_tpu_torch.sandbox.multirun import pop_int, pop_runs

    argv = list(argv if argv is not None else sys.argv[1:])
    runs = pop_runs(argv)
    chunk_steps = pop_int(argv, "--chunk-steps", 100)
    if chunk_steps < 1:
        raise SystemExit(f"--chunk-steps must be >= 1 (got {chunk_steps})")
    base_seed = pop_int(argv, "--base-seed", 0)
    cfg = parse_args(argv)
    require_paper_critic(cfg)
    ensure_initialized(cfg.device)
    return run_over_ranks(cfg, _main_rank, cfg, runs, base_seed,
                          chunk_steps)


def _main_rank(cfg, runs: int, base_seed: int, chunk_steps: int) -> dict:
    """`main` on one rank."""
    from cgs_tpu_torch.data.collect import collect_data
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set
    from cgs_tpu_torch.parallel.mesh import local_mesh_or_none, rank0_first
    from cgs_tpu_torch.parallel.multihost import is_primary

    if resolve_device(cfg.device).type == "cuda":
        print("[seed-parallel] switches:", train_switches(cfg.bf16))
    mesh = local_mesh_or_none(cfg)
    x, y, _ = rank0_first(mesh, lambda: collect_data(
        cfg, write=is_primary()))
    x_eval, gt = synthetic_eval_set(n_frames=5000, seed=99,
                                    variant=cfg.synthetic_variant)
    x_eval, gt = x_eval[100:5000:2], gt[100:5000:2]  # main.py:927-928
    out = run_parallel(cfg, x, y, runs, base_seed=base_seed, mesh=mesh,
                       x_eval=x_eval, gt_eval=gt, chunk_steps=chunk_steps,
                       save_checkpoints=True)
    if "ensemble_iou" in out:                        # rank 0
        print(f"[seed-parallel] ious={np.round(out['ious'], 3)} "
              f"mean={out['mean']:.3f} best={out['best']:.3f} "
              f"ensemble={out['ensemble_iou']:.3f} "
              f"({out['elapsed_s']:.1f}s)")
    return out


if __name__ == "__main__":
    main()
