"""Rank functions that drive one piece of the data-parallel path and
return what a check compares: `multihost.launch(probe, world, args)`
runs one on every rank (they are module-level, so the spawned ranks
import them from here, and never the caller's module). The CPU tests
and `chip_smoke.py` hold their results against the unmeshed path and
the JAX package. Each uses the world it runs in (`mesh.current_mesh`);
with meshed=False it runs the same code unmeshed, in one process.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from cgs_tpu_torch.parallel.mesh import current_mesh


def _cpu(state) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in state.items()}


def _mesh(meshed: bool):
    mesh = current_mesh() if meshed else None
    if meshed and mesh is None:
        raise RuntimeError("a meshed probe runs inside a launched world")
    return mesh


def _device(mesh, device: Optional[str]):
    return torch.device(device) if mesh is None else mesh.device


@contextlib.contextmanager
def _in_dir(workdirs: Optional[Sequence[str]], mesh):
    """Run in this rank's directory (workdirs[rank]), and come back."""
    if workdirs is None:
        yield
        return
    old = os.getcwd()
    os.chdir(workdirs[0 if mesh is None else mesh.rank])
    try:
        yield
    finally:
        os.chdir(old)


def _optimizer(modules: Dict[str, torch.nn.Module], optim: str):
    from cgs_tpu_torch.train.steps import make_optimizer
    if optim == "adam":
        return make_optimizer(modules)
    if optim == "sgd":
        return torch.optim.SGD([p for m in modules.values()
                                for p in m.parameters()], lr=1e-2)
    raise ValueError(f"optim={optim!r} not in ('adam', 'sgd')")


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def steps(params: Dict, a: np.ndarray, y: np.ndarray, b: np.ndarray,
          chfak: int = 1, optim: str = "adam", meshed: bool = True,
          device: Optional[str] = None, repeat: int = 1) -> dict:
    """One critic step on the frames a (n, 64, 64, 3) uint8 with labels
    y, then one masker step whose A is a[:2k] (k = n // 2; its first k
    rows the 'high' half) and whose B is b[:2k], each through the chunk
    functions, at
    dropout 0 and shift 0, from the state_dicts `params`; repeat > 1
    runs each chunk that many times over the same rows. Over a mesh
    each rank runs its rows. On the card TF32 is off and cuDNN
    deterministic. Returns the losses, the (synced) gradients and the
    parameters after each chunk, on the CPU, each chunk's seconds and,
    over a mesh, the ms of one all_reduce of the masker step's flat
    gradient."""
    from cgs_tpu_torch.core.device import train_switches
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.train.loops import critic_chunk, masker_chunk
    from cgs_tpu_torch.train.steps import StepRng

    mesh = _mesh(meshed)
    dev = _device(mesh, device)
    if dev.type == "cuda":
        train_switches(False)
    cfg = Config(shift=0, dropout=0.0, chfak=chfak,
                 device=str(dev)).derive()

    def model(cls, state):
        m = cls(chfak=chfak, **({"dropout": 0.0} if cls is Critic else {}))
        m = m.to(dev, memory_format=torch.channels_last)
        m.load_state_dict(state)
        return m.train()

    def grads(m):
        return {k: p.grad.detach().cpu().clone()
                for k, p in m.named_parameters() if p.grad is not None}

    n = a.shape[0]
    k = n // 2
    bank = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    labels = torch.from_numpy(np.asarray(y, np.float32)).to(dev)
    rng = StepRng.seeded(0, dev, mesh)

    critic = model(Critic, params["critic"])
    opt = _optimizer({"critic": critic}, optim)
    _sync(dev)
    t0 = time.perf_counter()
    closs = critic_chunk(cfg, critic, opt, bank, labels,
                         np.tile(np.arange(n), (repeat, 1)), rng, mesh)
    _sync(dev)
    out = {"critic_loss": closs.cpu().numpy(), "critic_grads": grads(critic),
           "critic": _cpu(critic.state_dict()),
           "critic_s": time.perf_counter() - t0}

    models = {"critic": model(Critic, params["critic"]),
              "masker": model(UnetDecoder, params["masker"])}
    opt = _optimizer(models, optim)
    neg = torch.cat([bank[k:2 * k], torch.from_numpy(
        np.ascontiguousarray(b[:2 * k])).to(dev)])
    yneg = torch.cat([labels[k:2 * k], labels.new_zeros(2 * k)])
    rows = np.tile(np.arange(k), (repeat, 1))
    _sync(dev)
    t0 = time.perf_counter()
    terms = masker_chunk(cfg, models, opt, bank[:k], labels[:k], neg, yneg,
                         rows, rows, np.concatenate([rows + k, rows + 2 * k],
                                                    axis=1), rng, mesh)
    _sync(dev)
    out.update(masker_terms=terms.cpu().numpy()[0],
               masker_grads={n_: grads(m) for n_, m in models.items()},
               masker={n_: _cpu(m.state_dict()) for n_, m in models.items()},
               masker_s=time.perf_counter() - t0)
    if mesh is not None:
        flat = torch.zeros(sum(p.numel() for m in models.values()
                               for p in m.parameters()), device=dev)
        mesh.mean_(flat)
        _sync(dev)
        t0 = time.perf_counter()
        for _ in range(10):
            mesh.mean_(flat)
        _sync(dev)
        out["allreduce_ms"] = (time.perf_counter() - t0) * 100.0
        out["allreduce_bytes"] = flat.numel() * 4
    return out


def pipeline(params, frames: np.ndarray, batch: int, chfak: int = 1,
             ensemble: bool = False, meshed: bool = True,
             device: Optional[str] = None, **kw) -> dict:
    """`MaskPipeline(...).run(frames)` over the world (the members shard
    over it with ensemble=True when they divide, as the Handler does);
    the outputs as numpy."""
    from cgs_tpu_torch.models.critic import Critic
    from cgs_tpu_torch.models.decoder import UnetDecoder
    from cgs_tpu_torch.parallel.mesh import ensemble_mesh_or_none
    from cgs_tpu_torch.pipeline import MaskPipeline

    mesh = _mesh(meshed)
    dev = _device(mesh, device)
    if ensemble:
        mesh = ensemble_mesh_or_none(mesh, len(params))
    pipe = MaskPipeline(Critic(chfak=chfak), UnetDecoder(chfak=chfak),
                        params, batch_size=batch, ensemble=ensemble,
                        device=dev, mesh=mesh, **kw)
    out = pipe.run(frames)
    return {k: v for k, v in vars(out).items() if v is not None}


def iou(masks: np.ndarray, gt: np.ndarray, thresh: float) -> dict:
    """The eval's mask IoU with its counts summed over the world, and
    this rank's host numpy IoU of the same masks."""
    from cgs_tpu_torch.eval.harness import mask_iou_on_device
    from cgs_tpu_torch.ops.iou import iou as host_iou

    mesh = current_mesh()
    return {"kernel": mask_iou_on_device(masks, gt, thresh, mesh.device,
                                         mesh),
            "host": host_iou(masks > thresh, gt)}


def dropout_draws(seed: int, n: int = 64) -> np.ndarray:
    """n uniform draws from this rank's dropout generator
    (`StepRng.seeded(seed, device, mesh)`)."""
    from cgs_tpu_torch.train.steps import StepRng

    mesh = current_mesh()
    gen = StepRng.seeded(seed, mesh.device, mesh).dropout
    return torch.rand(n, generator=gen, device=mesh.device).cpu().numpy()


def load_models(cfg, workdirs: Sequence[str], names=("critic",)) -> dict:
    """`Handler(cfg).load_models(names)` run in this rank's directory:
    the flag and the params each rank ends up with."""
    from cgs_tpu_torch.handler import Handler

    mesh = current_mesh()
    with _in_dir(workdirs, mesh):
        h = Handler(cfg, primary=False)
        ok = h.load_models(list(names))
        return {"ok": ok, "params": {n: h.params[n] for n in names}}


def _files(root: str):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def cli_run(argv: Sequence[str], workdirs: Optional[Sequence[str]] = None,
            primary: bool = True, meshed: bool = True) -> dict:
    """`cli.main(argv, primary)` in this rank's directory; then the hard
    masks (> --eval-thresh) of the trained models on the test split.
    Returns the params, the eval IoUs (and, under -eval, the host numpy
    IoU of the eval's masks), the masks, the files the rank's directory
    holds, the loss logs and the seconds."""
    from cgs_tpu_torch import cli

    mesh = _mesh(meshed)
    with _in_dir(workdirs, mesh):
        t0 = time.perf_counter()
        h = cli.main(list(argv), primary=primary)
        seconds = time.perf_counter() - t0
        masks = h._pipeline(salience=False).run(h.data.x_test).masks
        eval_host_iou = None
        if h.cfg.eval:        # the eval's masks, IoU counted on the host
            from cgs_tpu_torch.ops.iou import iou as host_iou
            x, gt = h._eval_sets[""]
            em = h._pipeline(salience=h.cfg.salience).run(
                (x * 255).astype(np.uint8)).masks.squeeze(-1)
            eval_host_iou = host_iou(em > h.cfg.eval_thresh, gt)
        files = _files(".") if workdirs is not None else None
    return {"params": h.params, "ious": h.last_ious,
            "eval_host_iou": eval_host_iou,
            "hard": masks.squeeze(-1) > h.cfg.eval_thresh,
            "masks": masks.squeeze(-1), "files": files, "seconds": seconds,
            "loss_log": h.loss_log}


def resume(cfg, workdirs: Sequence[str], phase: str = "critic",
           break_at: int = 2) -> dict:
    """-orbax over the world, in this rank's directory: an uninterrupted
    run (model 'ref'), then a run (model 'res') broken at the
    break_at-th loss row of `phase` ('critic' or 'masker'), as a crash
    would, and resumed in a fresh Handler; primary=False, so the train
    states are the only files written. Returns both runs' params, the
    steps the broken run saved, the resumed run's loss rows and the
    files of this rank's directory."""
    import dataclasses

    from cgs_tpu_torch.handler import Handler
    from cgs_tpu_torch.train.checkpoints import TrainStateManager

    mesh = current_mesh()
    kind = f"{phase}_loss"

    def run(model, broken=False):
        h = Handler(dataclasses.replace(cfg, model=model).derive(),
                    primary=False)
        if broken:
            real, seen = h.metrics.write, {"n": 0}

            def write(k, **kw):
                real(k, **kw)
                if k == kind:
                    seen["n"] += 1
                    if seen["n"] == break_at:
                        raise KeyboardInterrupt("simulated crash")

            h.metrics.write = write
        h.load_data()
        try:
            h.critic_pipe()
            if cfg.mepochs:
                h.segmentation_training()
        except KeyboardInterrupt:
            if not broken:
                raise
        return h

    with _in_dir(workdirs, mesh):
        ref = run("ref")
        run("res", broken=True)
        states = f"res/saves/orbax-{phase}"
        saved = (TrainStateManager(states).steps()
                 if os.path.isdir(states) else [])
        res = run("res")
        files = _files(".")
    return {"ref": ref.params, "res": res.params, "saved": saved,
            "rows": res.loss_log[phase].shape[0], "files": files}


def run_parallel(cfg, x, y, runs: int, base_seed: int = 0, x_eval=None,
                 gt_eval=None, meshed: bool = True,
                 masker_steps: Optional[int] = None) -> dict:
    """`sandbox.seed_parallel.run_parallel` over the world (seeds
    sharded over the ranks), results line and checkpoints off."""
    from cgs_tpu_torch.sandbox.seed_parallel import run_parallel as rp

    return rp(cfg, x, y, runs, base_seed=base_seed, mesh=_mesh(meshed),
              x_eval=x_eval, gt_eval=gt_eval, results_path=None,
              verbose=False, masker_steps=masker_steps)


def collectives(values: Sequence[float]) -> dict:
    """Each of the Mesh's collectives on rank r's values, `values` times
    r + 1: the max of the ranks' first values, the mean of their
    tensors, rank 0's broadcast, the whole tensor assembled from each
    rank's rows of its own, and the gathered ranks."""
    mesh = current_mesh()
    mine = torch.tensor(values, dtype=torch.float32,
                        device=mesh.device) * (mesh.rank + 1)
    rows = mine[mesh.rows(mine.shape[0])]
    return {"max": mesh.max_int(int(mine[0])),
            "mean": mesh.mean_(mine.clone()).cpu().numpy(),
            "bcast": mesh.broadcast_(mine.clone()).cpu().numpy(),
            "whole": mesh.assemble(rows, mine.shape[0]).cpu().numpy(),
            "gathered": mesh.gather_object(mesh.rank)}


def fail_on_rank(rank: int, after_s: float = 0.0) -> None:
    """Rank `rank` raises after `after_s` seconds; the others wait in a
    collective that it never enters."""
    mesh = current_mesh()
    time.sleep(after_s)
    if mesh.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    mesh.barrier()


def serve_joined(argv: Sequence[str], frames: np.ndarray) -> dict:
    """The server in a world already joined (as under torchrun): rank 0
    builds `MaskServer` from `argv` and segments `frames` one request at
    a time; every other rank runs `serve.main(argv)`, as torchrun's
    ranks do. Rank 0's result: its world, whether it is meshed, the
    soft masks."""
    from cgs_tpu_torch import serve
    from cgs_tpu_torch.core.config import parse_args

    mesh = _mesh(True)
    if mesh.rank != 0:
        serve.main(list(argv))
        return {}
    srv = serve.MaskServer(parse_args(list(argv)))
    try:
        masks = np.stack([srv.batcher.submit(f).mask for f in frames])
    finally:
        srv.shutdown()
    return {"world": srv.world, "meshed": srv.mesh is not None,
            "masks": masks}
