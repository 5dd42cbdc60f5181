"""Process-group start-up and the rank launcher (PyTorch port of
`cgs_tpu/parallel/multihost.py:21-68`).

One process per card, SPMD: every rank runs the same program on its own
device and its own rows of each batch. Two process groups:

  * the default group carries the device collectives (`all_reduce` and
    `broadcast` of device tensors): NCCL on cards that each rank holds
    alone, gloo on the CPU and where ranks share a card (gloo carries
    only these two collectives for CUDA tensors);
  * a second group, always gloo, carries host objects (a load's success
    flag, step counts, generator states, the contrastive split).

Two ways in:

  * `ensure_initialized(device)` reads torchrun's `RANK`, `WORLD_SIZE`,
    `LOCAL_RANK`, `MASTER_ADDR` and `MASTER_PORT` (where JAX reads
    `JAX_COORDINATOR_ADDRESS` / `JAX_NUM_PROCESSES` / `JAX_PROCESS_ID`),
    pins the rank's card and joins the group; without a launcher it is
    a no-op, as JAX's is on one host;
  * `launch(fn, world, ...)` makes the calling process rank 0 of a
    fresh world and starts ranks 1..N-1 with `torch.multiprocessing`
    (start method `spawn`), rendezvous through a `file://` in a fresh
    temporary directory, so two launches on one host never race for a
    port. `fn` must be importable by the spawned ranks (a module-level
    function). `start` is its first half, for a rank 0 that goes on with
    work of its own (the HTTP server, `serve.py`) and ends the world
    later with `Ranks.close`.

Every group has a timeout and every join of a rank a limit: a rank that
dies makes rank 0 raise, never hang.
"""

from __future__ import annotations

import datetime
import os
import shutil
import tempfile
import traceback
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist

TIMEOUT_S = 600.0     # a collective waits this long for a missing peer
JOIN_S = 120.0        # rank 0 waits this long for ranks 1.. to exit

_host_group = None    # the gloo group for host objects, while joined
_device: Optional[torch.device] = None


def init_rank(rank: int, world: int, init_method: str,
              device_type: str = "cuda", device_index: Optional[int] = None,
              backend: Optional[str] = None,
              timeout_s: float = TIMEOUT_S) -> torch.device:
    """Join rank `rank` of `world`: pin its card (before any device is
    resolved: `core/device.py` resolves `cuda` to the current card),
    start the device group (NCCL on cuda unless `backend` says gloo, as
    ranks that share a card need: NCCL refuses them; gloo on the CPU)
    and the host group. Returns the rank's device."""
    global _host_group, _device
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    if device_type == "cuda":
        index = rank if device_index is None else device_index
        torch.cuda.set_device(index)
        device = torch.device("cuda", index)
    else:
        device = torch.device("cpu")
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(backend or ("nccl" if device_type == "cuda"
                                        else "gloo"),
                            init_method=init_method, rank=rank,
                            world_size=world, timeout=timeout)
    _host_group = dist.new_group(backend="gloo", timeout=timeout)
    _device = device
    return device


def shutdown() -> None:
    """Leave the process group (no-op when not joined)."""
    global _host_group, _device
    if dist.is_initialized():
        dist.destroy_process_group()
    _host_group = None
    _device = None


def joined() -> bool:
    return dist.is_initialized() and _host_group is not None


def host_group():
    return _host_group


def rank_device() -> Optional[torch.device]:
    return _device


def ensure_initialized(device: str = "cuda") -> bool:
    """Join the group that torchrun describes in the environment, once;
    a no-op without those variables. Returns True when running over
    several ranks."""
    if joined():
        return dist.get_world_size() > 1
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return False
    world = int(os.environ["WORLD_SIZE"])
    local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
    device_type = torch.device(device).type
    init_rank(int(os.environ["RANK"]), world, "env://", device_type,
              device_index=local)
    return world > 1


def is_primary() -> bool:
    """Rank 0 writes artifacts and checkpoints; the others stay
    silent."""
    return not dist.is_initialized() or dist.get_rank() == 0


def broadcast_object(obj: Any, src: int = 0) -> Any:
    """`obj` of rank `src` on every rank, over the host group (pickled:
    only objects this program made travel this way)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_host_group)
    return box[0]


def gather_object(obj: Any) -> Optional[List[Any]]:
    """Every rank's `obj`, in rank order, on rank 0 (None elsewhere)."""
    rank, world = dist.get_rank(), dist.get_world_size()
    out = [None] * world if rank == 0 else None
    dist.gather_object(obj, out, dst=0, group=_host_group)
    return out


# ---------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------

def _worker(rank: int, world: int, init_method: str, device_type: str,
            device_index: Optional[int], backend: Optional[str],
            timeout_s: float, threads: int, fn: Callable, args: tuple,
            gather: bool) -> None:
    torch.set_num_threads(threads)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank if device_index is None
                                     else device_index))
    init_rank(rank, world, init_method, device_type, device_index,
              backend, timeout_s)
    try:
        out = fn(*args)
        if gather:
            gather_object(out)
    except BaseException:
        traceback.print_exc()
        raise
    finally:
        shutdown()


class Ranks:
    """Ranks 1..N-1 of a world that `start` spawned, this process its
    rank 0."""

    def __init__(self, procs: list, rdzv: str):
        self.procs, self._rdzv = procs, rdzv

    def close(self, join_s: float = JOIN_S, check: bool = True) -> None:
        """Leave the group, wait up to join_s for the ranks to exit and
        kill any left; with check, raise if any failed or outlived
        join_s."""
        shutdown()
        try:
            for p in self.procs:
                p.join(join_s)
            failed = {r: p.exitcode for r, p in enumerate(self.procs, 1)
                      if p.exitcode != 0}
            if check and failed:
                raise RuntimeError(
                    f"rank(s) {sorted(failed)} of {len(self.procs) + 1} "
                    f"failed or did not exit within {join_s:.0f} s (exit "
                    f"codes {failed})")
        finally:
            for p in self.procs:
                if p.is_alive():
                    p.kill()
                    p.join(10)
            shutil.rmtree(self._rdzv, ignore_errors=True)


def start(fn: Callable, world: int, args: Sequence = (),
          device: str = "cuda", backend: Optional[str] = None,
          device_indices: Optional[Sequence[int]] = None,
          gather: bool = False, timeout_s: float = TIMEOUT_S) -> Ranks:
    """Make this process rank 0 of a fresh world of `world` ranks and
    spawn ranks 1..world-1, each running `fn(*args)` pinned to its card
    (`device_indices[r]`, default card r) or the CPU, and leaving when
    it returns (with gather=True, after sending its result to rank 0).
    Returns once this process has joined; rank 0's own part is the
    caller's, and `Ranks.close` ends the world."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    device_type = torch.device(device).type
    if device_indices is not None and len(device_indices) != world:
        raise ValueError(f"device_indices names {len(device_indices)} "
                         f"cards for {world} ranks")
    index = (lambda r: None) if device_indices is None else \
        (lambda r: int(device_indices[r]))
    rdzv = tempfile.mkdtemp(prefix="cgs-rdzv-")
    init_method = "file://" + os.path.join(rdzv, "store")
    ctx = torch.multiprocessing.get_context("spawn")
    ranks = Ranks([ctx.Process(
        target=_worker, daemon=True,
        args=(r, world, init_method, device_type, index(r), backend,
              timeout_s, torch.get_num_threads(), fn, tuple(args), gather))
        for r in range(1, world)], rdzv)
    try:
        for p in ranks.procs:
            p.start()
        init_rank(0, world, init_method, device_type, index(0), backend,
                  timeout_s)
    except BaseException:
        ranks.close(0.0, check=False)
        raise
    return ranks


def launch(fn: Callable, world: int, args: Sequence = (),
           device: str = "cuda", backend: Optional[str] = None,
           device_indices: Optional[Sequence[int]] = None,
           gather: bool = False, timeout_s: float = TIMEOUT_S,
           join_s: float = JOIN_S) -> Any:
    """Run `fn(*args)` on `world` ranks: this process is rank 0, ranks
    1..world-1 are spawned processes, each pinned to its card
    (`device_indices[r]`, default card r) or the CPU. Returns rank 0's
    result, or with gather=True every rank's, in rank order (results
    travel pickled over the host group). Raises if any rank fails; the
    spawned ranks are killed on the way out whatever happens. World 1
    starts no process."""
    ranks = start(fn, world, args, device, backend, device_indices, gather,
                  timeout_s)
    done = False
    try:
        out = fn(*args)
        if gather:
            out = gather_object(out)
        done = True
    finally:
        ranks.close(join_s if done else 0.0, check=done)
    return out
