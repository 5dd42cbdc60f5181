"""The data-parallel layout over ranks (PyTorch port of
`cgs_tpu/parallel/mesh.py`).

JAX runs one process over a mesh of local devices and lets XLA insert
the collectives. Here one process runs per card (`parallel/multihost.py`)
and the collectives are explicit: a `Mesh` names this rank, the world
size, the rank's device and the two process groups, and carries the few
collectives the port uses. Its `shape["data"]` is the world size, as
the JAX mesh's 'data' extent.

The layout is JAX's: the frame banks and the parameters are whole on
every rank (replicated), each rank takes its rows of every index batch
(`rows`, the rule of JAX's `index_sharding`), and the gradients are
averaged with one `all_reduce` per step (`train/steps.py:_apply`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from cgs_tpu_torch.parallel import multihost


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This rank's place in the data-parallel world: the device
    collectives go over the default group, the host objects over
    `host_group` (gloo)."""
    rank: int
    world: int
    device: torch.device
    host_group: Any = None

    @property
    def shape(self) -> dict:
        return {"data": self.world}

    # -- layout ---------------------------------------------------------

    def divides(self, n: int) -> bool:
        return n % self.world == 0

    def rows(self, n: int) -> slice:
        """This rank's rows of an n-row batch: its contiguous 1/N when N
        divides n, else the whole batch (every rank computes it, as
        JAX's `index_sharding` falls back to replicated placement:
        correct math, every chip computes the full batch)."""
        if not self.divides(n):
            return slice(0, n)
        per = n // self.world
        return slice(self.rank * per, (self.rank + 1) * per)

    # -- device collectives ----------------------------------------------

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM
                    ) -> torch.Tensor:
        dist.all_reduce(t, op=op)
        return t

    def mean_(self, t: torch.Tensor) -> torch.Tensor:
        """t summed over the ranks and divided by the world size, in
        place (exact at world 1)."""
        return self.all_reduce_(t).div_(self.world)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        dist.broadcast(t, src=src)
        return t

    def assemble(self, part: torch.Tensor, n: int) -> torch.Tensor:
        """The whole n-row tensor on every rank from each rank's rows
        (`rows(n)`, N dividing n): the rows written into a zero-filled
        buffer and summed over the ranks, so every row is one rank's
        value plus zeros, bit for bit. gloo has no all_gather for CUDA
        tensors; all_reduce it has."""
        whole = part.new_zeros((n,) + tuple(part.shape[1:]))
        whole[self.rows(n)] = part
        return self.all_reduce_(whole)

    # -- host objects -----------------------------------------------------

    def broadcast_object(self, obj: Any, src: int = 0) -> Any:
        return multihost.broadcast_object(obj, src)

    def gather_object(self, obj: Any) -> Optional[List[Any]]:
        return multihost.gather_object(obj)

    def broadcast_ints(self, values, src: int = 0) -> list:
        """Rank `src`'s integers on every rank, one host-group broadcast
        (a dispatch's header, without pickling); the other ranks pass as
        many placeholders."""
        t = torch.tensor(list(values), dtype=torch.int64)
        dist.broadcast(t, src=src, group=self.host_group)
        return t.tolist()

    def max_int(self, v: int) -> int:
        """The largest of the ranks' integers."""
        t = torch.tensor([int(v)], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.host_group)
        return int(t.item())

    def barrier(self) -> None:
        dist.barrier(group=self.host_group)


def current_mesh() -> Optional[Mesh]:
    """The Mesh of the process group this process has joined (any world
    size, 1 included), else None."""
    if not multihost.joined():
        return None
    return Mesh(rank=dist.get_rank(), world=dist.get_world_size(),
                device=multihost.rank_device(),
                host_group=multihost.host_group())


def ranks_wanted(cfg) -> int:
    """How many ranks a run asks for: --data-parallel, where 0 means
    every card of the host on cuda and one rank on the CPU."""
    if cfg.data_parallel > 0:
        return int(cfg.data_parallel)
    if torch.device(cfg.device).type == "cuda" \
            and torch.cuda.is_available():
        return torch.cuda.device_count()
    return 1


def run_over_ranks(cfg, fn: Callable, *args) -> Any:
    """fn(*args) on the ranks the run asks for (`ranks_wanted`): here,
    when this process already is a rank (torchrun, or a rank that
    `multihost.launch` started) or one rank is asked for; else this
    process becomes rank 0 of a fresh world and starts the others.
    Returns rank 0's result. fn must be a module-level function."""
    n = ranks_wanted(cfg)
    if multihost.joined() or n <= 1:
        return fn(*args)
    if torch.device(cfg.device).type == "cuda" \
            and n > torch.cuda.device_count():
        raise ValueError(
            f"--data-parallel {n} needs {n} cards (NCCL takes one rank "
            f"per card); {torch.cuda.device_count()} are present")
    return multihost.launch(fn, n, args, device=cfg.device)


def local_mesh_or_none(cfg) -> Optional[Mesh]:
    """The run's Mesh, None for one rank (the plain path is already
    right there). A world that was joined must be the one
    --data-parallel asks for; asking for several ranks without a joined
    world raises (`cli.main` and torchrun start the ranks; a Handler
    cannot)."""
    mesh = current_mesh()
    if mesh is None:
        if cfg.data_parallel > 1:
            raise ValueError(
                f"--data-parallel {cfg.data_parallel} needs one process per "
                "rank: run through cgs_tpu_torch.cli (it starts the ranks) "
                "or torchrun")
        return None
    if cfg.data_parallel > 0 and cfg.data_parallel != mesh.world:
        raise ValueError(f"--data-parallel {cfg.data_parallel} but this "
                         f"process is a rank of a world of {mesh.world}")
    return mesh if mesh.world > 1 else None


def replicate_tree(mesh: Optional[Mesh], tree):
    """Rank 0's `tree` (state_dicts, nested dicts of CPU tensors) on
    every rank: the JAX `replicate_tree`, as a broadcast from rank 0."""
    return tree if mesh is None else mesh.broadcast_object(tree)


def check_seed_shards(r: int, world: int) -> None:
    """Raise unless R seeds divide over `world` ranks."""
    if r % world:
        raise ValueError(f"{r} seeds do not divide over {world} ranks "
                         "(seed sharding needs R % ranks == 0)")


def seed_shard_tree(mesh: Optional[Mesh], members: List) -> List:
    """This rank's members of a list of R per-seed items (R divisible by
    the world size): seeds [rR/N, (r+1)R/N)."""
    if mesh is None:
        return list(members)
    r = len(members)
    check_seed_shards(r, mesh.world)
    per = r // mesh.world
    return list(members[mesh.rank * per:(mesh.rank + 1) * per])


_ensemble_warned = set()     # (r, world) already printed


def ensemble_divides(r: int, world: int) -> bool:
    """Whether R ensemble members divide over `world` ranks; when they
    do not, a warning printed once per shape."""
    if r % world == 0:
        return True
    if (r, world) not in _ensemble_warned:
        _ensemble_warned.add((r, world))
        print(f"[cgs-tpu-torch] --ensemble {r} does not divide over "
              f"{world} ranks; running unmeshed (seed-sharding needs "
              "R % ranks == 0)")
    return False


def ensemble_mesh_or_none(mesh: Optional[Mesh], r: int) -> Optional[Mesh]:
    """The rule for the seed-sharded ensemble: `mesh` when the R members
    divide over the ranks, else a warning printed once per shape and
    None (every rank then runs the whole ensemble)."""
    if mesh is None or not ensemble_divides(r, mesh.world):
        return None
    return mesh


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


RANK_STREAM = 0x72616e6b      # 'rank': the ranks' dropout streams


def rank_seed(seed: int, mesh: Optional[Mesh]) -> int:
    """The seed of this rank's dropout generator: rank 0's is `seed`, so
    world 1 is the serial stream; rank r's is drawn from
    SeedSequence([seed, RANK_STREAM, r]), 32 bits (the CPU generator
    reads only the low 32 bits of a seed), so no two ranks share one."""
    if mesh is None or mesh.rank == 0:
        return int(seed)
    return int(np.random.SeedSequence(
        [int(seed), RANK_STREAM, mesh.rank]).generate_state(1)[0])


def rank0_first(mesh: Optional[Mesh], fn: Callable[[], Any]) -> Any:
    """fn() on rank 0, then on the other ranks once rank 0 is done with
    it (a barrier between): rank 0 writes a cache or builds a library,
    the others find it. Rank 0 reaches the barrier even when fn raises."""
    if mesh is None:
        return fn()
    if mesh.rank == 0:
        try:
            return fn()
        finally:
            mesh.barrier()
    mesh.barrier()
    return fn()


def rank0_value(mesh: Optional[Mesh], fn: Callable[[], Any]) -> Any:
    """fn() run on rank 0 only, its value on every rank; an exception on
    rank 0 is raised on every rank (none waits in a collective that
    rank 0 never enters)."""
    if mesh is None:
        return fn()
    box = (None, None)
    if mesh.rank == 0:
        try:
            box = (fn(), None)
        except Exception as e:            # sent to every rank, re-raised
            box = (None, e)
    value, err = mesh.broadcast_object(box)
    if err is not None:
        raise err
    return value
