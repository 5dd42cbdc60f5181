"""One optimizer step of each training phase (PyTorch port of
`cgs_tpu/train/steps.py:56-210`).

Each step runs eagerly on the models' device: the batch ingest (one
`normalize_u8` kernel launch on the card gathers the step's frames and
labels from the uint8 banks by index, applies the shift augmentation
and normalises, into one joined batch), the forward passes and every
loss branch (`train/losses.py`), backward, and the Adam update. The
losses stay on the device; the chunk loops (`train/loops.py`) bring
them down once per chunk.

Random draws: the shift offset comes from a CPU `torch.Generator` (no
device sync per step) and dropout from a generator on the device, both
seeded by the caller. They differ from the JAX package's `jax.random`
streams; the parity tests run with shift 0 and dropout 0.

Data parallelism (port of `cgs_tpu/train/steps.py:166-200`): given a
`parallel.mesh.Mesh`, each rank runs the step on its rows of the batch,
then one `all_reduce` averages every trained gradient, flattened into
one buffer, before the optimizer step (`sync_gradients`). Every loss
term is a mean over the batch, so the mean of the ranks' gradients of
equal-sized shares is the gradient of the whole batch's mean; XLA
inserts the same reduction in JAX. A batch that does not divide over
the ranks runs whole on every rank, and rank 0's gradient is broadcast.
The shift draws come from a generator seeded alike on every rank (one
shift for the whole batch, as JAX's replicated key draws), the dropout
masks from a generator of each rank's own (`StepRng.seeded`).

Under a profiler each step names its host work (`utils/profiling.py:
span`): `cgs.train.critic_step` / `cgs.train.masker_step` around the
step, and inside it `cgs.train.batch` (the shift draw and the ingest),
`cgs.train.loss` (the loss forward) and `cgs.train.backward`
(`zero_grad`, `backward` and the gradient sync); Adam's update is
torch's own `Optimizer.step#Adam.step` region.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Sequence, Tuple

import torch

from cgs_tpu_torch.models.build import batch_norms, drop_paths
from cgs_tpu_torch.ops.augment import draw_shift
from cgs_tpu_torch.ops.kernels import Segment
from cgs_tpu_torch.parallel.mesh import rank_seed
from cgs_tpu_torch.train.losses import (
    build_critic_loss, build_masker_loss, ingest_segments,
)
from cgs_tpu_torch.utils.profiling import span

LR, BETAS, EPS = 1e-3, (0.9, 0.999), 1e-8
# the masker step's loss terms, in the order a chunk returns them
TERMS = ("replace", "inject", "norm", "critic")


@dataclasses.dataclass
class StepRng:
    """The generators a step draws from: `shift` on the CPU, `dropout`
    on the models' device."""
    shift: torch.Generator
    dropout: torch.Generator

    @classmethod
    def seeded(cls, seed: int, device, mesh=None) -> "StepRng":
        """Both seeded with `seed`; over a mesh the dropout generator
        with the rank's own seed (`parallel.mesh.rank_seed`: rank 0's is
        the serial stream, no two ranks share one)."""
        return cls(torch.Generator().manual_seed(seed),
                   torch.Generator(device=device).manual_seed(
                       rank_seed(seed, mesh)))

    def get_state(self) -> dict:
        """Both generators' states (CPU byte tensors), for a train-state
        checkpoint."""
        return {"shift": self.shift.get_state(),
                "dropout": self.dropout.get_state()}

    def set_state(self, state: dict) -> None:
        self.shift.set_state(state["shift"])
        self.dropout.set_state(state["dropout"])


def make_optimizer(modules: Dict[str, torch.nn.Module],
                   critic_update_scale: float = 1.0
                   ) -> torch.optim.Adam:
    """torch.optim.Adam at the reference's defaults (main.py:178,331
    pass no lr): lr 1e-3, betas (0.9, 0.999), eps 1e-8, one parameter
    group per module in `modules`, named by its key.

    critic_update_scale (`--critic-lr-scale`, masker phase only)
    multiplies the updates of the group named 'critic' by s. The JAX
    package scales Adam's update after the fact (optax.scale); here
    the 'critic' group gets lr * s, which differs from that by at most
    1 ulp of the update (one rounding in another place). The scale
    keys only on 'critic', so a trained 'sepcrit' under -separate is
    not scaled (the JAX package's quirk, steps.py:78; a warning says
    so)."""
    if "sepcrit" in modules and critic_update_scale != 1.0:
        warnings.warn(
            "--critic-lr-scale applies to the 'critic' parameters only; "
            "the separate critic ('sepcrit') trains at the full rate, as "
            "in the JAX package (cgs_tpu/train/steps.py:78)")
    groups = [{"params": list(m.parameters()), "name": name,
               "lr": LR * (critic_update_scale if name == "critic"
                           else 1.0)}
              for name, m in modules.items()]
    return torch.optim.Adam(groups, lr=LR, betas=BETAS, eps=EPS)


def trained_param_keys(cfg) -> list:
    """Which models the masker-phase optimizer trains
    (main.py:330-334)."""
    return ["masker"] + (["critic"] if cfg.live else []) + (
        ["sepcrit"] if cfg.separate else [])


def set_masker_modes(cfg, models: Dict[str, torch.nn.Module]) -> None:
    """The masker phase's modes: every model in train mode (dropout
    live), gradients for the trained ones (`trained_param_keys`). A
    model that does not train (the -frozen critic) runs as a frozen
    backbone does: its BatchNorm on its running statistics, which do not
    move, so the fused critic passes stay exact (`train/losses.py`); its
    drop-path in eval mode. ConvNeXt and Swin keep no running statistics
    and need no BatchNorm rule: with its drop-path off, a frozen ConvNeXt
    or Swin critic computes what its eval mode does."""
    trained = trained_param_keys(cfg)
    for name, model in models.items():
        model.requires_grad_(name in trained).train()
        if name not in trained:
            for m in (*batch_norms(model), *drop_paths(model)):
                m.eval()


def sync_gradients(optimizer: torch.optim.Optimizer, mesh,
                   whole: bool = False) -> None:
    """The step's one gradient collective: every trained gradient
    flattened into one buffer, averaged over the ranks, or, when every
    rank ran the whole batch (`whole`), rank 0's broadcast; then copied
    back. Exact at world 1."""
    grads = [p.grad for g in optimizer.param_groups for p in g["params"]
             if p.grad is not None]
    if not grads:
        return
    flat = torch.cat([g.reshape(-1) for g in grads])
    if whole:
        mesh.broadcast_(flat)
    else:
        mesh.mean_(flat)
    for g, f in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(f.view(g.shape))


def _apply(optimizer: torch.optim.Optimizer, loss: torch.Tensor,
           mesh=None, whole: bool = False) -> None:
    with span("cgs.train.backward"):
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if mesh is not None:
            sync_gradients(optimizer, mesh, whole)
    optimizer.step()


def shifted(cfg, segments: Sequence[Segment], rng: StepRng) -> list:
    """The segments rolled by one shift draw for all of them (the
    reference shifts a whole batch by one offset, main.py:585); no draw
    when --shift is 0."""
    if not cfg.shift:
        return list(segments)
    s = draw_shift(int(cfg.shift), rng.shift)
    return [seg._replace(shift=s) for seg in segments]


def critic_step(cfg, critic: torch.nn.Module,
                optimizer: torch.optim.Optimizer, x: Segment,
                rng: StepRng, mesh=None, whole: bool = False
                ) -> torch.Tensor:
    """One critic step (main.py:182-199) on the (B, 64, 64, 3) uint8
    frames and the labels that `x` names (its labels must be given);
    returns the detached loss. Over a mesh `x` names this rank's rows
    (the whole batch with `whole`) and the gradients are synced."""
    with span("cgs.train.critic_step"):
        with span("cgs.train.batch"):
            xf, y = ingest_segments(shifted(cfg, [x], rng))
        with span("cgs.train.loss"):
            loss = build_critic_loss(cfg)(critic, xf, y, rng.dropout)
        _apply(optimizer, loss, mesh, whole)
        return loss.detach()


def masker_batch(cfg, a: Sequence[Segment], b: Segment, rng: StepRng,
                 out=None):
    """(ab, y, n): A (shifted by one draw; only A is shifted,
    main.py:355-357) and B ingested into one joined batch, A's labels,
    and A's frame count n, so a = ab[:n] and b = ab[n:]; into `out`'s
    buffers when given (`ingest_segments`)."""
    ab, y = ingest_segments([*shifted(cfg, a, rng), b], out)
    return ab, y, ab.shape[0] - b.rows


def masker_loss(cfg, models: Dict[str, torch.nn.Module], ab, y, n: int,
                rng: StepRng, fuse: str = "both"):
    """(loss, aux) of the masker step on `masker_batch`'s joined batch
    (`train/losses.py:build_masker_loss`); aux[t] for t in `TERMS` are
    the logged loss terms."""
    with span("cgs.train.loss"):
        return build_masker_loss(cfg, fuse)(models, ab[:n], y, ab[n:],
                                            rng.dropout, ab=ab)


def masker_step(cfg, models: Dict[str, torch.nn.Module],
                optimizer: torch.optim.Optimizer, a: Sequence[Segment],
                b: Segment, rng: StepRng, mesh=None,
                whole: bool = False, fuse: str = "both"
                ) -> Tuple[torch.Tensor, ...]:
    """One masker step (main.py:340-463): `a` names the frames of A,
    [K high || K low] (main.py:350), with their labels, `b` the 2K
    contrast-negatives (`masker_batch`). The fused critic pass reads
    the joined batch as it is. Returns the detached (replace, inject,
    norm, critic) loss terms, four 0-dim tensors (stacked once per
    chunk by the caller). Over a mesh, as `critic_step`: row i of A
    and row i of B stay a pair on one rank. fuse: which critic passes
    are batched together (`train/losses.py:build_masker_loss`)."""
    with span("cgs.train.masker_step"):
        with span("cgs.train.batch"):
            ab, y, n = masker_batch(cfg, a, b, rng)
        loss, aux = masker_loss(cfg, models, ab, y, n, rng, fuse)
        _apply(optimizer, loss, mesh, whole)
        return tuple(aux[t].detach() for t in TERMS)
