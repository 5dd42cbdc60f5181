"""Reference-compatible `.pt` checkpoints (port of
`cgs_tpu/train/checkpoints.py:29-63`).

Filenames are the arg fingerprints `critic-<args>.pt` /
`masker-<args>.pt` under `{name}/saves/` (main.py:86-102) and contents
are state_dicts in the reference layout, so files move freely between
the reference, `cgs_tpu` and this port. A `--critic resnet18` critic is
the reference's `ResNetCritic` state_dict (`resnet.*`, `head.*`, the
BatchNorm buffers with it), under names that end in `-critic=resnet18`
(`core/config.py`); a `--critic convnext_t` one has torchvision's
`convnext_tiny` keys (`features.*`, `classifier.{0,2}`), under names
that end in `-critic=convnext_t`, and a `--critic swin_v2_t` one
torchvision's `swin_v2_t` keys (`features.*`, `norm`, `head`), under
names that end in `-critic=swin_v2_t`. A missing file loads as None
(the caller keeps its weights, main.py:141-147). `load_seed_ensemble`
(port of `cgs_tpu/train/checkpoints.py:108-148`) reads the per-seed
runs that `sandbox/multirun.py` and `sandbox/seed_parallel.py` write.

`TrainStateManager` is the counterpart of the JAX package's
`OrbaxManager` (`cgs_tpu/train/checkpoints.py:66-103`), written without
orbax: the full train state of a phase (step, models, Adam state, and
the state of every random source the phase draws from after that
point), one `torch.save` file per step, the newest `max_to_keep` kept.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import re
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from cgs_tpu_torch.models.interop import KEYMAPS


def checkpoint_paths(cfg) -> Dict[str, str]:
    """Fingerprinted .pt paths in the run's saves/ dir (main.py:93-102)."""
    base = f"{cfg.name}/saves/"
    return {
        "critic": f"{base}critic-{cfg.critic_fingerprint()}.pt",
        "masker": f"{base}masker-{cfg.masker_fingerprint()}.pt",
        "sepcrit": f"{base}sepcrit-{cfg.critic_fingerprint()}.pt",
    }


@functools.lru_cache(maxsize=None)
def _critic_keys(arch: str) -> frozenset:
    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.models.build import build_pair
    with torch.device("meta"):
        return frozenset(build_pair(Config(critic_arch=arch))[0]
                         .state_dict())


def _expected_keys(kind: str, arch: str = "paper"):
    if kind != "masker" and arch != "paper":
        return _critic_keys(arch)
    return {f"{m}.{p}" for m in KEYMAPS[kind].values()
            for p in ("weight", "bias")}


def save_model_pt(state: Dict[str, torch.Tensor], kind: str,
                  path: str, arch: str = "paper") -> None:
    """Write a reference-layout state_dict (main.py:149-156), published
    atomically (temp file + os.replace) so a reader never sees a
    half-written file. Floating tensors are written float32; integer
    buffers (BatchNorm's `num_batches_tracked`) keep their type."""
    missing = _expected_keys(kind, arch) - set(state)
    if missing:
        raise KeyError(f"{kind} state_dict lacks {sorted(missing)}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {k: v.detach().to("cpu", torch.float32
                              if v.is_floating_point() else v.dtype
                              ).contiguous()
             for k, v in state.items()}
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_model_pt(kind: str, path: str, arch: str = "paper"
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """Load a reference-layout .pt onto the CPU; None if the file is
    missing."""
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    missing = _expected_keys(kind, arch) - set(state)
    if missing:
        raise KeyError(f"{path} is not a {kind} checkpoint: lacks "
                       f"{sorted(missing)}")
    return state


def load_seed_ensemble(cfg, n: int, base_seed: int = 0
                       ) -> List[Dict[str, Dict[str, torch.Tensor]]]:
    """{critic, masker} CPU state_dicts of the n per-seed runs
    `{model}-seed{base_seed..base_seed+n-1}`, one dict per member, in
    seed order, for MaskPipeline(ensemble=True). A missing member
    raises FileNotFoundError naming it: an ensemble with a random member
    would corrupt the mean mask. -separate is refused: its sepcrit is
    never saved (reference quirk, main.py:1554-1564)."""
    if cfg.separate:
        raise ValueError(
            "--ensemble cannot serve -separate runs: the sepcrit the "
            "masker was trained on is never saved (reference quirk, "
            "main.py:1554-1564)")
    members = []
    for s in range(base_seed, base_seed + n):
        cfg_s = dataclasses.replace(cfg, model=f"{cfg.model}-seed{s}"
                                    ).derive()
        paths = checkpoint_paths(cfg_s)
        member = {}
        for name in ("critic", "masker"):
            state = load_model_pt(name, paths[name], cfg.critic_arch)
            if state is None:
                raise FileNotFoundError(
                    f"ensemble member missing: {paths[name]}")
            member[name] = state
        members.append(member)
    return members


class TrainStateManager:
    """Full-train-state checkpoints with resume from the newest, under
    `directory` (`-orbax`: `{name}/saves/orbax-critic/` and
    `orbax-masker/`, the JAX package's directories). `save(step,
    state)` writes `state` (a dict of tensors, numbers, strings and
    containers of them: state_dicts, an Adam `state_dict()`, generator
    states, a numpy bit-generator state) to `step-<step>.pt`, atomically,
    and deletes all but the newest `max_to_keep` files; `restore()`
    loads the newest with `weights_only=True` onto the CPU.
    `save_seconds` records each save's wall time."""

    _NAME = re.compile(r"step-(\d+)\.pt$")

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_seconds: List[float] = []
        os.makedirs(self.directory, exist_ok=True)

    def steps(self) -> List[int]:
        """The saved steps, oldest first."""
        found = (self._NAME.match(f) for f in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step-{step}.pt")

    def save(self, step: int, state: Dict[str, Any]) -> None:
        t0 = time.perf_counter()
        tmp = f"{self._path(step)}.tmp.{os.getpid()}"
        torch.save({"step": int(step), **state}, tmp)
        os.replace(tmp, self._path(step))
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self._path(old))
        self.save_seconds.append(time.perf_counter() - t0)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self) -> Optional[Tuple[int, Dict[str, Any]]]:
        """(step, state) of the newest file, or None when there is none."""
        step = self.latest_step()
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu",
                           weights_only=True)
        return step, state
