"""Reference-compatible `.pt` checkpoints (port of
`cgs_tpu/train/checkpoints.py:29-63`).

Filenames are the arg fingerprints `critic-<args>.pt` /
`masker-<args>.pt` under `{name}/saves/` (main.py:86-102) and contents
are state_dicts in the reference layout, so files move freely between
the reference, `cgs_tpu` and this port. A missing file loads as None
(the caller keeps its weights, main.py:141-147). The Orbax train state
and `load_seed_ensemble` wait for later slices (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

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


def _expected_keys(kind: str):
    return {f"{m}.{p}" for m in KEYMAPS[kind].values()
            for p in ("weight", "bias")}


def save_model_pt(state: Dict[str, torch.Tensor], kind: str,
                  path: str) -> None:
    """Write a reference-layout state_dict (main.py:149-156), published
    atomically (temp file + os.replace) so a reader never sees a
    half-written file."""
    missing = _expected_keys(kind) - set(state)
    if missing:
        raise KeyError(f"{kind} state_dict lacks {sorted(missing)}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    state = {k: v.detach().to("cpu", torch.float32).contiguous()
             for k, v in state.items()}
    tmp = f"{path}.tmp.{os.getpid()}"
    torch.save(state, tmp)
    os.replace(tmp, path)


def load_model_pt(kind: str, path: str
                  ) -> Optional[Dict[str, torch.Tensor]]:
    """Load a reference-layout .pt onto the CPU; None if the file is
    missing."""
    if not os.path.exists(path):
        return None
    state = torch.load(path, map_location="cpu", weights_only=True)
    missing = _expected_keys(kind) - set(state)
    if missing:
        raise KeyError(f"{path} is not a {kind} checkpoint: lacks "
                       f"{sorted(missing)}")
    return state
