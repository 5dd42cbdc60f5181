"""Device selection for the port's entry points.

Every entry point (`MaskPipeline`, `Handler`, the CLI) runs on `cuda`
unless the caller asks for the CPU. Asking for `cuda` on a machine
without a card raises: the port never falls back to the CPU quietly,
so a number measured on the CPU can never pass for a card's.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """`None` means `cuda`. Raises if `cuda` is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"device {dev} is neither cuda nor cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cgs_tpu_torch runs on cuda by default and no CUDA device "
            "is available; pass device='cpu' (CLI: --device cpu) to run "
            "on the CPU")
    if dev.type == "cuda" and dev.index is None:
        # cuda:N, so it compares equal to a tensor's .device
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def tf32_state() -> dict:
    return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
            "cuda.matmul.allow_tf32":
                torch.backends.cuda.matmul.allow_tf32}


def disable_tf32() -> dict:
    """Turn off both TF32 switches (cuDNN convs and cuBLAS matmuls) and
    return them. cuDNN runs f32 convs in TF32 by default; the f32 mode
    turns that off so that f32 means f32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return tf32_state()


def deterministic_cudnn() -> dict:
    """Make cuDNN pick deterministic algorithms and return the switch.
    With its defaults, cuDNN's backward kernels sum in an order that
    changes from run to run, so one seed's trained critic, contrastive
    split and eval IoU move between runs; deterministic, one seed gives
    the same losses and IoU on every run."""
    torch.backends.cudnn.deterministic = True
    return {"cudnn.deterministic": torch.backends.cudnn.deterministic}
