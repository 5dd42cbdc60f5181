"""State-dict interop with the JAX package's parameter trees and the
reference's `.pt` files (port of `cgs_tpu/models/torch_interop.py:27-82`).

The port's modules already use the reference's key names, so a `.pt`
written by the reference or by `cgs_tpu` loads with plain
`load_state_dict`. `state_dict_from_flax` turns a JAX parameter tree,
given as numpy arrays, into the port's state_dict, and
`adam_state_from_optax` turns the optax Adam moments of a JAX train
state into a `torch.optim.Adam` state dict; they are how the parity
tests start both packages from the same weights and the same
mid-training state.

Weight layout: torch conv (out, in, kh, kw) <-> flax (kh, kw, in, out);
torch linear (out, in) <-> flax (in, out).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

CRITIC_KEYMAP = {
    "conv0": "features.0",
    "conv1": "features.3",
    "conv2": "features.6",
    "conv3": "features.10",
    "conv_neck": "features.14",
    "fc0": "crit.1",
    "fc1": "crit.4",
}

DECODER_KEYMAP = {
    "dec0": "dec_model.0",
    "dec1": "dec_model.1",
    "dec2": "dec_model.2",
    "dec3": "dec_model.3",
    "dec4": "dec_model.4",
    "mask0": "masker.0",
    "mask1": "masker.2",
}

KEYMAPS = {"critic": CRITIC_KEYMAP, "masker": DECODER_KEYMAP,
           "sepcrit": CRITIC_KEYMAP}


def _to_torch_w(w: np.ndarray) -> np.ndarray:
    if w.ndim == 4:     # conv (kh, kw, in, out) -> (out, in, kh, kw)
        return np.transpose(w, (3, 2, 0, 1))
    return np.transpose(w)  # linear (in, out) -> (out, in)


def state_dict_from_flax(params: Dict, keymap: Dict[str, str]
                         ) -> Dict[str, torch.Tensor]:
    """JAX param tree {name: {'kernel', 'bias'}} of numpy arrays ->
    the port's state_dict of contiguous float32 CPU tensors (copies)."""
    out = {}
    for flax_name, torch_name in keymap.items():
        leaf = params[flax_name]
        w = _to_torch_w(np.asarray(leaf["kernel"], np.float32))
        out[f"{torch_name}.weight"] = torch.from_numpy(
            np.ascontiguousarray(w).copy())
        out[f"{torch_name}.bias"] = torch.from_numpy(
            np.array(leaf["bias"], np.float32, copy=True))
    return out


def adam_state_from_optax(optimizer: torch.optim.Optimizer,
                          modules: Dict[str, nn.Module], mu: Dict,
                          nu: Dict, count: int) -> Dict:
    """The JAX `TrainState`'s optax Adam moments as a
    `torch.optim.Adam` state dict for `optimizer`, whose parameter
    groups are named after the keys of `modules` (as
    `train/steps.py:make_optimizer` makes them). mu and nu are the
    optax `ScaleByAdamState` trees {name: {flax layer: {'kernel',
    'bias'}}} as numpy arrays, count its step count. Load the result
    with `optimizer.load_state_dict`."""
    state = {}
    index = 0
    for group in optimizer.param_groups:
        name = group["name"]
        keymap = KEYMAPS[name]
        by_param = {id(p): k for k, p in modules[name].named_parameters()}
        torch_to_flax = {v: k for k, v in keymap.items()}
        for p in group["params"]:
            layer, kind = by_param[id(p)].rsplit(".", 1)
            leaf = "kernel" if kind == "weight" else "bias"
            flax = torch_to_flax[layer]

            def moment(tree):
                a = np.asarray(tree[name][flax][leaf], np.float32)
                if leaf == "kernel":
                    a = _to_torch_w(a)
                return torch.from_numpy(np.ascontiguousarray(a).copy())

            state[index] = {"step": torch.tensor(float(count)),
                            "exp_avg": moment(mu),
                            "exp_avg_sq": moment(nu)}
            index += 1
    return {"state": state,
            "param_groups": optimizer.state_dict()["param_groups"]}


def init_torch_default(module: nn.Module,
                       generator: torch.Generator) -> nn.Module:
    """Re-draw every conv and linear from PyTorch's default init,
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias (the JAX
    package's `core/init.py` draws the same distribution), from an
    explicit generator instead of the global RNG."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / float(np.sqrt(m.weight[0].numel()))
                nn.init.uniform_(m.weight, -bound, bound,
                                 generator=generator)
                nn.init.uniform_(m.bias, -bound, bound,
                                 generator=generator)
    return module


def num_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())
