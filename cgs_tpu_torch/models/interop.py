"""State-dict interop with the JAX package's parameter trees and the
reference's `.pt` files (port of `cgs_tpu/models/torch_interop.py:27-82`).

The port's modules already use the reference's key names, so a `.pt`
written by the reference or by `cgs_tpu` loads with plain
`load_state_dict`. `state_dict_from_flax` turns a JAX parameter tree,
given as numpy arrays, into the port's state_dict, and
`adam_state_from_optax` turns the optax Adam moments of a JAX train
state into a `torch.optim.Adam` state dict; they are how the parity
tests start both packages from the same weights and the same
mid-training state. `stack_state_dicts` / `stack_seeds` stack R seeds'
weights into the layout of `models/seeded.py`, and `unstack_seed` cuts
seed r back out in the reference layout.

The model zoo (`models/zoo.py`; port of `torch_interop.py:118-281`):
`zoo_state_dict_from_flax` carries any zoo module's JAX tree across by
layer name (a transposed conv's kernel flipped), `vgg_state_dict_from_
flax` and `resnet_state_dict_from_flax` the two torchvision-backbone
critics' (their BatchNorm `batch_stats` as `running_mean` /
`running_var`), into the reference's key grammar, where a flattened
head's input axis goes from NHWC to NCHW order. `load_pt_vgg_critic`
and `load_pt_resnet_critic` read a reference or torchvision `.pt`
directly: the port's modules use its keys and its NCHW flatten.
`load_pt_convnext_critic` reads the port's `ConvNeXtCritic` `.pt`, or a
torchvision `convnext_tiny` one's backbone: the two share their keys.

The JAX package's `core/init.py` (torch's default init in flax) has no
module here: the port's modules draw torch's own defaults, and
`init_torch_default` redraws them from an explicit generator.

Weight layout: torch conv (out, in, kh, kw) <-> flax (kh, kw, in, out);
torch linear (out, in) <-> flax (in, out).
"""

from __future__ import annotations

from typing import Dict, Sequence

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
    explicit generator instead of the global RNG. A layer without a
    bias draws its weight alone; BatchNorm keeps its own init."""
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                bound = 1.0 / float(np.sqrt(m.weight[0].numel()))
                nn.init.uniform_(m.weight, -bound, bound,
                                 generator=generator)
                if m.bias is not None:
                    nn.init.uniform_(m.bias, -bound, bound,
                                     generator=generator)
    return module


def num_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def stack_state_dicts(states: Sequence[Dict[str, torch.Tensor]]
                      ) -> Dict[str, torch.Tensor]:
    """R reference-layout state_dicts (one model each) -> the seeded
    module's state_dict (`models/seeded.py`): conv weights and biases
    concatenated along the output channels, (R*Cout, Cin, kh, kw) and
    (R*Cout,); linear weights and biases stacked, (R, out, in) and
    (R, out)."""
    out = {}
    for key in states[0]:
        layer = key.rsplit(".", 1)[0]
        conv = states[0][f"{layer}.weight"].dim() == 4
        parts = [s[key].detach().to("cpu", torch.float32) for s in states]
        out[key] = (torch.cat(parts) if conv else torch.stack(parts)
                    ).contiguous()
    return out


def stack_seeds(trees: Dict, keymap: Dict[str, str]
                ) -> Dict[str, torch.Tensor]:
    """A JAX parameter tree whose every leaf has a leading (R,) seed
    axis (numpy, as `cgs_tpu.sandbox.seed_parallel.init_seed_params`
    returns it) -> the seeded module's state_dict."""
    seeds = np.asarray(next(iter(trees.values()))["kernel"]).shape[0]
    return stack_state_dicts([
        state_dict_from_flax(
            {k: {leaf: np.asarray(v[leaf])[r] for leaf in ("kernel",
                                                           "bias")}
             for k, v in trees.items()}, keymap)
        for r in range(seeds)])


def unstack_seed(state: Dict[str, torch.Tensor], r: int, seeds: int
                 ) -> Dict[str, torch.Tensor]:
    """Seed r of a seeded state_dict as a reference-layout state_dict of
    contiguous float32 CPU tensors, as `torch_interop.py:27-45` names
    its keys."""
    out = {}
    for key, v in state.items():
        layer = key.rsplit(".", 1)[0]
        if state[f"{layer}.weight"].dim() == 4:      # conv: R*Cout rows
            cout = v.shape[0] // seeds
            v = v[r * cout:(r + 1) * cout]
        else:
            v = v[r]
        out[key] = v.detach().to("cpu", torch.float32).contiguous().clone()
    return out


# ---------------------------------------------------------------------
# the model zoo (port of cgs_tpu/models/torch_interop.py:118-281)
# ---------------------------------------------------------------------

def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32).copy())


def _flax_leaf(tree: Dict, path: str) -> Dict:
    for part in path.split("."):
        tree = tree[part]
    return tree


def zoo_state_dict_from_flax(module: nn.Module, params: Dict
                             ) -> Dict[str, torch.Tensor]:
    """A zoo module's JAX parameter tree (numpy) -> its state_dict: each
    conv, transposed conv and linear of `module` takes the JAX layer of
    the same dotted name. Conv (kh, kw, in, out) -> (out, in, kh, kw);
    transposed conv (kh, kw, in, out) -> (in, out, kh, kw) flipped in
    both spatial axes (flax's transpose does not flip its kernel,
    torch's does); linear (in, out) -> (out, in)."""
    out = {}
    for name, m in module.named_modules():
        if not isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            continue
        leaf = _flax_leaf(params, name)
        k = np.asarray(leaf["kernel"], np.float32)
        if isinstance(m, nn.ConvTranspose2d):
            w = np.transpose(k, (2, 3, 0, 1))[:, :, ::-1, ::-1]
        else:
            w = _to_torch_w(k)
        out[f"{name}.weight"] = _t(w)
        if m.bias is not None:
            out[f"{name}.bias"] = _t(leaf["bias"])
    return out


# the conv slots of torchvision vgg11 `.features`: flax conv0..conv7
VGG11_FEATURE_CONV_IDX = (0, 3, 6, 8, 11, 13, 16, 18)


def flattened_head_weight(kernel: np.ndarray, channels: int) -> np.ndarray:
    """A flax dense kernel (H*W*C, out) that eats an NHWC-flattened
    feature map -> the torch weight (out, C*H*W) that eats the same map
    flattened NCHW. The side is read from the kernel's input width, so a
    head built for another `resize` converts too."""
    k = np.asarray(kernel, np.float32)
    hw, rem = divmod(k.shape[0], channels)
    side = int(round(hw ** 0.5))
    if rem or side * side != hw:
        raise ValueError(f"dense input width {k.shape[0]} is not {channels}"
                         " x side^2 — unexpected head geometry")
    w = k.T.reshape(k.shape[1], side, side, channels)
    return w.transpose(0, 3, 1, 2).reshape(k.shape[1], channels * hw)


def _wb(leaf: Dict) -> tuple:
    return _t(_to_torch_w(np.asarray(leaf["kernel"], np.float32))), \
        _t(leaf["bias"])


def vgg_state_dict_from_flax(params: Dict) -> Dict[str, torch.Tensor]:
    """zoo.VGGCritic's JAX tree {'features': {conv0..7}, 'fc0', 'fc1',
    'fc2'} -> the port's VGGCritic state_dict (`features.{0,3,...}`,
    `head.{1,3,5}`); a bare VGG11Features tree {conv0..7} -> the port's
    VGG11Features state_dict (`{0,3,...}`)."""
    feats = params.get("features", params)
    prefix = "features." if "features" in params else ""
    out = {}
    for li, ti in enumerate(VGG11_FEATURE_CONV_IDX):
        out[f"{prefix}{ti}.weight"], out[f"{prefix}{ti}.bias"] = _wb(
            feats[f"conv{li}"])
    if "fc0" in params:
        out["head.1.weight"] = _t(flattened_head_weight(
            params["fc0"]["kernel"], 512))
        out["head.1.bias"] = _t(params["fc0"]["bias"])
        for slot, name in ((3, "fc1"), (5, "fc2")):
            out[f"head.{slot}.weight"], out[f"head.{slot}.bias"] = _wb(
                params[name])
    return out


def _bn_state(p: Dict, s: Dict, prefix: str) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.weight": _t(p["scale"]), f"{prefix}.bias": _t(
        p["bias"]), f"{prefix}.running_mean": _t(s["mean"]),
        f"{prefix}.running_var": _t(s["var"]),
        f"{prefix}.num_batches_tracked": torch.tensor(0)}


def resnet_state_dict_from_flax(params: Dict, batch_stats: Dict
                                ) -> Dict[str, torch.Tensor]:
    """zoo.ResNetCritic's JAX trees (params, batch_stats) -> the port's
    ResNetCritic state_dict in the reference's grammar (`resnet.0`
    stem conv, `resnet.1` its BatchNorm, `resnet.{4..7}.{0,1}` the
    blocks, `head.{1,3}`); without 'fc0' the backbone alone."""
    p, s = params["resnet"], batch_stats["resnet"]
    out = {"resnet.0.weight": _t(_to_torch_w(np.asarray(
        p["Conv_0"]["kernel"], np.float32)))}
    out.update(_bn_state(p["BatchNorm_0"], s["BatchNorm_0"], "resnet.1"))
    for stage in range(4):
        for block in range(2):
            fp, fs = (t[f"ResNetBlock_{stage * 2 + block}"] for t in (p, s))
            tp = f"resnet.{4 + stage}.{block}"
            for i, (conv, bn) in enumerate((("conv1", "bn1"),
                                            ("conv2", "bn2"),
                                            ("downsample.0",
                                             "downsample.1"))):
                if f"Conv_{i}" not in fp:
                    continue
                out[f"{tp}.{conv}.weight"] = _t(_to_torch_w(np.asarray(
                    fp[f"Conv_{i}"]["kernel"], np.float32)))
                out.update(_bn_state(fp[f"BatchNorm_{i}"],
                                     fs[f"BatchNorm_{i}"], f"{tp}.{bn}"))
    if "fc0" in params:
        out["head.1.weight"] = _t(flattened_head_weight(
            params["fc0"]["kernel"], 512))
        out["head.1.bias"] = _t(params["fc0"]["bias"])
        out["head.3.weight"], out["head.3.bias"] = _wb(params["fc1"])
    return out


def _load_pt(path: str) -> Dict[str, torch.Tensor]:
    state = torch.load(path, map_location="cpu")
    return {k: v.detach().clone() for k, v in state.items()}


def load_pt_vgg_critic(path: str, head: bool = True,
                       features_prefix: str = "features"
                       ) -> Dict[str, torch.Tensor]:
    """A reference VGGCritic `.pt` (nets.py:761-787) -> the state_dict
    of the port's VGGCritic; head=False reads the backbone alone (a bare
    vgg11 `.features`, or VGGEmbedder's with features_prefix 'model')
    as the state_dict of the port's VGG11Features."""
    state = _load_pt(path)
    if not head:
        pre = features_prefix + "."
        return {k[len(pre):]: v for k, v in state.items()
                if k.startswith(pre)}
    if "head.1.weight" not in state:
        raise ValueError(
            "state_dict has no VGGCritic head ('head.1.*' missing — a bare "
            "vgg11 .features dict has none): pass head=False to read the "
            "backbone alone")
    return state


def resnet_state_from_torch(state: Dict[str, torch.Tensor],
                            head: bool = True) -> Dict[str, torch.Tensor]:
    """A ResNetCritic state_dict in the reference's grammar
    ('resnet.0.weight', 'resnet.4.0.conv1.weight', ...) or a raw
    torchvision resnet18's ('conv1.weight', 'layer1.0.conv1.weight', ...,
    renamed first) -> the port's ResNetCritic keys; head=False keeps the
    backbone alone (a raw resnet18's 1000-class 'fc' is not the critic
    head)."""
    if "conv1.weight" in state:     # raw torchvision grammar
        renames = {"conv1": "resnet.0", "bn1": "resnet.1",
                   **{f"layer{i + 1}": f"resnet.{4 + i}" for i in range(4)}}
        renamed = {}
        for k, v in state.items():
            top, rest = k.split(".", 1)
            renamed[f"{renames[top]}.{rest}" if top in renames else k] = v
        state = renamed
    if not head:
        return {k: v for k, v in state.items() if k.startswith("resnet.")}
    if "head.1.weight" not in state:
        raise ValueError(
            "state_dict has no ResNetCritic head ('head.1.*' missing — a "
            "raw torchvision resnet18 carries only its 1000-class 'fc' "
            "instead): pass head=False to read the backbone alone")
    return {k: v for k, v in state.items()
            if k.startswith(("resnet.", "head."))}


def load_pt_resnet_critic(path: str, head: bool = True
                          ) -> Dict[str, torch.Tensor]:
    """A reference ResNetCritic `.pt` (nets.py:704-730), or a raw
    torchvision resnet18 `.pt` with head=False -> the state_dict of the
    port's ResNetCritic (head=False: its `resnet.*` keys; load them with
    `strict=False`)."""
    return resnet_state_from_torch(_load_pt(path), head)


def load_pt_convnext_critic(path: str, head: bool = True
                            ) -> Dict[str, torch.Tensor]:
    """A `ConvNeXtCritic` `.pt`, or a torchvision `convnext_tiny` one's
    (the same keys: `features.*`, `classifier.0` the head's LayerNorm,
    `classifier.2` its linear) -> the state_dict of the port's
    ConvNeXtCritic; head=False keeps all but `classifier.2` (a
    torchvision one's is its 1000-class linear, not the critic's
    one-output head; load the rest with `strict=False`)."""
    state = _load_pt(path)
    if not head:
        return {k: v for k, v in state.items()
                if k.startswith(("features.", "classifier.0."))}
    w = state.get("classifier.2.weight")
    if w is None or w.shape[0] != 1:
        raise ValueError(
            "state_dict has no ConvNeXtCritic head (a one-output "
            "'classifier.2'; a torchvision convnext_tiny carries its "
            "1000-class one instead): pass head=False to read the "
            "backbone alone")
    return {k: v for k, v in state.items()
            if k.startswith(("features.", "classifier."))}
