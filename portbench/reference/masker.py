"""Protocol B's masker step in plain PyTorch (reference main.py:340-463
with `-frozen`): the critic frozen, the masker trained by Adam.

    A  = shift([pos[h] || neg[l]])      B = neg[c]          (2K each)
    pred, embeds = critic(A);   negpred = critic(B)         (one pass)
    Z  = decoder(A, embeds)
    replaced = A(1 - Z) + ZB;   injected = B(1 - Z) + ZA
    loss = MSE(critic(replaced), negpred) + MSE(critic(injected), pred)
           + L1 mean|Z|                 (staticnorm, L2 = 0)

The critic's two passes run as the port runs them by default (fuse
'both'): A || B in one pass and replaced || injected in one, each
drawing its dropout once over the joined batch. The shift is one draw
for the batch (main.py:584-591) from a CPU generator; dropout draws
from a generator on the frames' device (`model.dropout`). Adam is
written out (lr 1e-3, betas (0.9, 0.999), eps 1e-8, main.py:331).
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

from portbench.reference import model

LR, B1, B2, EPS = 1e-3, 0.9, 0.999, 1e-8


def draw_shift(max_shift: int, gen: torch.Generator) -> int:
    """floor(max_shift * U) with a random sign, from two uniforms."""
    u = torch.rand(2, generator=gen)
    off = int(math.floor(max_shift * float(u[0])))
    return -off if float(u[1]) > 0.5 else off


def step_loss(train: dict, critic_p: Dict[str, torch.Tensor],
              masker_p: Dict[str, torch.Tensor], banks: dict, h, l, c,
              shift_gen: torch.Generator, drop: float,
              drop_gen: torch.Generator):
    """(loss, (replace, inject, norm)) of one step; the loss carries the
    masker's gradient."""
    if not train["frozen"] or not train["inject"] or not train["staticnorm"]:
        raise ValueError("the reference masker step is protocol B's: "
                         "frozen, inject, staticnorm")
    a_u8 = torch.cat([banks["xpos"].index_select(0, h),
                      banks["xneg"].index_select(0, l)])
    if train["shift"]:
        a_u8 = torch.roll(a_u8, draw_shift(int(train["shift"]), shift_gen),
                          dims=2)
    b_u8 = banks["xneg"].index_select(0, c)
    a, b = model.ingest(a_u8), model.ingest(b_u8)
    n = a.shape[0]
    with torch.no_grad():
        out, embeds = model.critic(critic_p, torch.cat([a, b]), drop,
                                   drop_gen)
    pred, negpred = out[:n], out[n:]
    z = model.decoder(masker_p, a, [e[:n] for e in embeds])
    merged = torch.cat([a * (1.0 - z) + z * b, b * (1.0 - z) + z * a])
    vals, _ = model.critic(critic_p, merged, drop, drop_gen)
    replace = ((vals[:n] - negpred) ** 2).mean()
    inject = ((vals[n:] - pred) ** 2).mean()
    norm = float(train["L1"]) * z.abs().mean()
    return replace + inject + norm, (replace, inject, norm)


def run_steps(train: dict, params: dict, banks: dict, stacks: List[tuple],
              shift_seed, dropout_seed, drop: float, start=None,
              marks=()):
    """Follow the port's steps: stacks is [(h, l, c)] of int64 index
    tensors, one per step. From the seeded weights and a fresh Adam, the
    generators seeded with shift_seed / dropout_seed; or, with `start`
    ({'masker', 'exp_avg', 'exp_avg_sq': {key: tensor}, 'step': the
    steps Adam has taken, 'rng': {'shift', 'dropout'} generator
    states}), from that state. Returns {'losses': [(replace, inject,
    norm)], 'grad1': {key: the first step's gradient}, 'params': {key:
    the masker's leaves after the last step}, 'params0': ...,
    'exp_avg': {key: Adam's first moment after the last step}, 'at':
    {i: {'params': the leaves after the i-th step followed, 'grad_next':
    the next step's gradient}} for each i in `marks`}."""
    model.set_f32()
    dev = banks["xpos"].device
    critic_p = {k: v.detach() for k, v in params["critic"].items()}
    shift_gen = torch.Generator()
    drop_gen = torch.Generator(device=dev)
    if start is None:
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in params["masker"].items()}
        m = {k: torch.zeros_like(v) for k, v in leaves.items()}
        v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
        t0 = 0
        shift_gen.manual_seed(shift_seed)
        drop_gen.manual_seed(dropout_seed)
    else:
        leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in start["masker"].items()}
        m = {k: v.detach().clone() for k, v in start["exp_avg"].items()}
        v2 = {k: v.detach().clone()
              for k, v in start["exp_avg_sq"].items()}
        t0 = int(start["step"])
        shift_gen.set_state(start["rng"]["shift"])
        drop_gen.set_state(start["rng"]["dropout"])
    out = {"losses": [], "grad1": None, "at": {},
           "params0": {k: v.detach().clone() for k, v in leaves.items()}}
    for t, (h, l, c) in enumerate(stacks, start=t0 + 1):
        loss, terms = step_loss(train, critic_p, leaves, banks, h, l, c,
                                shift_gen, drop, drop_gen)
        keys = list(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in keys])
        out["losses"].append(tuple(float(x.detach()) for x in terms))
        if t == t0 + 1:
            out["grad1"] = {k: g.detach().clone() for k, g in
                            zip(keys, grads)}
        if t - t0 - 1 in out["at"]:
            out["at"][t - t0 - 1]["grad_next"] = {
                k: g.detach().clone() for k, g in zip(keys, grads)}
        with torch.no_grad():
            bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
            for k, g in zip(keys, grads):
                m[k].mul_(B1).add_(g, alpha=1.0 - B1)
                v2[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                denom = (v2[k].sqrt() / math.sqrt(bc2)).add_(EPS)
                leaves[k].addcdiv_(m[k], denom, value=-LR / bc1)
        if t - t0 in marks:
            out["at"][t - t0] = {"params": {k: v.detach().clone()
                                            for k, v in leaves.items()}}
    out["params"] = {k: v.detach().clone() for k, v in leaves.items()}
    out["exp_avg"] = m
    return out
