"""Critic-drift probe: measure why the full model collapses (PyTorch
port of `cgs_tpu/sandbox/drift.py`).

After phase 1 and after every masker epoch of the Handler's own
masker phase (`Handler.segmentation_training`, through its `on_epoch`
hook), the probe reads:

  * `test_mse`     the live critic's MSE on the held-out test split;
  * `separation`   mean critic pred on the positive contrastive bank
                   minus the negative bank;
  * `param_drift`  relative L2 distance of the critic's parameters from
                   the phase-1 critic;
  * `embeds_drift` relative L1 change of each of the 5 skip-pyramid
                   levels on a fixed clean probe batch (the masker reads
                   these as its skip features, nets.py:497);
  * `iou`          the masker's IoU against synthetic GT, counted by
                   `threshold_iou`.

    python -m cgs_tpu_torch.sandbox.drift -synthetic_data \\
        --synthetic-variant hard --datasize 40000 --cepochs 15 \\
        --mepochs 12 --chfak 5 --dropout 0.5 --model drift5 \\
        --variants full,frozen

runs on the card (`--device cpu` for the CPU) and prints one JSON line
per (variant, epoch) and a summary. The variants share cfg.seed, so the
phase-1 critic is the same in each (the variant flags only alter the
masker phase). Needs -synthetic_data (the IoU needs ground truth).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from cgs_tpu_torch.core.device import resolve_device, train_switches
from cgs_tpu_torch.ops.kernels import threshold_iou
from cgs_tpu_torch.sandbox.ablation import VARIANT_FLAGS, _with_variant
from cgs_tpu_torch.train.losses import ingest

EVAL_BATCH = 490


def _pop_str(argv: List[str], flag: str, default: str) -> str:
    for i, tok in enumerate(argv):
        if tok == flag and i + 1 < len(argv):
            val = argv[i + 1]
            del argv[i:i + 2]
            return val
        if tok.startswith(flag + "="):
            del argv[i]
            return tok.split("=", 1)[1]
    return default


def probe(critic, masker, theta1: Dict[str, torch.Tensor], x_test, y_test,
          xpos, xneg, probe_x, embeds1: List[torch.Tensor], x_eval,
          gt_eval, thresh: float = 0.05) -> dict:
    """Every per-epoch metric (drift.py:62-119) from the critic and
    masker as they are (in eval mode), the phase-1 critic's state_dict
    theta1, and its pyramid embeds1 on probe_x. Frames are uint8 (N,
    64, 64, 3) on the models' device; y_test float32, gt_eval bool (N,
    64, 64)."""
    mods = (critic, masker)
    # every submodule's mode: a frozen critic's BatchNorm stays in eval
    # mode inside a training one (`train/steps.py:set_masker_modes`)
    was = [(m, m.training) for mod in mods for m in mod.modules()]
    for m in mods:
        m.eval()
    try:
        with torch.no_grad():
            pred_t = critic(ingest(x_test))
            test_mse = ((pred_t[:, 0] - y_test) ** 2).mean()
            separation = (critic(ingest(xpos)).mean()
                          - critic(ingest(xneg)).mean())
            now = critic.state_dict()
            sq = sum(((now[k] - v.to(now[k].device)) ** 2).sum()
                     for k, v in theta1.items())
            nrm = sum((v.to(now[k].device) ** 2).sum()
                      for k, v in theta1.items())
            param_drift = torch.sqrt(sq) / torch.sqrt(nrm)
            _, em_now = critic(ingest(probe_x), collect=True)
            embeds_drift = [(e - e1).abs().mean() / (e1.abs().mean() + 1e-8)
                            for e, e1 in zip(em_now, embeds1)]
            counts = torch.zeros(2, dtype=torch.int64,
                                 device=x_eval.device)
            n = int(x_eval.shape[0])
            for lo in range(0, n, EVAL_BATCH):
                hi = min(lo + EVAL_BATCH, n)
                xb = ingest(x_eval[lo:hi])
                _, em = critic(xb, collect=True)
                z = masker(xb, em)
                i, u = threshold_iou(z.reshape(hi - lo, -1),
                                     gt_eval[lo:hi].reshape(hi - lo, -1),
                                     thresh)
                counts[0] += i
                counts[1] += u
    finally:
        for m, w in was:
            m.training = w
    inter, union = (int(v) for v in counts.cpu())
    return dict(test_mse=float(test_mse), separation=float(separation),
                param_drift=float(param_drift), iou=inter / max(union, 1),
                embeds_drift=[float(v) for v in embeds_drift])


def run_variant(cfg, x_eval, gt_eval, eval_thresh: float = 0.05,
                primary: bool = True) -> List[dict]:
    """Train one variant through the Handler's phase 1 and its masker
    phase (`Handler.segmentation_training`), probing after phase 1 (the
    epoch-0 row) and after every masker epoch through its `on_epoch`
    hook. Returns the metric rows."""
    from cgs_tpu_torch.handler import CRITIC, Handler

    handler = Handler(cfg, primary=primary)
    handler.load_data()
    handler.critic_pipe("train")
    dev = handler.device
    theta1 = {k: v.clone() for k, v in handler.params[CRITIC].items()}
    x_test = torch.from_numpy(np.ascontiguousarray(
        handler.data.x_test[:512])).to(dev)
    y_test = torch.from_numpy(np.ascontiguousarray(
        handler.data.y_test[cfg.rewidx][:512], np.float32)).to(dev)
    x_eval_d = torch.from_numpy(np.ascontiguousarray(x_eval)).to(dev)
    gt_d = torch.from_numpy(np.ascontiguousarray(gt_eval)).to(dev)
    rows: List[dict] = []
    fixed = {}

    def on_epoch(epoch: int, models, losses) -> None:
        if not fixed:  # the phase-1 critic's pyramid on the probe batch
            sets = handler.contrastive
            fixed["probe_x"] = torch.cat([sets.xpos[:128], sets.xneg[:128]])
            critic0 = handler._device_model(CRITIC).eval()
            with torch.no_grad():
                _, fixed["embeds1"] = critic0(ingest(fixed["probe_x"]),
                                              collect=True)
            fixed["xpos"], fixed["xneg"] = sets.xpos[:512], sets.xneg[:512]
        row = probe(models["critic"], models["masker"], theta1, x_test,
                    y_test, fixed["xpos"], fixed["xneg"], fixed["probe_x"],
                    fixed["embeds1"], x_eval_d, gt_d, eval_thresh)
        row["embeds_drift"] = [round(v, 6) for v in row["embeds_drift"]]
        if losses is not None:
            m = losses.mean(axis=0)
            row.update(replace_loss=float(m[0]),
                       live_critic_loss=float(m[3]))
        rows.append(dict(epoch=epoch, **row))
        print(json.dumps(dict(variant=cfg.model, **rows[-1])), flush=True)

    handler.segmentation_training(on_epoch)
    handler.close()
    return rows


def main(argv: Optional[List[str]] = None, primary: bool = True
         ) -> Dict[str, List[dict]]:
    """`python -m cgs_tpu_torch.sandbox.drift [--variants full,frozen]
    [--eval-thresh T] <cli args>`; eval on seed 99's synthetic eval
    set. primary=False writes no run files. On the card it sets what
    the CLI's -train sets: TF32 off in f32, deterministic cuDNN."""
    import sys

    from cgs_tpu_torch.core.config import parse_args
    from cgs_tpu_torch.data.synthetic import synthetic_eval_set

    argv = list(sys.argv[1:] if argv is None else argv)
    variants = [v for v in _pop_str(argv, "--variants",
                                    "full,frozen").split(",") if v]
    eval_thresh = float(_pop_str(argv, "--eval-thresh", "0.05"))
    unknown = [v for v in variants if v not in VARIANT_FLAGS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; choose from "
                         f"{sorted(VARIANT_FLAGS)}")

    cfg0 = parse_args(list(argv))
    if not cfg0.synthetic_data:
        raise SystemExit("drift probe needs -synthetic_data "
                         "(the IoU needs ground truth)")
    if resolve_device(cfg0.device).type == "cuda":
        print("[drift] switches:", train_switches(cfg0.bf16))
    x_eval, gt = synthetic_eval_set(
        n_frames=5000, seed=99, variant=cfg0.synthetic_variant)
    x_eval, gt = x_eval[100:5000:2], gt[100:5000:2]

    results = {}
    for variant in variants:
        cfg = parse_args(_with_variant(list(argv), variant))
        print(f"[drift] {variant}: {cfg.model}", flush=True)
        results[variant] = run_variant(cfg, x_eval, gt, eval_thresh,
                                       primary=primary)

    print("\ndrift summary (epoch 0 -> final):")
    for variant, rows in results.items():
        a, b = rows[0], rows[-1]
        print(f"  {variant:9s} iou {a['iou']:.3f}->{b['iou']:.3f}  "
              f"test_mse {a['test_mse']:.4f}->{b['test_mse']:.4f}  "
              f"separation {a['separation']:.3f}->{b['separation']:.3f}  "
              f"param_drift ->{b['param_drift']:.3f}  "
              f"embeds_drift(top) ->{b['embeds_drift'][0]:.3f}",
              flush=True)
    return results


if __name__ == "__main__":
    main()
