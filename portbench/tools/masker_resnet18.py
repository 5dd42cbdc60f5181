"""The masker phase with the frozen `resnet18` critic, against the plain
reference: a check and a timing, not a benchmark cell.

    python3 portbench/tools/masker_resnet18.py --seed 12345 [--steps 100]

`train/loops.py:masker_chunk` (K = 32: A = 32 high + 32 low frames, B =
64 contrast negatives; shift 12, L1 0.5, inject, staticnorm, `-frozen`:
the critic's BatchNorm on its running statistics, the passes fused) runs
`--steps` steps from the seeded `resnet18` weights
(`lib/shapes_resnet18.py`) over seeded uint8 banks on the card, a first
step alone and then the rest. The reference (`reference/resnet18.py:
run_frozen_steps`, separate critic passes, Adam written out) follows the
same index stacks and shift draws. One JSON line on stdout: the worst
step's loss-term gap (`compare.loss_terms_gap`), the first gradient's
worst leaf (`compare.leaf_norm_gap`, from Adam's first moment after one
step), the masker's change over the steps (median and worst leaf), then
steps/s of a second untraced chunk and the device operations a step and
the idle share of a traced one.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--k", type=int, default=32)
    p.add_argument("--bank", type=int, default=4096)
    p.add_argument("--traced-steps", type=int, default=20)
    p.add_argument("--bn-frames", type=int, default=0,
                   help="BatchNorm statistics' frames (0: the config's)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    out = sys.stdout
    sys.stdout = sys.stderr
    try:
        rec = run(args)
    finally:
        sys.stdout = out
    print(json.dumps(rec), flush=True)
    return 0


def run(args) -> dict:
    import torch

    from cgs_tpu_torch.core.config import Config
    from cgs_tpu_torch.core.device import train_switches
    from cgs_tpu_torch.models.build import build_pair
    from cgs_tpu_torch.train.loops import masker_chunk
    from cgs_tpu_torch.train.steps import (
        StepRng, make_optimizer, set_masker_modes,
    )
    from portbench.lib import compare, shapes_resnet18, trace
    from portbench.lib.manifest import load_json
    from portbench.lib.weights import numpy_rng, substream
    from portbench.reference import resnet18 as ref

    dev = torch.device(args.device)
    if dev.type == "cuda":
        train_switches(bf16=False, train=True)
    cfg = load_json(ROOT / "portbench/configs/resnet18.json")
    if args.bn_frames:
        cfg["bn_stat_frames"] = args.bn_frames
    train = {"frozen": True, "inject": True, "staticnorm": True,
             "L1": 0.5, "L2": 0.0, "shift": 12, "lfak": 5}
    pcfg = Config(critic_arch="resnet18", frozen=True, L1=0.5, L2=0.0,
                  shift=12, device=str(dev)).derive()
    params = shapes_resnet18.seeded_params(cfg, args.seed, dev)
    models = {}
    for name, m in zip(("critic", "masker"), build_pair(pcfg)):
        m = m.to(dev, memory_format=torch.channels_last)
        m.load_state_dict(params[name])
        models[name] = m
    set_masker_modes(pcfg, models)
    masker = models["masker"]
    opt = make_optimizer({"masker": masker})
    step_seed = substream(args.seed, "shift")
    rng = StepRng.seeded(step_seed, dev)
    gen = torch.Generator(device=dev).manual_seed(
        substream(args.seed, "frames"))
    n, k = args.bank, args.k
    banks = {"xpos": torch.randint(0, 256, (n, 64, 64, 3),
                                   dtype=torch.uint8, device=dev,
                                   generator=gen),
             "xneg": torch.randint(0, 256, (n, 64, 64, 3),
                                   dtype=torch.uint8, device=dev,
                                   generator=gen)}
    lab = torch.rand(2, n, device=dev, generator=gen)
    banks["ypos"], banks["yneg"] = 0.7 + 0.3 * lab[0], 0.3 * lab[1]

    def stacks(chunk, steps):
        r = numpy_rng(args.seed, "index", chunk)
        return (r.integers(0, n, (steps, k)), r.integers(0, n, (steps, k)),
                r.integers(0, n, (steps, 2 * k)))

    def chunk(h, l, c):
        return masker_chunk(pcfg, models, opt, banks["xpos"], banks["ypos"],
                            banks["xneg"], banks["yneg"], h, l, c,
                            rng).cpu()

    keys = [kk for kk, _ in masker.named_parameters()]
    params0 = {kk: v.detach().clone() for kk, v in masker.named_parameters()}
    h, l, c = stacks(0, args.steps)
    losses = [chunk(h[:1], l[:1], c[:1])]
    grad1 = {kk: (opt.state[p]["exp_avg"] / 0.1).clone()
             for kk, p in zip(keys, masker.parameters())}
    losses.append(chunk(h[1:], l[1:], c[1:]))
    losses = torch.cat(losses).numpy()
    change = {kk: v.detach() - params0[kk]
              for kk, v in masker.named_parameters()}

    t_stack = list(zip(*[torch.from_numpy(a).to(dev) for a in (h, l, c)]))
    rec = {"seed": args.seed, "steps": args.steps, "k": k,
           "device": (torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu"),
           "first_losses": losses[0].tolist(),
           "last_losses": losses[-1].tolist()}
    got = {"losses": [r[:3] for r in losses], "grad1": grad1,
           "change": change}
    refs = {}
    for name, dt in (("f32", torch.float32), ("f64", torch.float64)):
        w = ref.run_frozen_steps(train, params, banks, t_stack, step_seed,
                                 dt)
        refs[name] = {"losses": w["losses"], "grad1": w["grad1"],
                      "change": {kk: w["params"][kk] - w["params0"][kk]
                                 for kk in keys}}
    moving = compare.moving_leaves(refs["f64"]["grad1"])
    # the program against the f32 reference, and each against f64 (what
    # rounding alone moves)
    for tag, a, b in (("", got, refs["f32"]), ("_f64", got, refs["f64"]),
                      ("_ref32_f64", refs["f32"], refs["f64"])):
        rec["loss_gap" + tag] = compare.loss_terms_gap(a["losses"],
                                                       b["losses"])
        rec["grad_gap" + tag] = compare.leaf_norm_gap(a["grad1"], b["grad1"])
        rec["change_gap_median" + tag] = compare.median_leaf_norm_gap(
            a["change"], b["change"], moving)
        rec["change_gap_worst" + tag] = compare.leaf_norm_gap(
            a["change"], b["change"], moving)
    rec["ref_last_losses"] = list(refs["f32"]["losses"][-1])

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    chunk(*stacks(1, args.steps))
    rec["steps_per_s"] = args.steps / (time.perf_counter() - t0)
    sink: dict = {}
    s = args.traced_steps
    with trace.profiled(sink):
        chunk(*stacks(2, s))
        sink["step"]()
        with torch.profiler.record_function(trace.WINDOW):
            chunk(*stacks(3, s))
    summ = sink["summary"]
    rec["ops_per_step"] = summ.device_count() / s
    rec["idle_pct"] = 100.0 * summ.idle_share
    rec["breakdown"] = summ.breakdown(8)
    return rec


if __name__ == "__main__":
    sys.exit(main())
