"""Protocol B's masker phase: `train/loops.py:masker_chunk` over uint8
banks on the card, as `handler.py:Handler.segmentation_training` runs
it (`-frozen`: the critic frozen in train mode, dropout live; the
masker trained by Adam; shift 12; L1 0.5; deterministic cuDNN and f32
with TF32 off, as `-train` sets them).

Set-up builds the one training object (models, optimizer, StepRng) and
drives it through its first `checked_steps` steps by the window's own
call, `masker_chunk` (a chunk of 1 step, then the rest), on index rows
that all differ; the window then goes on with the same object in
chunks of `chunk_steps` (the handler's --visevery), index stacks drawn
from the seed with replacement, and counts the optimizer steps that a
chunk's loss read-back ended.

With random weights and frames the critic scores every frame alike, so
the L1 term empties the mask within the first few dozen steps: from
then on the masker's gradients are nought, and only the loss terms say
whether a step ran right. The checks, against the reference from the
same weights, frames, index stacks and generator seeds:
- the start: each of the checked steps' loss terms (`loss_gap`,
  `compare.loss_terms_gap`), the first gradient as Adam holds it after
  one step (`grad_gap`, worst leaf) and the masker's change over the
  checked steps (`change_gap`, the median leaf of those the reference
  moves: Adam's step turns the rounding of a gradient element near
  nought into a change of its own size, which makes the worst leaf's
  gap swing from seed to seed);
- the window's first chunk, while the mask still moves: the reference
  goes on from its own state after the checked steps; each step's loss
  terms (`chunk1_loss_gap`), Adam's first moment at the chunk's end
  (`chunk1_grad_gap`, worst leaf) and the masker's change over it
  (`chunk1_change_gap`, median leaf);
- the window's last chunk: before each chunk the driver copies the
  training state (the masker's leaves, Adam's moments and step, both
  generators' states) into buffers made at set-up, and the reference
  follows the last chunk from that copy: each step's loss terms
  (`last_loss_gap`).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from portbench.lib import compare, flops, trace
from portbench.lib.weights import numpy_rng, seeded_params, substream
from portbench.reference import masker as ref_masker

B1 = 0.9


class TrainMasker:
    def __init__(self, cfg: dict, traffic: dict, seed: int, device,
                 faults=None):
        from cgs_tpu_torch.core.config import Config
        from cgs_tpu_torch.core.device import train_switches
        from cgs_tpu_torch.models.critic import Critic
        from cgs_tpu_torch.models.decoder import UnetDecoder
        from cgs_tpu_torch.train.steps import (
            StepRng, make_optimizer, trained_param_keys,
        )

        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = dev = torch.device(device)
        tr = cfg["train"]
        if dev.type == "cuda":
            train_switches(bf16=cfg["dtype"] == "bfloat16", train=True)
        if faults is not None:
            faults.before_build(self)
        self.pcfg = Config(chfak=cfg["chfak"], neck=cfg["neck"],
                           dropout=cfg["dropout"], frozen=tr["frozen"],
                           L1=tr["L1"], L2=tr["L2"], shift=tr["shift"],
                           noinject=not tr["inject"],
                           staticnorm=tr["staticnorm"],
                           bf16=cfg["dtype"] == "bfloat16",
                           device=str(dev)).derive()
        dt = torch.bfloat16 if cfg["dtype"] == "bfloat16" else torch.float32
        self.params = seeded_params(cfg, seed, dev)
        templates = {
            "critic": Critic(dims=cfg["dims"], bottleneck=cfg["neck"],
                             chfak=cfg["chfak"], dropout=cfg["dropout"],
                             compute_dtype=dt),
            "masker": UnetDecoder(edims=cfg["dims"], ddims=cfg["dims"],
                                  bottleneck=cfg["neck"],
                                  masker_channels=cfg["masker_channels"],
                                  chfak=cfg["chfak"], compute_dtype=dt)}
        trained = trained_param_keys(self.pcfg)
        self.models = {}
        for name, m in templates.items():
            m = m.to(dev, memory_format=torch.channels_last)
            m.load_state_dict(self.params[name])
            self.models[name] = m.train().requires_grad_(name in trained)
        self.opt = make_optimizer({n: self.models[n] for n in trained})
        self.step_seed = substream(seed, "shift")
        self.rng = StepRng.seeded(self.step_seed, dev)
        n = int(traffic["bank_frames"])
        gen = torch.Generator(device=dev).manual_seed(
            substream(seed, "frames"))
        self.banks = {
            "xpos": torch.randint(0, 256, (n, 64, 64, 3), dtype=torch.uint8,
                                  device=dev, generator=gen),
            "xneg": torch.randint(0, 256, (n, 64, 64, 3), dtype=torch.uint8,
                                  device=dev, generator=gen)}
        lab = torch.rand(2, n, device=dev, generator=gen)
        # the contrastive split's labels: above the high threshold and
        # below the low one (main.py:281-301)
        self.banks["ypos"] = 0.7 + 0.3 * lab[0]
        self.banks["yneg"] = 0.3 * lab[1]
        self.k = int(traffic["k"])
        self._check_run()
        self._keys = [k for k, _ in self.models["masker"].named_parameters()]
        self._state = self._state_tensors()
        self._snap = [t.clone() for t in self._state]   # before a chunk
        self._after1 = [t.clone() for t in self._state]  # after chunk 1
        self.first_losses = self.last = None

    # -- index stacks -------------------------------------------------

    def _stacks(self, chunk: int, steps: int):
        """(h (S, K), l (S, K), c (S, 2K)) int64, with replacement."""
        rng = numpy_rng(self.seed, "index", chunk)
        n, k = int(self.traffic["bank_frames"]), self.k
        return (rng.integers(0, n, (steps, k)),
                rng.integers(0, n, (steps, k)),
                rng.integers(0, n, (steps, 2 * k)))

    def _distinct_stacks(self, steps: int):
        """The checked steps' stacks: within a step no frame twice."""
        rng = numpy_rng(self.seed, "index", 0)
        n, k = int(self.traffic["bank_frames"]), self.k
        h = np.stack([rng.choice(n, k, replace=False) for _ in range(steps)])
        neg = np.stack([rng.choice(n, 3 * k, replace=False)
                        for _ in range(steps)])
        return h, neg[:, :k], neg[:, k:]

    def _chunk(self, h, l, c):
        from cgs_tpu_torch.train.loops import masker_chunk

        b = self.banks
        with trace.span("masker_chunk"):
            losses = masker_chunk(self.pcfg, self.models, self.opt,
                                  b["xpos"], b["ypos"], b["xneg"], b["yneg"],
                                  h, l, c, self.rng)
            return losses.cpu()      # the handler's read-back

    # -- the checked steps ----------------------------------------------

    def _check_run(self) -> None:
        n_chk = int(self.traffic["checked_steps"])
        h, l, c = self._distinct_stacks(n_chk)
        self.checked = {"stacks": (h, l, c)}
        masker = self.models["masker"]
        keys = list(dict(masker.named_parameters()))
        self.checked["params0"] = {k: v.detach().clone()
                                   for k, v in masker.named_parameters()}
        losses = [self._chunk(h[:1], l[:1], c[:1])]
        state = self.opt.state
        self.checked["grad1"] = {
            k: (state[p]["exp_avg"] / (1.0 - B1)).clone()
            if p in state else torch.zeros_like(p)
            for k, p in zip(keys, masker.parameters())}
        losses.append(self._chunk(h[1:], l[1:], c[1:]))
        self.checked["params"] = {k: v.detach().clone()
                                  for k, v in masker.named_parameters()}
        self.checked["losses"] = torch.cat(losses).numpy()  # (S, 4)

    # -- the copy of the state before a chunk ---------------------------

    def _state_tensors(self) -> list:
        """The masker's leaves, then Adam's exp_avg and exp_avg_sq of
        each (with the step count, the state a chunk starts from)."""
        ps = [p.detach() for p in self.models["masker"].parameters()]
        st = self.opt.state
        # an optimizer that never stepped holds no moments: zeros
        return ps + [st[p][k] if p in st else torch.zeros_like(p)
                     for k in ("exp_avg", "exp_avg_sq")
                     for p in self.models["masker"].parameters()]

    def _snapshot(self, chunk: int) -> dict:
        with torch.no_grad():
            torch._foreach_copy_(self._snap, self._state)
            if chunk == 2:
                torch._foreach_copy_(self._after1, self._state)
        st = self.opt.state.get(next(self.models["masker"].parameters()),
                                {"step": 0})
        return {"chunk": chunk, "rng": self.rng.get_state(),
                "step": int(st["step"])}        # a CPU tensor: no sync

    # -- the window -------------------------------------------------------

    def window(self, seconds: float, traced: bool) -> dict:
        s = int(self.traffic["chunk_steps"])
        steps = failed = 0
        chunk, summary, durations = 1, None, []
        timed_s, timed_steps = 0.0, 0
        t0 = time.perf_counter()
        while True:
            if (time.perf_counter() - t0 >= seconds
                    and (summary is not None or not traced)):
                break
            snap = self._snapshot(chunk)
            if traced and summary is None and chunk >= 2:
                sink: dict = {}
                with trace.profiled(sink):
                    losses = [self._chunk(*self._stacks(chunk, s))]
                    sink["step"]()
                    with torch.profiler.record_function(trace.WINDOW):
                        losses.append(self._chunk(*self._stacks(chunk + 1,
                                                                s)))
                summary = sink["summary"]
                chunk += 2
            else:
                c0 = time.perf_counter()
                losses = [self._chunk(*self._stacks(chunk, s))]
                durations.append(time.perf_counter() - c0)
                timed_s += durations[-1]
                timed_steps += s
                chunk += 1
            self.last = dict(snap, losses=losses[0].numpy())
            if snap["chunk"] == 1:
                self.first_losses = losses[0].numpy()
            for ls in losses:
                steps += s
                failed += int((~torch.isfinite(ls).all(1)).sum())
        wall = time.perf_counter() - t0
        if chunk == 2:          # one chunk ran: its end is the live state
            with torch.no_grad():
                torch._foreach_copy_(self._after1, self._state)
        trace.print_durations("chunk", durations)
        fps = flops.masker_step_flops(self.cfg, self.k)
        return {"attempted": steps, "failed": failed,
                "units": ("step", steps),
                "e2e": {"train_steps_per_s": steps / wall},
                "summary": summary,
                "layer": {"steps_traced": s,
                          "best_chunk_s": min(durations, default=None),
                          "chunk_steps": s,
                          "flops_per_s": (fps * timed_steps / timed_s
                                          if timed_s else None)}}

    def free(self) -> None:
        del self.models, self.opt

    def verify(self) -> dict:
        dev, keys, s = self.device, self._keys, int(self.traffic["chunk_steps"])
        n, n_chk = len(keys), int(self.traffic["checked_steps"])
        stacks = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                  for a in self.checked["stacks"]]
        chunk1 = [torch.from_numpy(a).to(dev) for a in self._stacks(1, s)]
        stacks = [torch.cat([a, b]) for a, b in zip(stacks, chunk1)]
        ref = ref_masker.run_steps(
            self.cfg["train"], self.params, self.banks, list(zip(*stacks)),
            self.step_seed, self.step_seed, float(self.cfg["dropout"]),
            marks=(n_chk,))
        at = ref["at"][n_chk]
        change = {k: self.checked["params"][k] - self.checked["params0"][k]
                  for k in keys}
        change_ref = {k: at["params"][k] - ref["params0"][k] for k in keys}
        after1 = dict(zip(keys, self._after1[:n]))
        change1 = {k: after1[k] - self.checked["params"][k] for k in keys}
        change1_ref = {k: ref["params"][k] - at["params"][k] for k in keys}
        return {
            "loss_gap": _loss_gap(self.checked["losses"],
                                  ref["losses"][:n_chk]),
            "grad_gap": compare.leaf_norm_gap(self.checked["grad1"],
                                              ref["grad1"]),
            "change_gap": compare.median_leaf_norm_gap(
                change, change_ref, compare.moving_leaves(ref["grad1"])),
            "chunk1_loss_gap": _loss_gap(self.first_losses,
                                         ref["losses"][n_chk:]),
            "chunk1_grad_gap": compare.leaf_norm_gap(
                dict(zip(keys, self._after1[n:2 * n])), ref["exp_avg"]),
            "chunk1_change_gap": compare.median_leaf_norm_gap(
                change1, change1_ref,
                compare.moving_leaves(at["grad_next"])),
            "last_loss_gap": self._last_loss_gap()}

    def _last_loss_gap(self) -> float:
        """The reference follows the window's last chunk from the state
        copied before it."""
        last, dev, keys = self.last, self.device, self._keys
        n = len(keys)
        start = {"masker": dict(zip(keys, self._snap[:n])),
                 "exp_avg": dict(zip(keys, self._snap[n:2 * n])),
                 "exp_avg_sq": dict(zip(keys, self._snap[2 * n:3 * n])),
                 "step": last["step"], "rng": last["rng"]}
        stacks = [torch.from_numpy(a).to(dev)
                  for a in self._stacks(last["chunk"],
                                        int(self.traffic["chunk_steps"]))]
        ref = ref_masker.run_steps(
            self.cfg["train"], self.params, self.banks, list(zip(*stacks)),
            None, None, float(self.cfg["dropout"]), start=start)
        return _loss_gap(last["losses"], ref["losses"])


def _loss_gap(got, want) -> float:
    """The replace / inject / norm terms (`compare.loss_terms_gap`)."""
    if len(got) != len(want):
        return math.inf
    return compare.loss_terms_gap([row[:3] for row in got], want)

def build(cfg, traffic, seed, device, faults=None):
    return TrainMasker(cfg, traffic, seed, device, faults)
