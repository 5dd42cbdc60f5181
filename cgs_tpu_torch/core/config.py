"""Configuration system (PyTorch port; a copy of `cgs_tpu/core/config.py`
with two extra flags, `--device {cuda,cpu}`, default `cuda`, and
`--critic {paper,resnet18,convnext_t,swin_v2_t}`, default `paper`: the
critic and masker pair of `models/build.py`).

The reference drives everything through a single argparse parser
(reference `main.py:1461-1545`). We keep a typed dataclass as the source
of truth and provide an argparse shim that accepts the reference's exact
flag grammar, including its quirks:

  * single-dash boolean flags typed `bool` that argparse cannot turn off
    (`-masker/-critic/-cload/-mload/-staticnorm/-salglobal/-visbesteval`,
    reference `main.py:1466-1484`) — preserved;
  * dead flags that are parsed but never read (`--lr`, `-soft`,
    `-grabcut`, `-higheval`, `-debug`, `-clippify`, `-freeze`, `-trunk`,
    `--runs`, `-visdataset`, `-softmask`, `--false`, `--clossfak`) —
    accepted and ignored (a warning is emitted once);
  * post-parse derivations (reference `main.py:1536-1545`):
    `workers=(1,1,1)`, `live = not frozen`, `inject = not noinject`,
    `name = model`, and the `-test` implication block.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from dataclasses import dataclass
from typing import Optional, Tuple

# Flags the reference parses but never reads anywhere in main.py
# (grep-verified per flag: zero `args.<flag>` reads; note `cleaned`
# and `viscritic` ARE read — main.py:739,1567 — and must not be here).
DEAD_FLAGS = (
    "lr", "soft", "grabcut", "higheval", "debug", "clippify", "freeze",
    "trunk", "runs", "visdataset", "softmask", "false", "clossfak",
)

# --critic: the critic and masker pairs of `models/build.py:build_pair`
CRITICS = ("paper", "resnet18", "convnext_t", "swin_v2_t")


@dataclass
class Config:
    """Typed mirror of the reference CLI namespace (main.py:1461-1533)."""

    # mode switches
    train: bool = False
    eval: bool = False
    process: bool = False
    test: bool = False
    concatenated: bool = False

    # model / training toggles
    cleaned: bool = False
    frozen: bool = False
    masker: bool = True
    critic: bool = True
    cload: bool = True
    mload: bool = True
    staticnorm: bool = True
    noinject: bool = False
    viscritic: bool = False
    vismasker: bool = False
    visbesteval: bool = True
    separate: bool = False
    salience: bool = False
    process_salience: bool = False
    salglobal: bool = True
    crf: bool = False
    directeval: bool = False
    resimages: bool = False
    noevalmode: bool = False

    # dead-but-accepted (reference quirk)
    clippify: bool = False
    debug: bool = False
    freeze: bool = False
    visdataset: bool = False
    trunk: bool = False
    higheval: bool = False
    grabcut: bool = False
    soft: bool = False
    softmask: bool = False
    false: bool = False

    # numeric / string options
    salience_thresh: float = 1.5
    eval_thresh: float = 0.05
    dropout: float = 0.3
    lr: float = 0.00005          # dead in reference; Adam uses defaults
    threshrew: float = 0.0
    trainasvis: int = 0
    envname: str = "Treechop"
    visname: str = "curves"
    datamode: str = "trunk"
    purevis: str = ""
    sortidx: int = 1
    chfak: int = 1
    shift: int = 12
    lfak: int = 5
    neck: int = 32
    clossfak: int = 5
    cepochs: int = 15
    mepochs: int = 1
    high_rew_thresh: float = 0.7
    low_rew_thresh: float = 0.3
    L2: float = 0.0
    L1: float = 0.5
    saveevery: int = 5
    visevery: int = 100
    rewidx: int = 1
    gammas: str = "0.98-0.97-0.96-0.95"
    testsize: int = 5000
    datasize: int = 100000
    name: str = "default-model"
    model: str = "default-model"
    runs: int = 1
    source_imgs: str = ""
    mask_output_imgs: str = "results"
    output_video: str = ""
    binarymaskthreshold: float = 0.5

    # derived (main.py:1536-1545)
    workers: Tuple[int, int, int] = (1, 1, 1)
    live: bool = True
    inject: bool = True

    # --- framework-only extensions (not in the reference CLI) ---
    # these never change reference-compatible behavior at defaults
    seed: int = 0
    data_parallel: int = 0       # 0 = use all local devices
    batch_size: int = 64         # critic-phase batch (main.py:113 default)
    infer_batch: int = 0         # eval/process batch; 0 = auto
                                 # (8192 on cuda, 128 on cpu — the
                                 # reference's 128 at main.py:910,1119
                                 # is an implementation detail, not an
                                 # interface; outputs are batch-
                                 # invariant)
    bf16: bool = False           # bfloat16 compute for the conv stack
    synthetic_data: bool = False  # use the synthetic fixture dataset
    synthetic_variant: str = "easy"  # easy | hard (data/synthetic.py:
                                 # hard = texture-defined reward,
                                 # color-matched distractors,
                                 # nonstationary background — the
                                 # ablation-ordering fixture)
    contrastive_min: int = 500   # min pos/neg frames (main.py:281)
    critic_lr_scale: float = 1.0  # masker-phase critic update scale
                                 # (extension; 1.0 = exact reference
                                 # dynamics, 0.0 = immovable critic;
                                 # train/steps.py:make_optimizer)
    profile: str = ""            # trace dir (utils/profiling.py)
    crf_rescale: bool = False    # per-frame mask rescale before CRF
    eval_video_max_frames: int = 0  # cap frames in eval comparison
                                 # videos (0 = all; the reference
                                 # renders the full 2450-frame set on
                                 # every qualifying eval, main.py:1027)
    debug_nan: bool = False      # per-chunk NaN/Inf guards
    serve_wait_ms: float = 2.0   # serve.py micro-batch window
    serve_wire: str = "f32"      # serve mask D2H: f32 | u8 (quantized;
                                 # see pipeline.py wire docs)
    orbax: bool = False          # full-train-state ckpt + resume (not
                                 # ported yet)
    ensemble: int = 0            # serve/-process/-eval the mean mask
                                 # of N per-seed runs {model}-seed{s}
                                 # (multirun / seed_parallel layout)
    evaldatapath: str = "red-trees/"  # labeled eval set dir (X.npy +
                                 # Y.npy); the reference hard-codes
                                 # "red-trees/" (main.py:920-921) —
                                 # exposed so real-data users can point
                                 # at the dump without cwd tricks
    device: str = "cuda"         # port-only: where every entry point
                                 # runs; cuda raises when no card is
                                 # present (never a silent cpu run)
    critic_arch: str = "paper"   # port-only (--critic): the paper's
                                 # critic, or ResNet-18, ConvNeXt-T or
                                 # Swin V2-T with the paper's masker
                                 # on its pyramid (models/build.py)

    def derive(self) -> "Config":
        """Reproduce the reference's post-parse derivations
        (main.py:1536-1545)."""
        self.workers = (1, 1, 1)
        self.live = not self.frozen
        self.inject = not self.noinject
        self.name = self.model
        if self.test:
            self.eval = True
            self.train = not self.cload
            self.visbesteval = True
            self.crf = False
            self.salience = True
        if self.ensemble and self.train:
            # inference-only flag: during training the eval pipeline
            # must score the weights BEING TRAINED, but --ensemble
            # pins it to the on-disk {model}-seed{s} checkpoints —
            # -directeval/-eval would silently report constant
            # ensemble IoUs unrelated to the run
            raise ValueError(
                "--ensemble is inference-only (use with -process/"
                "-eval/serve, not -train/-test): training evals would "
                "silently score the stale on-disk ensemble instead of "
                "the weights being trained")
        return self

    def critic_fingerprint(self) -> str:
        """Checkpoint-name fingerprint for the critic
        (reference main.py:86-88): keys with falsy values are dropped."""
        keys = ("rewidx", "cepochs", "datamode", "datasize", "threshrew",
                "shift", "chfak", "dropout")
        d = dataclasses.asdict(self)
        return "-".join(f"{k}={d[k]}" for k in keys if d[k]) \
            + self._arch_suffix()

    def masker_fingerprint(self) -> str:
        """Checkpoint-name fingerprint for the masker (main.py:89-91)."""
        keys = ("mepochs", "L1", "L2", "inject")
        d = dataclasses.asdict(self)
        return "-".join(f"{k}={d[k]}" for k in keys if d[k]) \
            + self._arch_suffix()

    def _arch_suffix(self) -> str:
        """'-critic=<arch>' off the paper critic, so that a ResNet-18,
        ConvNeXt-T or Swin V2-T run's checkpoints never load into
        another pair; '' for the paper's, whose names stay the
        reference's."""
        if self.critic_arch == "paper":
            return ""
        return f"-critic={self.critic_arch}"


def build_arg_parser() -> argparse.ArgumentParser:
    """The reference's exact flag grammar (main.py:1462-1533).

    Single-dash `type=bool` flags replicate the reference quirk: passing
    any value (even "False") turns them on; absence keeps the default.
    """
    p = argparse.ArgumentParser(prog="cgs-tpu-torch")
    store_true = dict(action="store_true")
    # action flags (main.py:1463-1495)
    for flag in ("-train", "-cleaned", "-frozen", "-clippify", "-debug",
                 "-noinject", "-freeze", "-viscritic", "-vismasker",
                 "-visdataset", "-trunk", "-higheval", "-separate",
                 "-salience", "-process_salience", "-grabcut", "-crf",
                 "-directeval", "-soft", "-resimages", "-noevalmode",
                 "-eval", "-process", "-test", "-concatenated",
                 "-softmask"):
        p.add_argument(flag, **store_true)
    # bool-typed defaults-on flags (non-disableable, reference quirk)
    for flag in ("-masker", "-critic", "-cload", "-mload", "-staticnorm",
                 "-salglobal", "-visbesteval"):
        p.add_argument(flag, type=bool, default=True)

    p.add_argument("--salience-thresh", type=float, default=1.5)
    p.add_argument("--eval-thresh", type=float, default=0.05)
    p.add_argument("--dropout", type=float, default=0.3)
    p.add_argument("--lr", type=float, default=0.00005)
    p.add_argument("--threshrew", type=float, default=0)
    p.add_argument("--trainasvis", type=int, default=0)
    p.add_argument("--false", type=bool, default=False)
    p.add_argument("--envname", type=str, default="Treechop")
    p.add_argument("--visname", type=str, default="curves")
    p.add_argument("--datamode", type=str, default="trunk")
    p.add_argument("--purevis", type=str, default="")
    p.add_argument("--sortidx", type=int, default=1)
    p.add_argument("--chfak", type=int, default=1)
    p.add_argument("--shift", type=int, default=12)
    p.add_argument("--lfak", type=int, default=5)
    p.add_argument("--neck", type=int, default=32)
    p.add_argument("--clossfak", type=int, default=5)
    p.add_argument("--cepochs", type=int, default=15)
    p.add_argument("--mepochs", type=int, default=1)
    p.add_argument("--high-rew-thresh", type=float, default=0.7)
    p.add_argument("--low-rew-thresh", type=float, default=0.3)
    p.add_argument("--L2", type=float, default=0.0)
    p.add_argument("--L1", type=float, default=0.5)
    p.add_argument("--saveevery", type=int, default=5)
    p.add_argument("--visevery", type=int, default=100)
    p.add_argument("--rewidx", type=int, default=1)
    p.add_argument("--gammas", type=str, default="0.98-0.97-0.96-0.95")
    p.add_argument("--testsize", type=int, default=5000)
    p.add_argument("--datasize", type=int, default=100000)
    p.add_argument("--name", type=str, default="default-model")
    p.add_argument("--model", type=str, default="default-model")
    p.add_argument("--runs", type=int, default=1)
    p.add_argument("--source-imgs", type=str, default="")
    p.add_argument("--mask-output-imgs", type=str, default="results")
    p.add_argument("--output-video", type=str, default="")
    p.add_argument("--binarymaskthreshold", type=float, default=0.5)

    # framework extensions (new flags; safe defaults)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--data-parallel", type=int, default=0)
    p.add_argument("--bf16", action="store_true")
    p.add_argument("-synthetic_data", action="store_true")
    p.add_argument("--synthetic-variant", type=str, default="easy",
                   choices=("easy", "hard"))
    p.add_argument("--contrastive-min", type=int, default=500)
    p.add_argument("--critic-lr-scale", type=float, default=1.0)
    p.add_argument("--infer-batch", type=int, default=0)
    p.add_argument("--profile", type=str, default="")
    p.add_argument("-debug_nan", action="store_true")
    p.add_argument("-orbax", action="store_true")
    p.add_argument("-crf_rescale", action="store_true")
    p.add_argument("--eval-video-max-frames", type=int, default=0)
    p.add_argument("--serve-wait-ms", type=float, default=2.0)
    p.add_argument("--serve-wire", type=str, default="f32",
                   choices=("f32", "u8"))
    p.add_argument("--ensemble", type=int, default=0)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--evaldatapath", type=str, default="red-trees/")
    # port-only
    p.add_argument("--device", type=str, default="cuda",
                   choices=("cuda", "cpu"))
    # not the reference's bool-typed `-critic` (train the critic)
    p.add_argument("--critic", dest="critic_arch", type=str,
                   default="paper", choices=CRITICS)
    return p


def parse_args(argv: Optional[list] = None) -> Config:
    ns = build_arg_parser().parse_args(
        argv if argv is not None else sys.argv[1:])
    cfg = Config()
    used_dead = []
    for f in dataclasses.fields(Config):
        if hasattr(ns, f.name):
            val = getattr(ns, f.name)
            if f.name in DEAD_FLAGS and val != getattr(cfg, f.name):
                used_dead.append(f.name)
            setattr(cfg, f.name, val)
    if used_dead:
        print(f"[cgs-tpu-torch] note: flags accepted for CLI compatibility but "
              f"unused (as in the reference): {used_dead}")
    return cfg.derive()
