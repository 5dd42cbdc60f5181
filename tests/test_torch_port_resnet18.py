"""PyTorch port: the `--critic resnet18` pair (`models/build.py`), the
ResNet-18 critic with the paper's U-Net masker on its five taps, against
the benchmark's plain reference (`portbench/reference/resnet18.py`) on
seeded weights, on the CPU at a few frames.

Tolerances. Forward numbers (scores, taps, masks, BatchNorm buffers)
agree within 1e-5 of the tensor's largest value: the port's convolutions
(oneDNN, channels_last) and the reference's sum in other orders, and the
f32 reference's own gap against float64 here is 2e-6 on the score and
3e-6 on the deepest tap. The masker step's loss terms agree within
1e-4 of their size: each is a mean square of score differences of about
0.1, which the scores' f32 rounding of 2e-6 moves by 2e-5 relative.
Gradients of the masker step are held to three
times the f32 reference's own gap against the float64 reference, plus
1e-5: through ReLU and max-pool a gradient jumps where a rounding moves
an activation across a kink, so f32 alone moves a frame's input
gradient by up to 2% on some seeds, and a fixed bound would test the
seed, not the port.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from cgs_tpu_torch import cli
from cgs_tpu_torch.core.config import Config, parse_args
from cgs_tpu_torch.handler import Handler
from cgs_tpu_torch.models.build import build_pair
from cgs_tpu_torch.models.critic import Critic
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.models.interop import load_pt_resnet_critic
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.train.losses import build_masker_loss
from cgs_tpu_torch.train.steps import set_masker_modes
from cgs_tpu_torch.utils.profiling import counts
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import compare, shapes_resnet18  # noqa: E402
from portbench.lib.manifest import load_json  # noqa: E402
from portbench.reference import model as ref_chfak  # noqa: E402
from portbench.reference import resnet18 as ref  # noqa: E402

TOL = 1e-5
TERM_TOL = 1e-4
SEED = 2 ** 31 + 29
TRAIN = {"frozen": True, "inject": True, "staticnorm": True, "L1": 0.5,
         "L2": 0.0, "shift": 0, "lfak": 5}
CL = torch.channels_last


def _cfg():
    return dict(load_json(ROOT / "portbench/configs/resnet18.json"),
                bn_stat_frames=16)


_PARAMS = {}


def seeded():
    """The benchmark's seeded weights, BatchNorm statistics from 16
    frames; cached (callers copy before changing them)."""
    if not _PARAMS:
        _PARAMS.update(shapes_resnet18.seeded_params(_cfg(), SEED, "cpu"))
    return {m: {k: v.clone() for k, v in d.items()}
            for m, d in _PARAMS.items()}


def port_pair(params, arch_cfg=None):
    c, m = build_pair(arch_cfg or Config(critic_arch="resnet18"))
    c.load_state_dict(params["critic"])
    m.load_state_dict(params["masker"])
    return c.to(memory_format=CL), m.to(memory_format=CL)


def frames(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 64, 64, 3), dtype=torch.uint8,
                         generator=g)


def nchw(u8):
    """uint8 NHWC -> f32 NCHW stored channels_last, as the port ingests."""
    return (u8.float() * ref_chfak.INV255).permute(0, 3, 1, 2)


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_taps_and_score_match_reference(mode, one_torch_thread):
    p = seeded()
    critic, _ = port_pair(p)
    critic.train(mode == "train")
    x = nchw(frames(4))
    score, taps = critic(x, collect=True)
    buffers = {k: v.clone() for k, v in p["critic"].items()}
    want, want_taps = ref.critic(p["critic"], x.contiguous(),
                                 train=mode == "train", buffers=buffers)
    assert score.shape == (4, 1)
    assert [tuple(t.shape[1:]) for t in taps] == [
        (64, 32, 32), (64, 16, 16), (128, 8, 8), (256, 4, 4), (512, 2, 2)]
    assert all(t.is_contiguous(memory_format=CL) for t in taps)
    assert rel(score[:, 0], want) < TOL
    for t, w in zip(taps, want_taps):
        assert rel(t, w) < TOL
    state = critic.state_dict()
    for k, v in buffers.items():
        if v.is_floating_point():
            assert rel(state[k], v) < TOL, k
        else:
            assert int(state[k]) == int(v), k
    moved = not torch.equal(state["resnet.1.running_mean"],
                            p["critic"]["resnet.1.running_mean"])
    assert moved == (mode == "train")


def test_reference_grammar_pt_loads(tmp_path, one_torch_thread):
    """A reference ResNetCritic `.pt` and a raw torchvision resnet18
    `.pt` (its backbone) load through `load_pt_resnet_critic`."""
    p = seeded()
    torch.save(p["critic"], tmp_path / "critic.pt")
    critic, _ = port_pair({"critic": load_pt_resnet_critic(
        str(tmp_path / "critic.pt")), "masker": p["masker"]})
    x = nchw(frames(2))
    want, _ = ref.critic(p["critic"], x.contiguous())
    assert rel(critic.eval()(x)[:, 0], want) < TOL
    raw = {k.replace("resnet.0.", "conv1.").replace("resnet.1.", "bn1.")
           .replace("resnet.4.", "layer1.").replace("resnet.5.", "layer2.")
           .replace("resnet.6.", "layer3.").replace("resnet.7.", "layer4."):
           v for k, v in p["critic"].items() if k.startswith("resnet.")}
    raw["fc.weight"] = torch.zeros(1000, 512)
    torch.save(raw, tmp_path / "raw.pt")
    sd = load_pt_resnet_critic(str(tmp_path / "raw.pt"), head=False)
    assert sd.keys() == {k for k in p["critic"] if k.startswith("resnet.")}
    for k, v in sd.items():
        assert torch.equal(v, p["critic"][k])


def test_decoder_neck_x2_and_chfak_x4(one_torch_thread):
    """The neck join's factor comes from the pyramid: x2 on ResNet-18's
    2x2 neck, and the paper pair's x4 as before (the chfak reference's
    repeat-by-4 decoder)."""
    p = seeded()
    _, masker = port_pair(p)
    x = nchw(frames(2))
    _, taps = ref.critic(p["critic"], x.contiguous())
    got = masker(x, [t.contiguous(memory_format=CL) for t in taps])
    assert got.shape == (2, 1, 64, 64)
    assert rel(got, ref.decoder(p["masker"], x.contiguous(), taps)) < TOL

    gen = torch.Generator().manual_seed(3)
    critic, dec = Critic(chfak=1), UnetDecoder(chfak=1)
    for mod in (critic, dec):
        for t in mod.parameters():
            t.data.uniform_(-0.2, 0.2, generator=gen)
    cp = {k: v.detach() for k, v in critic.state_dict().items()}
    mp = {k: v.detach() for k, v in dec.state_dict().items()}
    _, embeds = ref_chfak.critic(cp, x.contiguous())
    got = dec.to(memory_format=CL)(
        x, [e.contiguous(memory_format=CL) for e in embeds])
    assert embeds[4].shape[2:] == (1, 1)
    assert rel(got, ref_chfak.decoder(mp, x.contiguous(), embeds)) < TOL


def test_pipeline_run_against_reference(one_torch_thread):
    p = seeded()
    critic, masker = port_pair(p)
    pipe = MaskPipeline(critic, masker, p, batch_size=4, wire="u8",
                        hard_threshold=0.5, device="cpu")
    u8 = frames(6)
    out = pipe.run(u8.numpy())
    pred, mask = ref.forward_masks(p, u8)
    assert np.abs(out.preds - pred.numpy()).max() < TOL * float(
        pred.abs().max())
    assert compare.level_gap(torch.from_numpy(out.masks_u8[..., 0]),
                             mask) < 1e-3
    assert compare.hard_gap(torch.from_numpy(out.hard[..., 0]), mask,
                            0.5) < 1e-5


def _masker_grads(loss, leaves):
    return dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()), allow_unused=True)))


def _ref_step(p, a, y, b, live, dtype):
    """The reference's loss terms, gradients and buffers at `dtype`."""
    cast = {m: {k: (v.to(dtype) if v.is_floating_point() else v)
                for k, v in d.items()} for m, d in p.items()}
    leaves = {f"masker.{k}": v.clone().requires_grad_(True)
              for k, v in cast["masker"].items()}
    crit = {k: (v.clone().requires_grad_(True)
                if live and not k.rsplit(".", 1)[1].startswith(
                    ("running", "num")) else v)
            for k, v in cast["critic"].items()}
    if live:
        leaves.update({f"critic.{k}": v for k, v in crit.items()
                       if v.requires_grad})
    buffers = {k: v.clone() for k, v in crit.items()
               if k.rsplit(".", 1)[1].startswith(("running", "num"))}
    loss, terms = ref.masker_loss(
        dict(TRAIN, frozen=not live), {"critic": crit, "masker": {
            k[7:]: v for k, v in leaves.items() if k.startswith("masker.")}},
        a.to(dtype), y.to(dtype), b.to(dtype), live, buffers)
    return terms, _masker_grads(loss, leaves), buffers


@pytest.mark.parametrize("live", [False, True], ids=["frozen", "live"])
def test_masker_step_against_reference_passes(live, one_torch_thread):
    """-frozen: BatchNorm on running statistics, the passes fused, the
    buffers unmoved; live: the passes unfused, each moving the buffers,
    as the reference's separate calls do."""
    p = seeded()
    cfg = Config(critic_arch="resnet18", frozen=not live, shift=0,
                 device="cpu").derive()
    critic, masker = port_pair(p)
    models = {"critic": critic, "masker": masker}
    set_masker_modes(cfg, models)
    u8 = frames(8, seed=4)
    a, b = nchw(u8[:4]), nchw(u8[4:])
    y = torch.linspace(0.0, 1.0, 4)
    before = dict(counts)
    loss, aux = build_masker_loss(cfg)(models, a, y, b)
    passes = counts["model.critic_frames"] - before.get(
        "model.critic_frames", 0)
    assert passes == 16            # 4 passes of 4 frames, or 2 fused of 8
    bn_batch = counts["model.bn_batch"] - before.get("model.bn_batch", 0)
    assert bn_batch == (80 if live else 0)
    leaves = {f"masker.{k}": v for k, v in masker.named_parameters()}
    if live:
        leaves.update({f"critic.{k}": v
                       for k, v in critic.named_parameters()})
    got = _masker_grads(loss, leaves)
    terms32, grads32, buf32 = _ref_step(p, a, y, b, live, torch.float32)
    terms64, grads64, buf64 = _ref_step(p, a, y, b, live, torch.float64)
    for k in ("replace", "inject", "norm", "critic"):
        want = float(terms64[k].detach())
        assert abs(float(aux[k].detach()) - want) <= TERM_TOL * max(
            abs(want), 1e-3), k
    own = compare.leaf_norm_gap(grads32, grads64)
    assert compare.leaf_norm_gap(got, grads64) <= 3 * own + TOL
    state = critic.state_dict()
    for k, v in buf64.items():
        if v.is_floating_point():
            assert rel(state[k], v) < TOL, k
        else:
            assert int(state[k]) == int(v), k
    moved = not torch.equal(state["resnet.1.running_var"],
                            p["critic"]["resnet.1.running_var"])
    assert moved == live
    assert int(state["resnet.1.num_batches_tracked"]) == 1 + 4 * live


def test_fused_live_pass_would_mix_statistics(one_torch_thread):
    """Why the live critic runs unfused: on batch statistics, A's scores
    from a pass over A || B are not A's own."""
    p = seeded()
    critic, _ = port_pair(p)
    critic.train()
    u8 = frames(8, seed=4)
    a, b = nchw(u8[:4]), nchw(u8[4:])
    alone = critic(a)[:, 0]
    fused = critic(torch.cat([a, b]))[:4, 0]
    assert rel(fused, alone) > 100 * TOL


def test_process_cli_and_checkpoint_round_trip(tmp_path, monkeypatch,
                                               one_torch_thread):
    """`-process --critic resnet18` on synthetic frames from checkpoints
    that a resnet18 Handler saved, BatchNorm buffers included, against
    the reference."""
    monkeypatch.chdir(tmp_path)
    p = seeded()
    argv = ["--critic", "resnet18", "--model", "r18", "--device", "cpu"]
    h = Handler(parse_args(argv))
    assert isinstance(h.critic, type(build_pair(
        Config(critic_arch="resnet18"))[0]))
    h.params = {"critic": p["critic"], "masker": p["masker"]}
    h.save_models(["critic", "masker"])
    assert h.save_paths["critic"].endswith("-critic=resnet18.pt")
    src = tmp_path / "src"
    src.mkdir()
    u8 = frames(3, seed=6)
    for i, f in enumerate(u8.numpy()):
        Image.fromarray(f).save(src / f"img{i:03d}.png")
    out = cli.main(argv + ["-cload", "1", "-mload", "1", "-process",
                           "--source-imgs", str(src),
                           "--mask-output-imgs", str(tmp_path / "out")])
    for name in ("critic", "masker"):
        for k, v in p[name].items():
            got = out.params[name][k]
            assert got.dtype == v.dtype and torch.equal(got, v), k
    _, mask = ref.forward_masks(p, u8)
    for i in range(3):
        png = np.asarray(Image.open(tmp_path / "out" /
                                    f"img{i:03d}-raw-mask.png"))
        levels = torch.from_numpy(png[..., 0].copy())
        assert compare.level_gap(levels, mask[i]) < 1e-3
    with pytest.raises(ValueError, match="--chfak 5"):
        Handler(parse_args(argv + ["--chfak", "5"]))


def test_int8_refuses_and_separate_runs(one_torch_thread):
    p = seeded()
    critic, masker = port_pair(p)
    with pytest.raises(ValueError, match="paper's Critic only"):
        MaskPipeline(critic, masker, p, quantize="int8", device="cpu")
    p2 = dict(p, sepcrit=seeded()["critic"])
    pipe = MaskPipeline(critic, masker, p2, batch_size=2, separate=True,
                        device="cpu")
    out = pipe.run(frames(2).numpy())
    assert out.masks.shape == (2, 64, 64, 1)


def test_counters_and_spans(one_torch_thread):
    p = seeded()
    critic, masker = port_pair(p)
    pipe = MaskPipeline(critic, masker, p, batch_size=2, device="cpu")
    before = dict(counts)
    with torch.profiler.profile() as prof:
        pipe.run(frames(4).numpy())
    delta = {k: counts[k] - before.get(k, 0) for k in (
        "model.critic_frames", "model.masker_frames", "model.bn_running",
        "model.bn_batch")}
    assert delta == {"model.critic_frames": 4, "model.masker_frames": 4,
                     "model.bn_running": 40, "model.bn_batch": 0}
    names = [e.name for e in prof.events()]
    assert names.count("cgs.model.critic") == 2
    assert names.count("cgs.model.masker") == 2


def test_no_jax_and_a_plain_reference():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import cgs_tpu_torch.models.build, cgs_tpu_torch.pipeline\n"
            "import cgs_tpu_torch.train.losses, cgs_tpu_torch.handler\n"
            "import portbench.drivers.process_resnet18\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'cgs_tpu'}\n"
            "assert not bad, bad\n" % str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
    src = (ROOT / "portbench/reference/resnet18.py").read_text()
    assert "cgs_tpu" not in src and "import jax" not in src
