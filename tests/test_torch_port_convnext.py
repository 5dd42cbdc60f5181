"""PyTorch port: the `--critic convnext_t` pair (`models/build.py`), the
ConvNeXt-T critic with the paper's U-Net masker on its four stages,
against the benchmark's plain reference (`portbench/reference/
convnext_t.py`) on seeded weights (`portbench/lib/shapes_convnext_t.py`),
on the CPU at a few frames and at small widths that keep ConvNeXt-T's
1:1:3:1 depths (dims 16 / 32 / 64 / 128, depths 1 / 1 / 3 / 1); the
CLI, the checkpoints and the counters at the published widths.

Tolerances. Forward numbers (scores, taps, masks) agree within 1e-5 of
the tensor's largest value: the port's convolutions and GEMMs (oneDNN,
channels_last, LayerNorm in one pass) and the reference's (NCHW, the
LayerNorm written out, einsum projections) sum in other orders, and the
f32 reference's own gap against float64 here is under 1e-6 of the
largest value. The loss terms agree within 1e-4 of their size (floor
1e-3): each is a mean of squared score differences, which the scores'
f32 rounding moves by about 1e-5 relative. Gradients (the masker's
leaves, a live critic's leaves, the frames') are held to three times
the f32 reference's own gap against the float64 reference, plus 1e-5,
per leaf as its largest gap over its largest value: a gradient through
GELU, LayerNorm and the sigmoid's tails moves with each rounding, so
f32 alone sets how close two f32 computations can be, and a fixed bound
would test the seed, not the port.
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
from cgs_tpu_torch.models.build import build_pair, critic_forward
from cgs_tpu_torch.models.convnext import ConvNeXtCritic, drop_path
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.models.interop import load_pt_convnext_critic
from cgs_tpu_torch.ops.kernels import Segment
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.sandbox import seed_parallel
from cgs_tpu_torch.train.checkpoints import load_model_pt, save_model_pt
from cgs_tpu_torch.train.losses import build_critic_loss, build_masker_loss
from cgs_tpu_torch.train.steps import (
    StepRng, critic_step, make_optimizer, set_masker_modes,
)
from cgs_tpu_torch.utils.profiling import counts
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import compare, shapes_convnext_t  # noqa: E402
from portbench.lib.manifest import load_json  # noqa: E402
from portbench.reference import convnext_t as ref  # noqa: E402
from portbench.reference.model import INV255  # noqa: E402

TOL = 1e-5
TERM_TOL = 1e-4
SEED = 2 ** 31 + 37
TRAIN = {"inject": True, "staticnorm": True, "L1": 0.5, "L2": 0.0,
         "lfak": 5}
CL = torch.channels_last
SMALL = {"dims": [16, 32, 64, 128], "depths": [1, 1, 3, 1],
         "decoder_edims": [0, 16, 32, 64],
         "decoder_widths": [16, 16, 32, 64], "neck": 128}


def _cfg(small=True):
    cfg = load_json(ROOT / "portbench/configs/convnext_t.json")
    return dict(cfg, **SMALL) if small else cfg


_PARAMS = {}


def seeded(small=True):
    """The benchmark's seeded weights; cached (callers copy before
    changing them)."""
    if small not in _PARAMS:
        _PARAMS[small] = shapes_convnext_t.seeded_params(_cfg(small), SEED,
                                                         "cpu")
    return {m: {k: v.clone() for k, v in d.items()}
            for m, d in _PARAMS[small].items()}


def port_pair(params, drop=0.0):
    """The pair at the small widths, drop-path `drop`, on `params`."""
    c = ConvNeXtCritic(dims=SMALL["dims"], depths=SMALL["depths"],
                       drop_path=drop)
    m = UnetDecoder(edims=SMALL["decoder_edims"],
                    ddims=SMALL["decoder_widths"], bottleneck=SMALL["neck"])
    c.load_state_dict(params["critic"])
    m.load_state_dict(params["masker"])
    return c.to(memory_format=CL), m.to(memory_format=CL)


def frames(n, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 256, (n, 64, 64, 3), dtype=torch.uint8,
                         generator=g)


def nchw(u8):
    """uint8 NHWC -> f32 NCHW stored channels_last, as the port ingests."""
    return (u8.float() * INV255).permute(0, 3, 1, 2)


def rel(a, b):
    a, b = a.detach().double(), b.detach().double()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def grad_gap(got, want):
    """The worst leaf's largest gap over that leaf's largest value."""
    return max(rel(got[k], want[k]) for k in want)


def cast(p, dtype):
    return {m: {k: v.to(dtype) for k, v in d.items()} for m, d in p.items()}


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_score_taps_and_mask_match_reference(mode, one_torch_thread):
    """Eval mode, and train mode at drop-path 0 (the same forward)."""
    p = seeded()
    critic, masker = port_pair(p)
    critic.train(mode == "train")
    x = nchw(frames(4))
    score, taps = critic(x, collect=True)
    want, want_taps = ref.critic(p["critic"], x.contiguous())
    assert score.shape == (4, 1) and taps[0] is None
    assert [tuple(t.shape[1:]) for t in taps[1:]] == [
        (16, 16, 16), (32, 8, 8), (64, 4, 4), (128, 2, 2)]
    assert all(t.is_contiguous(memory_format=CL) for t in taps[1:])
    assert rel(score[:, 0], want) < TOL
    for t, w in zip(taps[1:], want_taps[1:]):
        assert rel(t, w) < TOL
    z = masker(x, taps)
    assert z.shape == (4, 1, 64, 64)
    assert rel(z, ref.decoder(p["masker"], x.contiguous(), want_taps)) < TOL


def test_published_widths_and_counts():
    """build_pair's convnext_t: torchvision convnext_tiny's 27.82 M
    parameters less its 1000-class head, 23 LayerNorms, 18 depthwise
    layers, drop-path 0 to 0.1 over the blocks, gamma at 1e-6; the
    decoder's skipless 32x32 level (96 -> 96) and its 99-channel head."""
    c, m = build_pair(Config(critic_arch="convnext_t"))
    assert sum(t.numel() for t in c.parameters()) == 27_820_897
    assert len(c.layer_norms) == 23 and len(c.dw_convs) == 18
    assert all(d.kernel_size == (7, 7) and d.groups == d.in_channels
               for d in c.dw_convs)
    ps = [d.p for d in c.drop_paths]
    assert ps[0] == 0.0 and ps[-1] == pytest.approx(0.1) and len(ps) == 18
    assert float(c.features[1][0].layer_scale.detach().max()) \
        == pytest.approx(1e-6)
    assert m.dec_model[0].in_channels == 96 and m.masker[0].in_channels == 99
    cfg = _cfg(small=False)
    assert {k: tuple(v.shape) for k, v in c.state_dict().items()} == {
        key: tuple(shape) for model, key, shape, *_ in
        shapes_convnext_t._drawn(cfg) if model == "critic"}
    assert 2 * sum(L.macs_per_frame for L in shapes_convnext_t.critic_layers(
        cfg)) == 727_309_824


def test_drop_path_keeps_rows_at_its_rate():
    """Each row kept with probability 1 - p and scaled by 1 / (1 - p),
    or zeroed; off in eval mode and at p 0."""
    x = torch.ones(40_000, 3, 2, 2)
    g = torch.Generator().manual_seed(5)
    y = drop_path(x, 0.25, True, g)
    rows = y.flatten(1)
    assert bool((rows == rows[:, :1]).all())            # whole rows
    vals = set(rows[:, 0].tolist())
    assert vals == {0.0, float(np.float32(1.0) / np.float32(0.75))}
    kept = float((rows[:, 0] > 0).double().mean())
    # binomial: 4 standard deviations of the kept share at n = 40000
    assert abs(kept - 0.75) < 4 * (0.75 * 0.25 / 40_000) ** 0.5
    assert drop_path(x, 0.25, False, g) is x
    assert drop_path(x, 0.0, True, g) is x
    c = ConvNeXtCritic(dims=SMALL["dims"], depths=SMALL["depths"])
    c.train()
    xin = nchw(frames(4))
    a = c(xin, generator=torch.Generator().manual_seed(1))
    b = c(xin, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)                # drawn from the generator


def _ref_grads(p, a, y, b, live, dtype, want_frames=True):
    """The reference's loss terms and gradients at `dtype`."""
    pc = cast(p, dtype)
    leaves = {f"masker.{k}": v.requires_grad_(True)
              for k, v in pc["masker"].items()}
    if live:
        leaves.update({f"critic.{k}": v.requires_grad_(True)
                       for k, v in pc["critic"].items()})
    a = a.to(dtype).requires_grad_(want_frames)
    loss, terms = ref.masker_loss(
        TRAIN, {"critic": pc["critic"], "masker": pc["masker"]}, a,
        y.to(dtype), b.to(dtype), live)
    keys = list(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in keys]
                                + ([a] if want_frames else []))
    out = dict(zip(keys + (["frames"] if want_frames else []), grads))
    return terms, out


@pytest.mark.parametrize("live", [False, True], ids=["frozen", "live"])
def test_masker_step_against_reference_passes(live, one_torch_thread):
    """The port's masker loss (fused passes, the skipless join's
    backward, the merges) against the reference's separate passes: the
    loss terms and the gradients of the masker's leaves, a live critic's
    leaves and the frames. A frozen critic runs its drop-path in eval
    mode: the terms match the reference at drop-path 0.1 too."""
    p = seeded()
    cfg = Config(critic_arch="convnext_t", frozen=not live, shift=0,
                 device="cpu").derive()
    critic, masker = port_pair(p, drop=0.0 if live else 0.1)
    models = {"critic": critic, "masker": masker}
    set_masker_modes(cfg, models)
    assert critic.training
    assert any(d.training for d in critic.drop_paths) == live
    u8 = frames(8, seed=4)
    a, b = nchw(u8[:4]).requires_grad_(True), nchw(u8[4:])
    y = torch.linspace(0.0, 1.0, 4)
    loss, aux = build_masker_loss(cfg)(models, a, y, b)
    leaves = {f"masker.{k}": v for k, v in masker.named_parameters()}
    if live:
        leaves.update({f"critic.{k}": v
                       for k, v in critic.named_parameters()})
    keys = list(leaves)
    got = dict(zip(keys + ["frames"], torch.autograd.grad(
        loss, [leaves[k] for k in keys] + [a])))
    terms32, grads32 = _ref_grads(p, a.detach(), y, b, live, torch.float32)
    terms64, grads64 = _ref_grads(p, a.detach(), y, b, live, torch.float64)
    for k in ("replace", "inject", "norm", "critic"):
        want = float(terms64[k].detach())
        assert abs(float(aux[k].detach()) - want) <= TERM_TOL * max(
            abs(want), 1e-3), k
    own = grad_gap(grads32, grads64)
    assert grad_gap(got, grads64) <= 3 * own + TOL, (grad_gap(got, grads64),
                                                     own)


def test_critic_step_against_reference(one_torch_thread):
    """One critic step at drop-path 0: the port's loss and gradients
    against the reference's mean square over the same frames, then
    `critic_step` (the ingest, the loss, Adam) moves every leaf."""
    p = seeded()
    cfg = Config(critic_arch="convnext_t", shift=0, device="cpu").derive()
    critic, _ = port_pair(p)
    critic.train()
    u8 = frames(6, seed=7)
    y = torch.linspace(0.1, 0.9, 6)
    loss = build_critic_loss(cfg)(critic, nchw(u8), y)
    got = dict(zip([k for k, _ in critic.named_parameters()],
                   torch.autograd.grad(loss, list(critic.parameters()))))

    def ref_step(dtype):
        cp = {k: v.to(dtype).requires_grad_(True)
              for k, v in p["critic"].items()}
        score, _ = ref.critic(cp, nchw(u8).contiguous().to(dtype))
        rloss = ((score - y.to(dtype)) ** 2).mean()
        return rloss, dict(zip(cp, torch.autograd.grad(rloss,
                                                       list(cp.values()))))

    loss32, grads32 = ref_step(torch.float32)
    loss64, grads64 = ref_step(torch.float64)
    assert abs(float(loss.detach()) - float(loss64)) \
        <= TERM_TOL * float(loss64)
    assert grad_gap(got, grads64) <= 3 * grad_gap(grads32, grads64) + TOL
    before = {k: v.detach().clone() for k, v in critic.state_dict().items()}
    opt = make_optimizer({"critic": critic})
    seg = Segment(u8, torch.arange(6), 0, y)
    step_loss = critic_step(cfg, critic, opt, seg, StepRng.seeded(0, "cpu"))
    assert abs(float(step_loss) - float(loss64)) <= TERM_TOL * float(loss64)
    after = critic.state_dict()
    assert all(not torch.equal(after[k], v) for k, v in before.items())


def test_counters_and_spans(one_torch_thread):
    """`model.layer_norms` and `model.dw_convs` per critic forward (11
    and 6 at depths 1/1/3/1), the ConvNeXt spans inside
    `cgs.model.critic`."""
    p = seeded()
    critic, masker = port_pair(p)
    pipe = MaskPipeline(critic, masker, p, batch_size=2, device="cpu")
    before = dict(counts)
    with torch.profiler.profile() as prof:
        pipe.run(frames(4).numpy())
    delta = {k: counts[k] - before.get(k, 0) for k in (
        "model.critic_frames", "model.masker_frames", "model.layer_norms",
        "model.dw_convs", "model.bn_running")}
    assert delta == {"model.critic_frames": 4, "model.masker_frames": 4,
                     "model.layer_norms": 22, "model.dw_convs": 12,
                     "model.bn_running": 0}
    names = [e.name for e in prof.events()]
    assert names.count("cgs.model.critic") == 2
    for s in ("stem", "stage1", "stage2", "stage3", "stage4", "head"):
        assert names.count(f"cgs.model.convnext.{s}") == 2, s
    spans = [e for e in prof.events() if e.name.startswith("cgs.model.")]
    outer = [e for e in spans if e.name == "cgs.model.critic"]
    for e in spans:
        if e.name.startswith("cgs.model.convnext."):
            assert any(o.time_range.start <= e.time_range.start
                       and e.time_range.end <= o.time_range.end
                       for o in outer), e.name


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


def test_process_cli_and_checkpoint_round_trip(tmp_path, monkeypatch,
                                               one_torch_thread):
    """`-process --critic convnext_t` on a few frames from checkpoints
    that a convnext_t Handler saved, against the reference; the saved
    state dicts load back as they were."""
    monkeypatch.chdir(tmp_path)
    p = seeded(small=False)
    argv = ["--critic", "convnext_t", "--model", "cnx", "--device", "cpu"]
    h = Handler(parse_args(argv))
    assert isinstance(h.critic, ConvNeXtCritic)
    h.params = {"critic": p["critic"], "masker": p["masker"]}
    h.save_models(["critic", "masker"])
    assert h.save_paths["critic"].endswith("-critic=convnext_t.pt")
    for name in ("critic", "masker"):
        back = load_model_pt(name, h.save_paths[name], "convnext_t")
        assert back.keys() == p[name].keys()
        assert all(torch.equal(back[k], v) for k, v in p[name].items())
    src = tmp_path / "src"
    src.mkdir()
    u8 = frames(2, seed=6)
    for i, f in enumerate(u8.numpy()):
        Image.fromarray(f).save(src / f"img{i:03d}.png")
    out = cli.main(argv + ["-cload", "1", "-mload", "1", "-process",
                           "--source-imgs", str(src),
                           "--mask-output-imgs", str(tmp_path / "out")])
    for name in ("critic", "masker"):
        for k, v in p[name].items():
            assert torch.equal(out.params[name][k], v), k
    _, mask = ref.forward_masks(p, u8)
    for i in range(2):
        png = np.asarray(Image.open(tmp_path / "out" /
                                    f"img{i:03d}-raw-mask.png"))
        levels = torch.from_numpy(png[..., 0].copy())
        assert compare.level_gap(levels, mask[i]) < 1e-3


def test_checkpoint_keys_are_checked(tmp_path):
    """A convnext_t critic checkpoint must hold every key of the
    critic; a paper or ResNet-18 one is refused."""
    p = seeded(small=False)
    path = str(tmp_path / "c.pt")
    with pytest.raises(KeyError, match="lacks"):
        save_model_pt({k: v for k, v in p["critic"].items()
                       if not k.endswith("layer_scale")}, "critic", path,
                      "convnext_t")
    save_model_pt(build_pair(Config(critic_arch="resnet18"))[0]
                  .state_dict(), "critic", path, "resnet18")
    with pytest.raises(KeyError, match="not a critic checkpoint"):
        load_model_pt("critic", path, "convnext_t")


@pytest.mark.parametrize("flag", [["--chfak", "5"], ["--neck", "64"]])
def test_widths_flags_refused(flag):
    with pytest.raises(ValueError, match=flag[0] + " " + flag[1]):
        build_pair(parse_args(["--critic", "convnext_t", "--device", "cpu"]
                              + flag))


def test_torchvision_keyed_backbone_loads_with_head_false(tmp_path,
                                                          one_torch_thread):
    """A state dict in torchvision convnext_tiny's keys, built from the
    reference's seeded weights with a 1000-class `classifier.2`, loads
    with head=False (everything but that linear) and gives the
    reference's taps; with head=True it is refused."""
    p = seeded()
    raw = {k: v for k, v in p["critic"].items()
           if not k.startswith("classifier.2")}
    raw["classifier.2.weight"] = torch.zeros(1000, SMALL["dims"][-1])
    raw["classifier.2.bias"] = torch.zeros(1000)
    torch.save(raw, tmp_path / "tv.pt")
    with pytest.raises(ValueError, match="head=False"):
        load_pt_convnext_critic(str(tmp_path / "tv.pt"))
    sd = load_pt_convnext_critic(str(tmp_path / "tv.pt"), head=False)
    assert sd.keys() == {k for k in p["critic"]
                         if not k.startswith("classifier.2")}
    critic, _ = port_pair({"critic": p["critic"], "masker": p["masker"]})
    with torch.no_grad():
        for t in critic.parameters():
            t.zero_()
    missing, unexpected = critic.load_state_dict(sd, strict=False)
    assert set(missing) == {"classifier.2.weight", "classifier.2.bias"}
    assert not unexpected
    x = nchw(frames(2))
    _, taps = critic.eval()(x, collect=True)
    _, want = ref.critic(p["critic"], x.contiguous())
    for t, w in zip(taps[1:], want[1:]):
        assert rel(t, w) < TOL
    torch.save(p["critic"], tmp_path / "critic.pt")
    whole = load_pt_convnext_critic(str(tmp_path / "critic.pt"))
    assert whole.keys() == p["critic"].keys()


def test_int8_and_seed_parallel_refuse_it(one_torch_thread):
    """int8 runs the paper's Critic only; the seed-parallel runner
    stacks the paper's critic only, and says which flag it refuses."""
    p = seeded()
    critic, masker = port_pair(p)
    with pytest.raises(ValueError, match="paper's Critic only"):
        MaskPipeline(critic, masker, p, quantize="int8", device="cpu")
    cfg = Config(critic_arch="convnext_t", device="cpu").derive()
    x = np.zeros((4, 64, 64, 3), np.uint8)
    y = np.zeros((7, 4), np.float32)
    with pytest.raises(ValueError, match="--critic convnext_t"):
        seed_parallel.run_parallel(cfg, x, y, runs=2)
    with pytest.raises(ValueError, match="--critic resnet18"):
        seed_parallel.main(["--runs", "2", "--critic", "resnet18",
                            "--device", "cpu", "-synthetic_data"])


def test_critic_forward_counts_nothing_for_the_paper_critic():
    """The paper critic lists no LayerNorm or depthwise layer: its
    forwards leave those counters alone."""
    c, _ = build_pair(Config())
    before = dict(counts)
    critic_forward(c.eval(), torch.rand(2, 3, 64, 64))
    for k in ("model.layer_norms", "model.dw_convs"):
        assert counts[k] == before.get(k, 0)


def test_no_jax_and_a_plain_reference():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import cgs_tpu_torch.models.build, cgs_tpu_torch.pipeline\n"
            "import portbench.drivers.process_convnext_t\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'cgs_tpu'}\n"
            "assert not bad, bad\n" % str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
    src = (ROOT / "portbench/reference/convnext_t.py").read_text()
    assert "cgs_tpu" not in src and "import jax" not in src
