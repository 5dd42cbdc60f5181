"""PyTorch port: the `--critic swin_v2_t` pair (`models/build.py`), the
Swin Transformer V2-T critic with the paper's U-Net masker on its four
stages, against the benchmark's plain reference (`portbench/reference/
swin_v2_t.py`) on seeded weights (`portbench/lib/shapes_swin_v2_t.py`),
on the CPU at a few frames and at small widths that keep Swin's head
size ratio and a shifted second block in stage 1 (embed 16, heads 2 / 4
/ 8 / 16, depths 2 / 1 / 2 / 1, window 8); the geometry, the shift
mask, the position bias, the CLI, the checkpoints and the counters at
the published widths.

Tolerances and helpers are `test_torch_port_convnext.py`'s. Forward numbers
(scores, taps, masks) agree within 1e-5 of the tensor's largest value:
the port's GEMMs, its fused q and k normalisation and its attention
(oneDNN, one launch or the scores written out) and the reference's
(explicit softmax over materialised scores, windows cut by indexing)
sum in other orders, and the f32 reference's own gap against float64
here is under 1e-6 of the largest value. Each piece of the mathematics
left out (the shift mask, the roll, 16 sigmoid, the temperature's
clamp, the post-norm's place) moves them by far more than that
(`test_each_left_out_piece_breaks_the_comparison`). The loss terms
agree within 1e-4 of their size (floor 1e-3), and gradients within
three times the f32 reference's own gap against the float64 reference,
plus 1e-5, per leaf as its largest gap over its largest value: f32
alone sets how close two f32 computations of a gradient through
softmax, LayerNorm and the sigmoid's tails can be.
"""

import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from PIL import Image

import cgs_tpu_torch.models.swin as swin
from cgs_tpu_torch import cli
from cgs_tpu_torch.core.config import Config, parse_args
from cgs_tpu_torch.handler import Handler
from cgs_tpu_torch.models.build import build_pair
from cgs_tpu_torch.models.decoder import UnetDecoder
from cgs_tpu_torch.models.swin import SwinV2Critic
from cgs_tpu_torch.ops.kernels import Segment
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.sandbox import seed_parallel
from cgs_tpu_torch.train.checkpoints import load_model_pt, save_model_pt
from cgs_tpu_torch.train.losses import build_critic_loss, build_masker_loss
from cgs_tpu_torch.train.steps import (
    StepRng, critic_step, make_optimizer, set_masker_modes,
)
from cgs_tpu_torch.utils.profiling import counts
from test_torch_port_convnext import (
    TERM_TOL, TOL, TRAIN, cast, frames, grad_gap, nchw, rel,
)
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench.lib import compare, shapes_swin_v2_t  # noqa: E402
from portbench.lib.manifest import load_json  # noqa: E402
from portbench.reference import swin_v2_t as ref  # noqa: E402

SEED = 2 ** 31 + 41
CL = torch.channels_last
SMALL = {"embed_dim": 16, "num_heads": [2, 4, 8, 16],
         "depths": [2, 1, 2, 1], "decoder_edims": [0, 16, 32, 64],
         "decoder_widths": [16, 16, 32, 64], "neck": 128}


def _cfg(small=True):
    cfg = load_json(ROOT / "portbench/configs/swin_v2_t.json")
    return dict(cfg, **SMALL) if small else cfg


_PARAMS = {}


def seeded(small=True):
    """The benchmark's seeded weights; cached (callers copy before
    changing them)."""
    if small not in _PARAMS:
        _PARAMS[small] = shapes_swin_v2_t.seeded_params(_cfg(small), SEED,
                                                        "cpu")
    return {m: {k: v.clone() for k, v in d.items()}
            for m, d in _PARAMS[small].items()}


def port_pair(params, drop=0.0):
    """The pair at the small widths, drop-path `drop`, on `params`."""
    c = SwinV2Critic(embed=SMALL["embed_dim"], depths=SMALL["depths"],
                     heads=SMALL["num_heads"], drop_path=drop)
    m = UnetDecoder(edims=SMALL["decoder_edims"],
                    ddims=SMALL["decoder_widths"], bottleneck=SMALL["neck"])
    c.load_state_dict(params["critic"])
    m.load_state_dict(params["masker"])
    return c.to(memory_format=CL), m.to(memory_format=CL)


def _forward_gaps(critic, p, x):
    """The worst of the score's and the taps' gaps to the reference."""
    with torch.no_grad():
        score, taps = critic(x, collect=True)
    want, want_taps = ref.critic(p["critic"], x.contiguous())
    return max([rel(score[:, 0], want)]
               + [rel(t, w) for t, w in zip(taps[1:], want_taps[1:])])


@pytest.mark.parametrize("route", ["eval", "train", "fused"])
def test_score_taps_and_mask_match_reference(route, monkeypatch,
                                             one_torch_thread):
    """Eval mode, train mode at drop-path 0 (the same forward), and the
    fused route's layout (the (B, windows x heads, N, d) operands and the
    folded bias with its aligned rows, here through PyTorch's CPU
    attention in place of `attend_fused`'s card-only backend) against
    the reference."""
    if route == "fused":
        monkeypatch.setattr(swin, "fused_route", lambda q: True)
        monkeypatch.setattr(
            swin, "attend_fused",
            lambda q, k, v, bias: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias, scale=1.0))
    p = seeded()
    critic, masker = port_pair(p)
    critic.train(route == "train")
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


def test_geometry_at_the_published_widths():
    """At 64x64: windows 8, 8, 4, 2; the shift 4 in stage 1's second
    block only; every window whole, so no token is padding; the bias
    each layer hands the fused route has its rows 16-aligned."""
    c, _ = build_pair(Config(critic_arch="swin_v2_t"))
    got = [(a.hw, a.window, a.shift, a.heads) for a in c.window_attns]
    assert got == [(16, 8, 0, 3), (16, 8, 4, 3), (8, 8, 0, 6), (8, 8, 0, 6)] \
        + [(4, 4, 0, 12)] * 6 + [(2, 2, 0, 24)] * 2
    assert [a.attn_mask is not None for a in c.window_attns] == [
        a.shift > 0 for a in c.window_attns]
    for a in c.window_attns:
        nw = a.hw // a.window
        assert nw * a.window == a.hw           # whole windows, no padding
        assert a.relative_position_index.shape == (a.window ** 2,) * 2
        b = a.bias()
        assert b.shape == (1, nw * nw * a.heads, a.window ** 2,
                           a.window ** 2)
        assert all(s % swin.ALIGN == 0 for s in b.stride()[:-1])
    assert [(w, s) for *_, w, s in shapes_swin_v2_t.stages(_cfg(False))] \
        == [(8, 4), (8, 0), (4, 0), (2, 0)]


def _authors_mask(hw, ws, shift):
    """The authors' construction (swin_transformer_v2.py,
    SwinTransformerBlock.__init__): an image of region ids cut by
    slices, partitioned into windows, -100 where two ids differ."""
    img = torch.zeros((1, hw, hw, 1))
    cnt = 0
    cuts = (slice(0, -ws), slice(-ws, -shift), slice(-shift, None))
    for h in cuts:
        for w in cuts:
            img[:, h, w, :] = cnt
            cnt += 1
    win = img.view(1, hw // ws, ws, hw // ws, ws, 1).permute(
        0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    m = win.unsqueeze(1) - win.unsqueeze(2)
    return m.masked_fill(m != 0, -100.0).masked_fill(m == 0, 0.0)


@pytest.mark.parametrize("hw,ws,shift", [(16, 8, 4), (32, 8, 4),
                                         (16, 4, 2)])
def test_shift_mask_is_the_authors(hw, ws, shift):
    assert torch.equal(swin.shift_mask(hw, ws, shift),
                       _authors_mask(hw, ws, shift))
    assert torch.equal(ref.region_mask(hw, ws, shift, "cpu"),
                       _authors_mask(hw, ws, shift))


@pytest.mark.parametrize("ws", [8, 4, 2])
def test_position_bias_table_is_log_spaced(ws):
    """The CPB input: sign(t) log2(1 + |8 t|) / 3, t = offset / (w - 1);
    the offset index maps each pair to its row; the gathered 16
    sigmoid(B) equals the reference's."""
    t = swin.coords_table(ws)
    assert t.shape == (2 * ws - 1, 2 * ws - 1, 2)
    for a in range(-(ws - 1), ws):
        for b in range(-(ws - 1), ws):
            for v, off in zip(t[a + ws - 1, b + ws - 1].tolist(), (a, b)):
                u = 8.0 * off / (ws - 1)
                want = math.copysign(math.log2(1 + abs(u)) / 3, u)
                assert v == pytest.approx(want, abs=1e-6)
    assert float(t.abs().max()) == pytest.approx(math.log2(9) / 3)
    idx = swin.offset_index(ws)
    n = ws * ws
    for i in (0, n - 1, n // 2 + 1):
        for j in (0, n - 1, 3 % n):
            dh, dw = i // ws - j // ws, i % ws - j % ws
            assert int(idx[i, j]) == (dh + ws - 1) * (2 * ws - 1) + dw \
                + ws - 1
    attn = swin.WindowAttentionV2(16, 2, ws, ws, 0)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for q in attn.cpb_mlp.parameters():
            q.uniform_(-0.5, 0.5, generator=gen)
    p = {f"a.{k}": v for k, v in attn.state_dict().items()}
    with torch.no_grad():
        got = attn.bias()[0]
    want = ref.position_bias(p, "a", ws)
    assert float((got - want).abs().max()) < 1e-6


def _bias_without_sigmoid(self):
    h, n = self.heads, self.window * self.window
    table = self.cpb_mlp(self.relative_coords_table).view(-1, h)
    b = table[self.relative_position_index.view(-1)].view(n, n, h) \
        .permute(2, 0, 1).unsqueeze(0)
    b = b.expand((self.hw // self.window) ** 2, h, n, n)
    if self.attn_mask is not None:
        b = b + self.attn_mask.unsqueeze(1)
    return b.reshape(1, -1, n, n)


def _pre_norm_forward(self, x, generator=None):
    x = x + self.stochastic_depth(self.attn(self.norm1(x)), generator)
    return x + self.stochastic_depth(self.mlp(self.norm2(x)), generator)


@pytest.mark.parametrize("piece", ["shift_mask", "roll", "sigmoid",
                                   "clamp", "post_norm"])
def test_each_left_out_piece_breaks_the_comparison(piece, monkeypatch,
                                                   one_torch_thread):
    """The sound forward within TOL, then each piece of the mathematics
    left out: far outside it. One head's temperature is set above log
    100 in both weight sets, so that the clamp acts."""
    p = seeded()
    p["critic"]["features.1.1.attn.logit_scale"][0] = math.log(300.0)
    critic, _ = port_pair(p)
    critic.eval()
    x = nchw(frames(4, seed=9))
    assert _forward_gaps(critic, p, x) < TOL
    shifted = critic.window_attns[1]
    if piece == "shift_mask":
        shifted.attn_mask = None
    elif piece == "roll":
        shifted.shift = 0
    elif piece == "sigmoid":
        monkeypatch.setattr(swin.WindowAttentionV2, "bias",
                            _bias_without_sigmoid)
    elif piece == "clamp":
        monkeypatch.setattr(swin, "LOGIT_MAX", float("inf"))
    else:
        monkeypatch.setattr(swin.SwinBlockV2, "forward", _pre_norm_forward)
    assert _forward_gaps(critic, p, x) > 100 * TOL


def test_published_widths_and_counts():
    """build_pair's swin_v2_t: torchvision swin_v2_t's keys and its
    28,351,570 parameters less its 1000-class head plus the one-output
    one; 29 LayerNorms, 12 window attentions, drop-path 0 to 0.2 over
    the 12 blocks; ConvNeXt-T's decoder (no 32x32 skip, a 99-channel
    head); the FLOPs a frame as configured."""
    c, m = build_pair(Config(critic_arch="swin_v2_t"))
    n = sum(t.numel() for t in c.parameters())
    assert n == 28_351_570 - (768 * 1000 + 1000) + (768 + 1) == 27_583_339
    assert len(c.layer_norms) == 29 and len(c.window_attns) == 12
    ps = [d.p for d in c.drop_paths]
    assert len(ps) == 12 and ps[0] == 0.0 and ps[-1] == pytest.approx(0.2)
    assert all(ln.eps == 1e-5 for ln in c.layer_norms)
    assert m.dec_model[0].in_channels == 96 and m.masker[0].in_channels == 99
    cfg = _cfg(small=False)
    assert {k: tuple(v.shape) for k, v in c.state_dict().items()} == {
        key: tuple(shape) for model, key, shape, *_ in
        shapes_swin_v2_t._drawn(cfg) if model == "critic"}
    assert {k: tuple(v.shape) for k, v in m.state_dict().items()} == {
        key: tuple(shape) for model, key, shape, *_ in
        shapes_swin_v2_t._drawn(cfg) if model == "masker"}
    assert len(shapes_swin_v2_t.layer_norms(cfg)) == 29
    assert len(shapes_swin_v2_t.window_attns(cfg)) == 12
    assert shapes_swin_v2_t.window_attn_flops(cfg, 1) == 21_331_968
    assert shapes_swin_v2_t.process_flops_per_frame(cfg) == 1_406_240_256


def test_drop_path_draws_from_the_generator():
    c = SwinV2Critic(embed=SMALL["embed_dim"], depths=SMALL["depths"],
                     heads=SMALL["num_heads"], drop_path=0.5)
    x = nchw(frames(6))
    c.train()
    a = c(x, generator=torch.Generator().manual_seed(1))
    b = c(x, generator=torch.Generator().manual_seed(1))
    d = c(x, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, d)
    c.eval()
    assert torch.equal(c(x, generator=torch.Generator().manual_seed(1)),
                       c(x, generator=torch.Generator().manual_seed(2)))


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


def _k_bias_grads_zero(grads):
    """The k third of each qkv bias gets no gradient: it is zeroed at
    every forward (the reference never reads it)."""
    for k, g in grads.items():
        if k.endswith("attn.qkv.bias"):
            third = g.shape[0] // 3
            assert float(g[third:2 * third].abs().max()) == 0.0, k


@pytest.mark.parametrize("live", [False, True], ids=["frozen", "live"])
def test_masker_step_against_reference_passes(live, one_torch_thread):
    """The port's masker loss (fused passes, the plain attention route
    in grad mode, the skipless join's backward, the merges) against the
    reference's separate passes: the loss terms and the gradients of
    the masker's leaves, a live critic's leaves and the frames. A frozen
    critic runs its drop-path in eval mode: the terms match the
    reference at drop-path 0.2 too."""
    p = seeded()
    cfg = Config(critic_arch="swin_v2_t", frozen=not live, shift=0,
                 device="cpu").derive()
    critic, masker = port_pair(p, drop=0.0 if live else 0.2)
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
    _k_bias_grads_zero(got)
    own = grad_gap(grads32, grads64)
    assert grad_gap(got, grads64) <= 3 * own + TOL, (grad_gap(got, grads64),
                                                     own)


def test_critic_step_against_reference(one_torch_thread):
    """One critic step at drop-path 0: the port's loss and gradients
    against the reference's mean square over the same frames, then
    `critic_step` (the ingest, the loss, Adam) moves every leaf but the
    qkv biases' k thirds, which no forward reads."""
    p = seeded()
    cfg = Config(critic_arch="swin_v2_t", shift=0, device="cpu").derive()
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
    _k_bias_grads_zero(got)
    assert grad_gap(got, grads64) <= 3 * grad_gap(grads32, grads64) + TOL
    before = {k: v.detach().clone() for k, v in critic.state_dict().items()}
    opt = make_optimizer({"critic": critic})
    seg = Segment(u8, torch.arange(6), 0, y)
    step_loss = critic_step(cfg, critic, opt, seg, StepRng.seeded(0, "cpu"))
    assert abs(float(step_loss) - float(loss64)) <= TERM_TOL * float(loss64)
    after = critic.state_dict()
    for k, v in before.items():
        if k.endswith("attn.qkv.bias"):
            third = v.shape[0] // 3
            assert torch.equal(after[k][third:2 * third], v[third:2 * third])
            assert not torch.equal(after[k], v)
        else:
            assert not torch.equal(after[k], v), k


def test_counters_and_spans(one_torch_thread):
    """`model.window_attns` (12) and `model.layer_norms` (29) a critic
    forward at the published widths, the Swin spans inside
    `cgs.model.critic`."""
    c, m = build_pair(Config(critic_arch="swin_v2_t"))
    params = {"critic": c.state_dict(), "masker": m.state_dict()}
    pipe = MaskPipeline(c, m, params, batch_size=2, device="cpu")
    before = dict(counts)
    with torch.profiler.profile() as prof:
        pipe.run(frames(4).numpy())
    delta = {k: counts[k] - before.get(k, 0) for k in (
        "model.critic_frames", "model.masker_frames", "model.layer_norms",
        "model.window_attns", "model.dw_convs", "model.bn_running")}
    assert delta == {"model.critic_frames": 4, "model.masker_frames": 4,
                     "model.layer_norms": 58, "model.window_attns": 24,
                     "model.dw_convs": 0, "model.bn_running": 0}
    names = [e.name for e in prof.events()]
    assert names.count("cgs.model.critic") == 2
    for s in ("patch_embed", "stage1", "stage2", "stage3", "stage4",
              "head"):
        assert names.count(f"cgs.model.swin.{s}") == 2, s
    spans = [e for e in prof.events() if e.name.startswith("cgs.model.")]
    outer = [e for e in spans if e.name == "cgs.model.critic"]
    for e in spans:
        if e.name.startswith("cgs.model.swin."):
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
    """`-process --critic swin_v2_t` on a few frames from checkpoints
    that a swin_v2_t Handler saved, against the reference; the saved
    state dicts load back as they were."""
    monkeypatch.chdir(tmp_path)
    p = seeded(small=False)
    argv = ["--critic", "swin_v2_t", "--model", "swn", "--device", "cpu"]
    h = Handler(parse_args(argv))
    assert isinstance(h.critic, SwinV2Critic)
    h.params = {"critic": p["critic"], "masker": p["masker"]}
    h.save_models(["critic", "masker"])
    assert h.save_paths["critic"].endswith("-critic=swin_v2_t.pt")
    for name in ("critic", "masker"):
        back = load_model_pt(name, h.save_paths[name], "swin_v2_t")
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
    """A swin_v2_t critic checkpoint must hold every key of the critic;
    a ConvNeXt-T one is refused."""
    p = seeded(small=False)
    path = str(tmp_path / "c.pt")
    with pytest.raises(KeyError, match="lacks"):
        save_model_pt({k: v for k, v in p["critic"].items()
                       if not k.endswith("logit_scale")}, "critic", path,
                      "swin_v2_t")
    save_model_pt(build_pair(Config(critic_arch="convnext_t"))[0]
                  .state_dict(), "critic", path, "convnext_t")
    with pytest.raises(KeyError, match="not a critic checkpoint"):
        load_model_pt("critic", path, "swin_v2_t")


@pytest.mark.parametrize("flag", [["--chfak", "5"], ["--neck", "64"]])
def test_widths_flags_refused(flag):
    with pytest.raises(ValueError, match=flag[0] + " " + flag[1]):
        build_pair(parse_args(["--critic", "swin_v2_t", "--device", "cpu"]
                              + flag))


def test_int8_and_seed_parallel_refuse_it(one_torch_thread):
    """int8 runs the paper's Critic only; the seed-parallel runner
    stacks the paper's critic only, and names the flag it refuses."""
    p = seeded()
    critic, masker = port_pair(p)
    with pytest.raises(ValueError, match="paper's Critic only"):
        MaskPipeline(critic, masker, p, quantize="int8", device="cpu")
    cfg = Config(critic_arch="swin_v2_t", device="cpu").derive()
    x = np.zeros((4, 64, 64, 3), np.uint8)
    y = np.zeros((7, 4), np.float32)
    with pytest.raises(ValueError, match="--critic swin_v2_t"):
        seed_parallel.run_parallel(cfg, x, y, runs=2)
    with pytest.raises(ValueError, match="--critic swin_v2_t"):
        seed_parallel.main(["--runs", "2", "--critic", "swin_v2_t",
                            "--device", "cpu", "-synthetic_data"])


def test_other_frame_sizes_refused():
    c = SwinV2Critic(embed=SMALL["embed_dim"], depths=SMALL["depths"],
                     heads=SMALL["num_heads"])
    with pytest.raises(ValueError, match="64x64 frames"):
        c(torch.rand(1, 3, 32, 32))


def test_no_jax_and_a_plain_reference():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import cgs_tpu_torch.models.build, cgs_tpu_torch.pipeline\n"
            "import portbench.drivers.process_swin_v2_t\n"
            "bad = {m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'cgs_tpu'}\n"
            "assert not bad, bad\n" % str(ROOT))
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)
    src = (ROOT / "portbench/reference/swin_v2_t.py").read_text()
    assert "cgs_tpu" not in src and "import jax" not in src
    assert "scaled_dot_product_attention" not in src
    assert "allow_tf32" in (ROOT / "portbench/reference/model.py"
                            ).read_text()
