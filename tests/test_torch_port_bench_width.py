"""PyTorch port: the width sweep (`cgs_tpu_torch/sandbox/bench_width.py`)
on the CPU at chfak 2, mirroring tests/test_sandbox.py's bench_width
smoke (2 steps x 1 round), plus a batch-8 inference line, the whole CLI
with --fuse-sweep, and the `fuse` keyword it passes through
`train/loops.py:masker_chunk` and `train/steps.py:masker_step`: the
default ("both") leaves a masker step's terms and gradients bit-equal
to the step as it was built before the keyword (`build_masker_loss(cfg)`
called with no `fuse`), and "none" / "merges" (the reference's separate
critic calls) agree with it within 1e-5 (f32 convolutions over other
batch splits, dropout 0).
"""

import functools
import importlib

import pytest
import torch

from cgs_tpu_torch.core.config import Config
from cgs_tpu_torch.models.interop import init_torch_default
from cgs_tpu_torch.ops.kernels import Segment
from cgs_tpu_torch.train.losses import build_masker_loss
from cgs_tpu_torch.train.steps import StepRng, masker_batch, masker_step
from torch_port_common import one_torch_thread, port_models  # noqa: F401

bench_width = importlib.import_module("cgs_tpu_torch.sandbox.bench_width")


def test_training_smoke(one_torch_thread):
    out = bench_width.bench_training(chfak=2, dropout=0.5, bf16=False,
                                     steps=2, rounds=1, device="cpu")
    metrics = {r["metric"]: r for r in out}
    assert set(metrics) == {"critic_train_steps_per_sec",
                            "masker_train_steps_per_sec"}
    for r in out:
        assert r["chfak"] == 2 and r["dtype"] == "f32" and r["value"] > 0
    assert metrics["masker_train_steps_per_sec"]["fuse"] == "both"


def test_inference_line(one_torch_thread):
    r = bench_width.bench_inference(chfak=2, dropout=0.5, batch=8,
                                    n_iter=1, bf16=False, device="cpu")
    assert r["metric"] == "process_fps" and r["batch"] == 8
    assert r["value"] > 0 and r["ms_per_dispatch"] > 0
    assert r["device"] == "cpu" and "quantize" not in r


def test_main_with_fuse_sweep(one_torch_thread, capsys, monkeypatch):
    """Inference f32 / bf16, both chunks f32 / bf16, the masker chunk at
    fuse none and merges: eight lines, then the summary line. The
    chunks are cut to 2 steps x 1 round (the CLI, as JAX's, times 100 x
    6)."""
    monkeypatch.setattr(bench_width, "bench_training", functools.partial(
        bench_width.bench_training, steps=2, rounds=1))
    out = bench_width.main(["--chfak", "2", "--batch", "8", "--iters", "1",
                            "--fuse-sweep", "--device", "cpu"])
    assert [(r["metric"], r["dtype"], r.get("fuse")) for r in out] == [
        ("process_fps", "f32", None), ("process_fps", "bf16", None),
        ("critic_train_steps_per_sec", "f32", None),
        ("masker_train_steps_per_sec", "f32", "both"),
        ("critic_train_steps_per_sec", "bf16", None),
        ("masker_train_steps_per_sec", "bf16", "both"),
        ("masker_train_steps_per_sec", "f32", "none"),
        ("masker_train_steps_per_sec", "f32", "merges")]
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last == ('{"metric": "width_bench_done", "chfak": 2, "n": 8}')
    # JAX's flags but --pallas-upsample-ab (no counterpart in the port),
    # and no chunk-size flags (JAX has none)
    for argv in (["--pallas-upsample-ab"], ["--steps", "2"],
                 ["--rounds", "1"]):
        with pytest.raises(SystemExit):
            bench_width.main([*argv, "--device", "cpu"])


def _masker_setup():
    cfg = Config(shift=0, dropout=0.0, chfak=1, inject=True).derive()
    gen = torch.Generator().manual_seed(3)
    critic, masker = (init_torch_default(m, gen) for m in port_models())
    bank = torch.randint(0, 256, (48, 64, 64, 3), dtype=torch.uint8,
                         generator=gen)
    y = torch.rand(48, generator=gen)
    idx = torch.randint(0, 48, (3, 8), generator=gen)
    a = [Segment(bank, idx[0], labels=y), Segment(bank, idx[1], labels=y)]
    b = Segment(bank, torch.cat([idx[2], idx[0]]))
    return cfg, {"critic": critic, "masker": masker}, a, b


def _step(fuse=None):
    """One masker step's terms and gradients; fuse None: the step built
    as before the keyword existed."""
    cfg, models, a, b = _masker_setup()
    opt = torch.optim.SGD([p for m in models.values()
                           for p in m.parameters()], lr=0.0)
    rng = StepRng.seeded(0, "cpu")
    if fuse is None:
        ab, y, n = masker_batch(cfg, a, b, rng)
        loss, aux = build_masker_loss(cfg)(models, ab[:n], y, ab[n:],
                                           rng.dropout, ab=ab)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        terms = tuple(aux[t].detach() for t in
                      ("replace", "inject", "norm", "critic"))
    else:
        kw = {} if fuse == "default" else {"fuse": fuse}
        terms = masker_step(cfg, models, opt, a, b, rng, **kw)
    grads = {f"{k}.{n}": p.grad.clone() for k, m in models.items()
             for n, p in m.named_parameters() if p.grad is not None}
    return torch.stack(terms), grads


def test_default_fuse_is_bit_equal_to_before(one_torch_thread):
    want_t, want_g = _step(None)
    for fuse in ("default", "both"):
        got_t, got_g = _step(fuse)
        assert torch.equal(got_t, want_t)
        assert got_g.keys() == want_g.keys() and len(got_g) > 10
        for k in want_g:
            assert torch.equal(got_g[k], want_g[k]), k
    for fuse in ("none", "merges"):
        got_t, got_g = _step(fuse)
        torch.testing.assert_close(got_t, want_t, atol=1e-5, rtol=0)
        for k in want_g:
            scale = float(want_g[k].abs().max()) or 1.0
            torch.testing.assert_close(got_g[k] / scale, want_g[k] / scale,
                                       atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="fuse"):
        _step("all")
