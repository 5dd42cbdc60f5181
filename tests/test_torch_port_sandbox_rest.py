"""PyTorch port: the dataset collectors (`cgs_tpu_torch/data/
collect_variants.py`), the reward-discount exploration
(`sandbox/dev.py`) and the TensorBoard export (`utils/tb_export.py`)
against the JAX package's on the same inputs, mirroring
tests/test_sandbox.py's collector and dev cases and
tests/test_aux_subsystems.py's export case.

Tolerances: the collectors' outputs exactly equal (numpy on both
sides); dev's discount rows within 1e-6 (f32 recursions, a host loop
against `lax.scan`); the exported scalars equal tag for tag, step for
step, value for value.
"""

import gzip
import importlib
import os
import pickle
import sys

import numpy as np
import pytest
from PIL import Image

from cgs_tpu.data import collect_variants as jcv
from cgs_tpu.utils import tb_export as jtb
from cgs_tpu_torch.data import collect_variants as cv
from cgs_tpu_torch.utils import artifacts, tb_export
from cgs_tpu_torch.utils.metrics import MetricsWriter

# the sandbox packages export a function named like the module
jdev = importlib.import_module("cgs_tpu.sandbox.dev")
dev = importlib.import_module("cgs_tpu_torch.sandbox.dev")


def _episode(seed, n=400, p=0.02):
    rng = np.random.default_rng(seed)
    reward = (rng.random(n) < p).astype(np.float64)
    pov = rng.integers(0, 256, (n, 4, 4, 3), dtype=np.uint8)
    return pov, reward


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collectors_equal_jax(seed):
    pov, reward = _episode(seed)
    for d in (50, 100):
        np.testing.assert_array_equal(cv.dedupe_chops(reward, d),
                                      jcv.dedupe_chops(reward, d))
    for got, want in zip(cv.split_chunks(pov, reward, chunklen=40),
                         jcv.split_chunks(pov, reward, chunklen=40)):
        np.testing.assert_array_equal(got, want)
    for kw in ({}, {"gamma": 0.9, "delay": 3, "trajsize": 30}):
        for got, want in zip(cv.discounted_variants(reward, **kw),
                             jcv.discounted_variants(reward, **kw)):
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        cv.reward_window_frames(pov, reward, window=5),
        jcv.reward_window_frames(pov, reward, window=5))
    y = np.random.default_rng(seed).random((7, 400)).astype(np.float32)
    for got, want in zip(cv.merge_negative_bank(pov, y, pov[:9]),
                         jcv.merge_negative_bank(pov, y, pov[:9])):
        np.testing.assert_array_equal(got, want)


def test_collectors_on_empty_episodes_equal_jax():
    pov, reward = _episode(0, n=50, p=0.0)
    for got, want in zip(cv.split_chunks(pov, reward),
                         jcv.split_chunks(pov, reward)):
        assert got.shape == want.shape and got.dtype == want.dtype
    for got, want in zip(cv.discounted_variants(reward),
                         jcv.discounted_variants(reward)):
        assert got.shape == want.shape and got.dtype == want.dtype


def test_dev_rows_equal_jax():
    rng = np.random.default_rng(0)
    rewards = [np.zeros(12, np.float32)]
    rewards[0][[4, 9]] = 1.0
    rewards += [(rng.random(60) > 0.9).astype(np.float32) for _ in range(4)]
    rewards.append(np.zeros(30, np.float32))       # no reward at all
    for reward in rewards:
        for gamma, nonrew in dev.DEV_SPECS:
            np.testing.assert_allclose(
                dev.dev_discount_row(reward, gamma, nonrew),
                jdev.dev_discount_row(reward, gamma, nonrew),
                atol=1e-6, rtol=0)
    assert dev.DEV_SPECS == jdev.DEV_SPECS
    np.testing.assert_allclose(dev.dev_label_matrix(rewards, 150),
                               jdev.dev_label_matrix(rewards, 150),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("matplotlib_present", [True, False])
def test_dev_artifacts(tmp_path, monkeypatch, matplotlib_present):
    """The gzip pickle equals the JAX one's contents; the 2x2 figure is
    written by matplotlib, or by PIL (four panels) where it is absent."""
    if not matplotlib_present:
        monkeypatch.setitem(sys.modules, "matplotlib", None)
    rng = np.random.default_rng(0)
    eps = [(rng.random(40) > 0.9).astype(np.float32) for _ in range(6)]
    p, png = str(tmp_path / "Treechop-100.pickle"), str(tmp_path / "h.png")
    y = dev.dev(eps, size=100, out_pickle=p, out_png=png)
    assert y.shape == (7, 100)
    assert (y[0] == 0).all() and (y[4:7] <= 0).all()
    with gzip.open(p, "rb") as fp:
        np.testing.assert_array_equal(pickle.load(fp), y)
    jp = str(tmp_path / "jax.pickle")
    jdev.dev(eps, size=100, out_pickle=jp)
    with gzip.open(jp, "rb") as fp:
        np.testing.assert_allclose(y, pickle.load(fp), atol=1e-6, rtol=0)
    img = Image.open(png)
    img.load()
    if not matplotlib_present:
        assert img.size == (2 * 320, 2 * 240)
        # four panels, each with its bars drawn
        px = np.asarray(img.convert("RGB"))
        for r in (0, 1):
            for c in (0, 1):
                panel = px[r * 240:(r + 1) * 240, c * 320:(c + 1) * 320]
                assert (panel == artifacts._CYCLE[0]).all(-1).any()


def _scalars(logdir):
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator,
    )
    acc = EventAccumulator(logdir)
    acc.Reload()
    return {tag: [(e.step, e.value) for e in acc.Scalars(tag)]
            for tag in acc.Tags()["scalars"]}


def test_tb_export_equals_jax(tmp_path):
    """The port's metrics.jsonl through both exporters: the same tags,
    steps and values; non-numeric fields skipped; the same errors."""
    pytest.importorskip("torch.utils.tensorboard")
    run = tmp_path / "run"
    m = MetricsWriter(str(run))
    for s in range(3):
        m.write("critic_loss", step=s * 100, loss=0.5 - 0.1 * s)
    m.write("eval", iou=0.42, note="text-skipped")
    m.write("eval", iou=0.45)
    m.close()
    with open(run / "metrics.jsonl", "a") as fp:
        fp.write('{"kind": "torn"')                 # a live run's tail
    got = _scalars(tb_export.export_run(str(run), str(tmp_path / "port")))
    want = _scalars(jtb.export_run(str(run), str(tmp_path / "jax")))
    assert got == want
    assert got["critic_loss/loss"] == [(0, pytest.approx(0.5)),
                                       (100, pytest.approx(0.4)),
                                       (200, pytest.approx(0.3))]
    assert [s for s, _ in got["eval/iou"]] == [0, 1]
    assert "eval/note" not in got
    tb_export.main([str(run), "--out", str(tmp_path / "cli")])
    assert _scalars(str(tmp_path / "cli")) == want
    with pytest.raises(FileNotFoundError, match="cgs_tpu run directory"):
        tb_export.export_run(str(tmp_path / "none"))
    with pytest.raises(SystemExit):
        tb_export.main([str(run), str(run), "--out", "x"])
    assert os.path.isdir(tmp_path / "port")
