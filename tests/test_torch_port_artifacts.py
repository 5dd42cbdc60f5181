"""PyTorch port: the training artifacts on a machine without matplotlib
(`cgs_tpu_torch/utils/artifacts.py`). Where `import matplotlib` fails,
`save_loss_plot` and `save_histogram` draw their PNGs with PIL: the same
files, one curve per series, and one note per process. A tiny `-train
-eval` through the CLI with `primary=True` then writes both phases'
`_loss.png` and both histograms. Where matplotlib is present the figures
are matplotlib's, as before.
"""

import sys

import numpy as np
import pytest
from PIL import Image

from cgs_tpu_torch import cli
from cgs_tpu_torch.utils import artifacts
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)

NOTE = "matplotlib is absent"
TINY = ["-synthetic_data", "--datasize", "1100", "--testsize", "100",
        "--cepochs", "6", "--batch-size", "32", "--dropout", "0",
        "--high-rew-thresh", "0.55", "--low-rew-thresh", "0.45",
        "--contrastive-min", "5", "--mepochs", "1",
        "--eval-video-max-frames", "2"]


@pytest.fixture
def no_matplotlib(monkeypatch):
    """`import matplotlib` fails; the note has not been printed yet."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(artifacts, "_noted_absent", [])


def _rgb(path):
    img = Image.open(path)
    img.load()
    return np.asarray(img.convert("RGB"))


def test_pil_curves_and_histogram(tmp_path, capsys, no_matplotlib):
    """Four series: four colours, the 30-frame moving average of each
    (a constant series stays one horizontal line); a histogram of ten
    bars; one note for both files."""
    rng = np.random.default_rng(0)
    series = np.stack([rng.random(200), rng.random(200), rng.random(200),
                       np.full(200, 0.5)], axis=1)
    artifacts.save_loss_plot(str(tmp_path / "a" / "_loss.png"), series,
                             ["replace", "inject", "norm", "live-critic"],
                             ymin_zero=False)
    artifacts.save_histogram(str(tmp_path / "hist.png"), rng.random(500))
    assert capsys.readouterr().out.count(NOTE) == 1
    px = _rgb(tmp_path / "a" / "_loss.png")
    assert px.shape == (480, 640, 3)
    for colour in artifacts._CYCLE[:4]:
        assert (px == colour).all(-1).sum() > 20
    hist = _rgb(tmp_path / "hist.png")
    bars = (hist == artifacts._CYCLE[0]).all(-1)
    row = bars[bars.any(1)][-1]             # the bars' bottom row
    runs = np.flatnonzero(np.diff(row.astype(int)) == 1)
    assert len(runs) + int(row[0]) == 10
    # one value: the curve is the value itself
    artifacts.save_loss_plot(str(tmp_path / "one.png"), [0.25])
    assert _rgb(tmp_path / "one.png").shape == (480, 640, 3)


def test_matplotlib_figures_unchanged(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    artifacts.save_loss_plot(str(tmp_path / "l.png"), np.ones((50, 2)))
    artifacts.save_histogram(str(tmp_path / "h.png"), np.arange(10))
    assert NOTE not in capsys.readouterr().out
    for name in ("l.png", "h.png"):     # matplotlib's default figure
        assert Image.open(tmp_path / name).size == (640, 480)


def test_train_eval_without_matplotlib(tmp_path, monkeypatch, capsys,
                                       no_matplotlib, one_torch_thread):
    """`-train -eval` with primary=True (as a user runs it) on a machine
    without matplotlib: the critic's and the masker's `_loss.png` and
    the two contrastive histograms, valid PNGs, and one note."""
    monkeypatch.chdir(tmp_path)
    handler = cli.main(["--device", "cpu", "-train", "-eval", "--model",
                        "pil"] + TINY)
    assert len(handler.last_ious) == 1
    run = tmp_path / "pil"
    for art in ("critic/_loss.png", "segment/_loss.png",
                "pred_idx1_hist.png", "GT_idx1_hist.png"):
        assert _rgb(run / art).shape == (480, 640, 3), art
    assert capsys.readouterr().out.count(NOTE) == 1
