"""PyTorch port: video-file `-process` (`eval/segment.py:load_video`,
`segment_video`, `utils/video.py:vidwrite`), the curve-video
visualisers (`eval/visualize.py`, `Handler.visualize`) and
`data/collect.py:clean_data`, against the JAX package's.

Decoded videos and PNG-free outputs are compared exactly: frames, file
names, frame counts and the arrays of `make_plotbar` / `clean_data`.
"""

import os

import cv2
import numpy as np
import pytest

from cgs_tpu.core.config import parse_args as jax_parse_args
from cgs_tpu.data.collect import clean_data as jax_clean_data
from cgs_tpu.eval import segment as jax_segment
from cgs_tpu.eval import visualize as jax_visualize
from cgs_tpu.pipeline import MaskPipeline as JPipeline
from cgs_tpu_torch import cli
from cgs_tpu_torch.core.config import parse_args
from cgs_tpu_torch.data.collect import clean_data
from cgs_tpu_torch.data.synthetic import synthetic_dataset
from cgs_tpu_torch.eval import segment, visualize
from cgs_tpu_torch.handler import Handler
from cgs_tpu_torch.pipeline import MaskPipeline
from cgs_tpu_torch.utils.video import vidwrite
from torch_port_common import (  # noqa: F401 (one_torch_thread: fixture)
    jax_models, one_torch_thread, port_models, port_params,
)


def _count_frames(path) -> int:
    cap = cv2.VideoCapture(str(path))
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    return n


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """A 9-frame 80x96 mp4 (so load_video resizes), written by cv2."""
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (9, 80, 96, 3), dtype=np.uint8)
    path = tmp_path_factory.mktemp("clip") / "walk.mp4"
    vidwrite(str(path), frames, framerate=12)
    return path


@pytest.fixture(scope="module")
def both():
    jc, jm, jp = jax_models()
    pc, pm = port_models()
    return (JPipeline(jc, jm, jp, batch_size=8, wire="u8",
                      hard_threshold=0.5),
            MaskPipeline(pc, pm, port_params(jp), batch_size=8,
                         wire="u8", hard_threshold=0.5, device="cpu"))


def test_load_video_equals_jax(clip):
    x, fps = segment.load_video(str(clip))
    jx, jfps = jax_segment.load_video(str(clip))
    assert x.shape == (9, 64, 64, 3) and fps == jfps == 12.0
    np.testing.assert_array_equal(x, jx)
    with pytest.raises(RuntimeError, match="no decodable frames"):
        segment.load_video(str(clip.parent / "missing.mp4"))


@pytest.mark.parametrize("concatenated", [False, True])
def test_segment_video_names_and_frames_equal_jax(clip, both, tmp_path,
                                                  concatenated,
                                                  one_torch_thread):
    jpipe, pipe = both
    argv = ["-process", "--source-imgs", str(clip)] + (
        ["-concatenated"] if concatenated else [])
    cfg, jcfg = parse_args(argv), jax_parse_args(argv)
    ours = segment.segment_video(cfg, pipe, str(clip),
                                 out_dir=str(tmp_path / "ours"))
    theirs = jax_segment.segment_video(jcfg, jpipe, str(clip),
                                       out_dir=str(tmp_path / "theirs"))
    assert ours["stems"] == theirs["stems"] == ["walk"]
    assert ours["fps"] == theirs["fps"]
    names = sorted(os.listdir(tmp_path / "ours"))
    assert names == sorted(os.listdir(tmp_path / "theirs"))
    assert names == (["walk_with_mask.mp4"] if concatenated else
                     ["walk-raw-mask.mp4", "walk-thresholded-mask.mp4"])
    for name in names:
        n = _count_frames(tmp_path / "ours" / name)
        assert n == _count_frames(tmp_path / "theirs" / name) == 9
    # write=False runs the pipeline and writes nothing
    out = segment.segment_video(cfg, pipe, str(clip),
                                out_dir=str(tmp_path / "none"), write=False)
    assert len(out["variants"]) == 2 and not (tmp_path / "none").exists()


def test_handler_routes_a_video_file(clip, tmp_path, monkeypatch,
                                     one_torch_thread):
    monkeypatch.chdir(tmp_path)
    handler = cli.main(["-process", "--source-imgs", str(clip),
                        "--mask-output-imgs", "out", "--device", "cpu"])
    assert handler.device.type == "cpu"
    assert sorted(os.listdir("out")) == ["walk-raw-mask.mp4",
                                         "walk-thresholded-mask.mp4"]


def test_make_plotbar_equals_jax():
    rng = np.random.default_rng(1)
    for values in (rng.random(50), np.zeros(7), np.arange(12.0) - 3):
        np.testing.assert_array_equal(
            visualize.make_plotbar(32, 64, values),
            jax_visualize.make_plotbar(32, 64, values))


def test_render_curves_video_frame_counts(tmp_path):
    rng = np.random.default_rng(2)
    frames = rng.random((2, 6, 64, 64, 3))
    values = rng.random((2, 6))
    sorting = np.argsort(values[1])[::-1]
    for mod, name in ((visualize, "ours"), (jax_visualize, "theirs")):
        mod.render_curves_video(str(tmp_path / f"{name}.mp4"), frames,
                                values, sorting=sorting, max_frames=5)
    assert _count_frames(tmp_path / "ours.mp4") == 5
    assert _count_frames(tmp_path / "theirs.mp4") == 5


def test_visualize_writes_jax_videos(both, tmp_path, one_torch_thread):
    jc, jm, jp = jax_models()
    pc, pm = port_models()
    x = np.random.default_rng(3).integers(0, 256, (5, 64, 64, 3),
                                          dtype=np.uint8)
    y = np.random.default_rng(4).random((7, 5)).astype(np.float32)
    argv = ["-vismasker", "--visname", "cv", "--sortidx", "1"]
    cfg, jcfg = parse_args(argv), jax_parse_args(argv)
    ours = visualize.visualize(
        cfg, MaskPipeline(pc, pm, port_params(jp), batch_size=8,
                          device="cpu"), x, y[1], str(tmp_path / "ours"),
        y_matrix=y)
    theirs = jax_visualize.visualize(
        jcfg, JPipeline(jc, jm, jp, batch_size=8), x, y[1],
        str(tmp_path / "theirs"), y_matrix=y)
    assert [os.path.basename(p) for p in ours] == \
        [os.path.basename(p) for p in theirs] == \
        ["cv.mp4", "cv-pred-sorted.mp4", "cv-GT-sorted.mp4"]
    for a, b in zip(ours, theirs):
        assert _count_frames(a) == _count_frames(b) == 5

    class NoModel:
        def run(self, x):
            raise AssertionError("--purevis must not run the model")

    pure = parse_args(argv + ["--purevis", "0,2"])
    paths = visualize.visualize(pure, NoModel(), x, y[1],
                                str(tmp_path / "pure"), y_matrix=y,
                                write=False)
    assert len(paths) == 3 and not (tmp_path / "pure").exists()


def _episodes(cfg):
    """The synthetic fixture with a few clean reward chops."""
    return synthetic_dataset(cfg.datasize + cfg.testsize, seed=0)


def test_clean_data_equals_jax(tmp_path, monkeypatch):
    argv = ["-synthetic_data", "--datasize", "2400", "--testsize", "0"]
    cfg, jcfg = parse_args(argv), jax_parse_args(argv)
    x, y, i = _episodes(cfg)
    for name in ("ours", "theirs"):
        (tmp_path / name).mkdir()
    monkeypatch.chdir(tmp_path / "ours")
    ours = clean_data(cfg, x=x, y=y, i=i)
    monkeypatch.chdir(tmp_path / "theirs")
    theirs = jax_clean_data(jcfg, x=x, y=y, i=i)
    assert len(ours[0]) > 0 and len(ours[0]) % 100 == 0
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)
    rel = "train/data/straight/synthetic-2400-clean.pickle"
    assert (tmp_path / "ours" / rel).exists()
    assert (tmp_path / "theirs" / rel).exists()
    # the port reads the JAX cache, and write=False writes none
    again = clean_data(cfg)
    for a, b in zip(again, theirs):
        np.testing.assert_array_equal(a, b)
    monkeypatch.chdir(tmp_path)
    clean_data(cfg, x=x, y=y, i=i, write=False)
    assert not (tmp_path / "train").exists()


def test_handler_trainasvis_cleaned(tmp_path, monkeypatch, one_torch_thread):
    monkeypatch.chdir(tmp_path)
    argv = ["-synthetic_data", "--datasize", "2400", "--testsize", "0",
            "--trainasvis", "7", "-cleaned", "--visname", "tv",
            "--device", "cpu", "--model", "vis"]
    handler = Handler(parse_args(argv), primary=False)
    paths = handler.visualize()
    assert [os.path.basename(p) for p in paths] == \
        ["tv.mp4", "tv-pred-sorted.mp4", "tv-GT-sorted.mp4"]
    assert not os.listdir(tmp_path)     # primary=False writes no file
    handler = cli.main(argv)
    assert all(_count_frames(tmp_path / "vis" / f"tv{s}.mp4") == 7
               for s in ("", "-pred-sorted", "-GT-sorted"))
    assert (tmp_path / "train/data/straight/synthetic-2400-clean.pickle"
            ).exists()
