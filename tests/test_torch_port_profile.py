"""PyTorch port: `--profile` (`utils/profiling.py:Profiler` on
`torch.profiler`, `cgs_tpu/utils/profiling.py:19-48`): one Chrome trace
JSON per trace, named regions, stopped however the traced body ends."""

import json
import os

import numpy as np
import pytest
import torch

from cgs_tpu_torch import cli
from cgs_tpu_torch.core.config import parse_args
from cgs_tpu_torch.data.synthetic import synthetic_eval_set
from cgs_tpu_torch.handler import Handler
from cgs_tpu_torch.utils.profiling import Profiler
from torch_port_common import one_torch_thread  # noqa: F401 (fixture)


def _names(path):
    with open(path) as fp:
        return {e.get("name") for e in json.load(fp)["traceEvents"]}


def test_profiler_writes_one_trace_with_annotations(tmp_path):
    prof = Profiler(str(tmp_path / "tr"), device="cpu")
    with prof.annotate("before_any_trace"):    # a no-op
        torch.ones(3).sum()
    with prof.trace() as p:
        assert p is prof
        with prof.annotate("critic_chunk"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    assert os.listdir(tmp_path / "tr") == [os.path.basename(prof.path)]
    names = _names(prof.path)
    assert "critic_chunk" in names and "aten::matmul" in names
    assert "before_any_trace" not in names
    prof.stop()                                # stopping twice is fine
    assert len(os.listdir(tmp_path / "tr")) == 1


def test_profiler_off_without_a_directory(tmp_path):
    prof = Profiler(None)
    with prof.trace():
        with prof.annotate("x"):
            pass
    assert prof.path is None


def test_exception_inside_trace_still_stops_it(tmp_path):
    prof = Profiler(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="boom"):
        with prof.trace():
            with prof.annotate("masker_chunk"):
                torch.ones(2).add(1)
                raise ValueError("boom")
    assert prof._prof is None and "masker_chunk" in _names(prof.path)
    with prof.trace():       # a new trace can start after it
        pass
    assert len(os.listdir(tmp_path)) == 2


def test_eval_profile_writes_a_trace(tmp_path, monkeypatch,
                                    one_torch_thread):
    """A tiny -eval (the 5 frames of a small ./resimgs.npy) traced."""
    monkeypatch.chdir(tmp_path)
    frames, _ = synthetic_eval_set(n_frames=110, seed=2)
    np.save("resimgs.npy", frames / 255.0)
    handler = cli.main(["-eval", "-resimages", "--profile", "trace",
                        "--device", "cpu"], primary=False)
    (name,) = os.listdir(tmp_path / "trace")
    assert handler.profiler.path == os.path.join("trace", name)
    names = _names(tmp_path / "trace" / name)
    # the eval's forward ran inside the trace
    assert any(n and n.startswith("aten::conv") for n in names)
    # the Handler's profiler records CPU activity alone on the CPU
    assert Handler(parse_args(["--device", "cpu"])).profiler.device.type \
        == "cpu"
