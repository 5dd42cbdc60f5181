"""The reader of `mask_head_ms_per_batch.process` on hand-built trace
summaries: the mask head kernel's device time a traced batch, read
where the program counts its routed forwards (`model.mask_heads`), and
nothing to read on a program without that counter or kernel, as on one
that runs the head through cuDNN."""

from collections import Counter

import pytest

from portbench.lib import manifest as mf
from portbench.lib.trace import Summary

from cgs_tpu_torch.utils import profiling

NAME = "mask_head_ms_per_batch.process"
LAYER = {"batch": 8, "frames_traced": 16}             # 2 batches
HEADS = [(i * 10.0, i * 10.0 + 4.0,
          "void (anonymous namespace)::mask_head_fwd<float, 4, 8, true>")
         for i in range(2)]
OTHER = [(100.0, 900.0, "void cudnn::cnn::conv2d_grouped_direct_kernel"),
         (900.0, 950.0,
          "void (anonymous namespace)::bias_act_pool_vec<float, float, 3, 1>")]


def _read(device):
    return mf.metric_reader(NAME).read(
        {"summary": Summary(window_s=1.0, busy_s=0.5, device=list(device)),
         "layer": LAYER, "config": {}, "traffic": {}, "flops": None})


def _counted(monkeypatch, **kw):
    monkeypatch.setattr(profiling, "counts", Counter(kw))


def test_one_launch_a_forward_summed_per_batch(monkeypatch):
    # 3 forwards of 8 frames, each with its mask head: 4 us a batch
    _counted(monkeypatch, **{"model.critic_frames": 24,
                             "model.mask_heads": 3})
    assert _read(HEADS + OTHER) == pytest.approx(0.004)
    assert _read(HEADS[:1] + OTHER) is None


@pytest.mark.parametrize("kw", [{}, {"model.critic_frames": 24}])
def test_none_without_the_counter(monkeypatch, kw):
    _counted(monkeypatch, **kw)
    assert _read(HEADS + OTHER) is None


def test_none_on_a_program_without_counters(monkeypatch):
    monkeypatch.delattr(profiling, "counts")
    assert _read(HEADS) is None


def test_none_where_the_trace_holds_no_mask_head(monkeypatch):
    _counted(monkeypatch, **{"model.critic_frames": 24,
                             "model.mask_heads": 3})
    assert _read(OTHER) is None
