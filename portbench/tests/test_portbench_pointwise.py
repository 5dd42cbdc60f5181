"""The reader of `pointwise_ms_per_batch.process` on hand-built trace
summaries: the bias adds, activations and pools of PyTorch's eager
chain, or the port's epilogue kernel, summed per traced batch; other
kernels and copies left out; nothing to read without them."""

import pytest

from portbench.lib import manifest as mf
from portbench.lib.trace import Summary

NAME = "pointwise_ms_per_batch.process"
LAYER = {"frames_traced": 32, "batch": 8}        # 4 batches


def _read(device):
    summary = None if device is None else Summary(
        window_s=1.0, busy_s=0.5, device=list(device))
    return mf.metric_reader(NAME).read(
        {"summary": summary, "layer": LAYER, "config": {}, "traffic": {},
         "flops": None})


OTHER = [(0.0, 4000.0, "sm90_xmma_fprop_implicit_gemm_f32f32"),
         (4000.0, 4500.0, "Memcpy HtoD (Pageable -> Device)"),
         (4500.0, 4700.0, "void upsample_cat_fwd<float>(...)")]


def test_eager_chain_kernels_summed_per_batch():
    # a bias add, a ReLU and a max-pool: 1000 + 600 + 400 us over 4
    eager = [(0.0, 1000.0, "void at::native::elementwise_kernel<128, 2>"),
             (1000.0, 1600.0,
              "void at::native::vectorized_elementwise_kernel<4>"),
             (1600.0, 2000.0,
              "void at::native::max_pool_forward_nhwc<float, float>")]
    assert _read(eager + OTHER) == pytest.approx(0.5)


def test_epilogue_kernels_summed_per_batch():
    fused = [(i * 100.0, i * 100.0 + 50.0,
              "void (anonymous namespace)::bias_act_pool_vec<float, float, 1, 2>")
             for i in range(48)]
    assert _read(fused + OTHER) == pytest.approx(48 * 0.05 / 4)


@pytest.mark.parametrize("device", [None, OTHER, []])
def test_none_when_nothing_to_read(device):
    assert _read(device) is None
