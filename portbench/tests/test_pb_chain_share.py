"""The reader of ``chain_share`` (``metrics/chain_share.py``) on
hand-built traces: the elementwise and copy kernels' time over the busy
time (the union of the device intervals), silence without device work."""

import types

import pytest

from portbench.harness import common
from portbench.harness.common import Trace

NAME = "chain_share.serve"

# (name, start us, length us) on one stream, with a gap at 60..100
DEVICE = [
    ("sm90_xmma_gemm_bf16bf16_bf16f32", 0.0, 30.0),
    ("void fattn::add_rmsnorm_kernel<__nv_bfloat16, __nv_bfloat16>", 30.0,
     5.0),
    ("void fattn::qk_rope_kernel<__nv_bfloat16, __nv_bfloat16>", 35.0, 5.0),
    ("void at::native::direct_copy_kernel_cuda", 40.0, 10.0),
    ("fattn_paged_decode_kernel", 50.0, 10.0),
    ("void fattn::swiglu_kernel<__nv_bfloat16>", 100.0, 20.0),
    ("Memcpy HtoD (Pageable -> Device)", 120.0, 10.0),
    ("void at::native::softmax_warp_forward", 130.0, 10.0),
]


def ctx(device, kind="serve"):
    tr = Trace(list(device), [], 0.0, 1000.0)
    return types.SimpleNamespace(kind=kind, config={}, traffic={}, spans=[],
                                 trace=tr, profiled=None)


def read(c):
    return common.metric_reader(NAME).read(c)


def test_share_is_the_hand_count():
    # chain: 5 + 5 + 10 (copy) + 20 + 10 (memcpy) = 50 of 100 busy
    # (the softmax is the loss class, the GEMM and K5 their own)
    assert read(ctx(DEVICE)) == pytest.approx(100.0 * 50 / 100, rel=1e-12)


def test_overlapping_kernels_count_busy_time_once():
    dev = [("sm90_gemm", 0.0, 10.0), ("void fattn::swiglu_kernel", 5.0,
                                      10.0)]
    assert read(ctx(dev)) == pytest.approx(100.0 * 10 / 15, rel=1e-12)


def test_no_device_work_reads_nothing():
    assert read(ctx([])) is None
    assert read(types.SimpleNamespace(trace=None)) is None
