"""Each metric reader's operation and byte count against a hand count at
a small shape (visible pairs of the band counted one by one), and the
readers' silence where they find nothing to read."""

import types

import pytest
import torch

from portbench.harness import common
from portbench.harness.common import PEAK_BYTES, PEAK_FLOPS, Trace
from portbench.tests.tiny import tiny_config

C = dict(tiny_config(), torch_dtype="bfloat16", sliding_window=4)
H, HKV, D, LAYERS = 4, 2, 32, 2


def visible(q, window):
    return [j for j in range(q + 1) if window is None or q - j <= window]


def reader(name):
    return common.metric_reader(name)


def trace_of(events, window_us=1e6):
    return Trace(events, [], 0.0, window_us)


def ctx(**kw):
    base = dict(kind="serve", config=C, traffic={}, spans=[], trace=None,
                profiled=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_k5_bound_is_the_hand_count():
    lengths = [5, -1, 2, 0]
    n_bytes = flops = 0
    for L in lengths:
        if L < 0:
            continue
        keys = len(visible(L, 4))
        n_bytes += 2 * (2 * keys * HKV * D + 2 * H * D + 2 * HKV * D)
        flops += 4 * D * keys * H
    want = LAYERS * max(n_bytes / PEAK_BYTES, flops / PEAK_FLOPS)
    assert reader("k5_roofline.longdoc").bound_s(lengths, C) == \
        pytest.approx(want, rel=1e-12)


def test_k5_and_k6_take_their_own_merges():
    ev = [("paged_decode_mma_kernel<1>", 0.0, 10.0),
          ("paged_merge_kernel", 10.0, 2.0),
          ("paged_chunk_wgmma_kernel", 20.0, 30.0),
          ("paged_merge_kernel", 50.0, 3.0), ("gemm", 60.0, 5.0)]
    tr = trace_of(ev)
    assert reader("k5_roofline.longdoc").device_s(tr, "paged_decode") == \
        pytest.approx(12e-6)
    assert reader("k6_roofline.longdoc").device_s(tr, "paged_chunk") == \
        pytest.approx(33e-6)


def test_k6_bound_is_the_hand_count():
    pos0, lens = [0, 6, 3], [3, 4, 0]
    n_bytes = flops = 0
    for p, c in zip(pos0, lens):
        if c == 0:
            continue
        keys = set()
        for i in range(c):
            vis = visible(p + i, 4)
            keys |= set(vis)
            flops += 4 * D * len(vis) * H
        n_bytes += 2 * (2 * len(keys) * HKV * D + 2 * c * H * D)
    want = LAYERS * max(n_bytes / PEAK_BYTES, flops / PEAK_FLOPS)
    assert reader("k6_roofline.longdoc").bound_s(pos0, lens, C) == \
        pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("window", [None, 4, 100])
def test_k1_k2_bounds_are_the_hand_count(window):
    c = dict(C, sliding_window=window)
    t = {"batch": 3, "seq": 10}
    pairs = sum(len(visible(i, window)) for i in range(10))
    q, kv, lse = 3 * 10 * H * D, 3 * 10 * HKV * D, 3 * H * 10
    k1 = max((2 * (2 * q + 2 * kv) + 4 * lse) / PEAK_BYTES,
             4 * D * pairs * H * 3 / PEAK_FLOPS)
    k2 = max((2 * (4 * q + 4 * kv) + 4 * lse) / PEAK_BYTES,
             10 * D * pairs * H * 3 / PEAK_FLOPS)
    assert reader("k1_roofline.train").launch_bound_s(c, t) == \
        pytest.approx(k1, rel=1e-12)
    assert reader("k2_roofline.train").launch_bound_s(c, t) == \
        pytest.approx(k2, rel=1e-12)


def test_mfu_counts_the_models_parameters():
    from flash_attn_tpu_torch.models.llama import LlamaForCausalLM
    from portbench.families import llama

    cfg = llama.port_config(C, train=True)
    model = LlamaForCausalLM(cfg, generator=torch.Generator(),
                             device="cpu")
    n = sum(p.numel() for name, p in model.named_parameters()
            if name != "wte.weight")
    assert reader("mfu.longdoc").non_embedding_params(C) == n


def test_mfu_serve_and_train_flops():
    mfu = reader("mfu.longdoc")
    n = mfu.non_embedding_params(C)
    spans = [("decode_step", 1.0, 2.0, {"lengths": [5, -1]}),
             ("chunk_prefill_step", 2.0, 3.0,
              {"pos0": [6], "chunk_lens": [2], "rows": 1, "width": 4})]
    pairs = len(visible(5, 4)) + len(visible(6, 4)) + len(visible(7, 4))
    want = 2 * n * 3 + 4 * D * pairs * H * LAYERS
    c = ctx(spans=spans, profiled=(0.0, 10.0), trace=trace_of(
        [("gemm", 0.0, 1.0)], window_us=2e6))
    assert mfu.serve_flops(c) == want
    assert mfu.read(c) == pytest.approx(100 * want / (2.0 * PEAK_FLOPS))
    t = {"batch": 2, "seq": 10}
    tpairs = sum(len(visible(i, 4)) for i in range(10)) * 2
    c = ctx(kind="train", traffic=t, spans=[("train.step", 1.0, 2.0, {})],
            profiled=(0.0, 10.0))
    assert mfu.train_flops(c) == 6 * n * 20 + 14 * D * tpairs * H * LAYERS


def test_span_metrics():
    spans = [("engine.step", 0.0, 1.0, {}), ("decode_step", 0.2, 0.5, {}),
             ("chunk_prefill_step", 0.6, 0.8,
              {"rows": 2, "width": 8, "chunk_lens": [8, 3], "pos0": [0, 0]}),
             ("engine.step", 1.0, 1.5, {}), ("decode_step", 1.1, 1.4, {})]
    c = ctx(spans=spans)
    assert reader("engine_host_ms.longdoc").read(c) == pytest.approx(
        ((1.0 - 0.5) + (0.5 - 0.3)) / 2 * 1e3)
    assert reader("decode_step_ms.longdoc").read(c) == pytest.approx(300.0)
    assert reader("chunk_prefill_ms.longdoc").read(c) == pytest.approx(200.)
    assert reader("prefill_pad_share.longdoc").read(c) == pytest.approx(
        100 * 5 / 16)


def test_readers_with_nothing_to_read_return_none():
    c = ctx()
    for name in ("k5_roofline.longdoc", "k6_roofline.longdoc", "mfu.longdoc",
                 "idle_share.longdoc", "decode_step_ms.longdoc",
                 "chunk_prefill_ms.longdoc", "prefill_pad_share.longdoc"):
        assert reader(name).read(c) is None, name
    c = ctx(kind="train", traffic={"batch": 1, "seq": 8})
    for name in ("k1_roofline.train", "k2_roofline.train", "mfu.train",
                 "idle_share.train"):
        assert reader(name).read(c) is None, name
