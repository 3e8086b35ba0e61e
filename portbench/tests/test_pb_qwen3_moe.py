"""The Qwen3-MoE cell on the CPU: its readers' counts against a hand
count, their silence where there is nothing to read, and a whole run of
the cell at a tiny size through the family and the reference."""

import json
import types

import pytest

from portbench.harness import common
from portbench.harness.common import PEAK_BYTES, PEAK_FLOPS
from portbench.tests.tiny import REPO, make_bench, mixes, run_cell

QWEN = json.loads((REPO / "portbench/configs/qwen3-30b-a3b.json")
                  .read_text())
TINY_QWEN = dict(QWEN, vocab_size=256, hidden_size=64, intermediate_size=96,
                 moe_intermediate_size=48, num_hidden_layers=2,
                 num_attention_heads=4, num_key_value_heads=2, head_dim=32,
                 num_experts=8, num_experts_per_tok=2,
                 max_position_embeddings=4096, torch_dtype="float32")


def reader(name):
    return common.metric_reader(name)


def ctx(config, **kw):
    base = dict(kind="serve", config=config, traffic={}, spans=[],
                trace=None, profiled=None)
    base.update(kw)
    return types.SimpleNamespace(**base)


def test_active_parameters_of_the_published_config():
    n = reader("mfu_moe.turns").active_params(QWEN)
    per_layer = 18_874_368 + 262_144 + 8 * 4_718_592
    assert n == 48 * per_layer + 151936 * 2048
    assert n == pytest.approx(3.04e9, rel=0.01)


def test_moe_bound_is_the_hand_count():
    c = dict(QWEN, num_hidden_layers=2)
    for T in (1, 32, 16384):
        hit = 128 * (1 - (1 - 8 / 128) ** T)
        slots = 8 * T
        n_bytes = 2 * (hit * 3 * 2048 * 768
                       + slots * (2048 + 1536 + 768 + 2048))
        flops = 2 * 3 * 2048 * 768 * slots
        want = 2 * max(n_bytes / PEAK_BYTES, flops / PEAK_FLOPS)
        assert reader("moe_roofline.turns").bound_s(T, c) == \
            pytest.approx(want, rel=1e-12)
    assert reader("moe_roofline.turns").bound_s(0, c) == 0.0


def test_moe_readers_count_their_calls_and_kernels():
    spans = [("decode_step", 1.0, 1.1, {"lengths": [5, -1, 2, 0]}),
             ("chunk_prefill_step", 1.2, 1.3,
              {"pos0": [0, 512], "chunk_lens": [100, 0]}),
             ("decode_step", 1.4, 1.5, {"lengths": [7, 1, -1, 3]}),
             ("decode_step", 0.1, 0.2, {"lengths": [7]})]  # not profiled
    grouped = "void cutlass::device_kernel<GemmUniversal<GroupProblemShape>>"
    prep = "void at::cuda::detail::prepare_grouped_gemm_data<bf16>"
    ev = []
    for call, attn in enumerate(("paged_decode_mma_kernel", "paged_chunk_k",
                                 "paged_decode_mma_kernel")):
        for layer in range(2):  # TINY_QWEN's layers: K5/K6, then 2 products
            t = 100.0 * (6 * call + 3 * layer)
            ev += [(attn, t, 1.0), ("nvjet_tst_64x8", t + 1, 2.0),
                   (prep, t + 3, 0.5), (grouped, t + 4, 10.0),
                   (prep, t + 15, 0.5), (grouped, t + 16, 5.0)]
    tr = common.Trace(ev, [], 0.0, 1e6)
    cx = ctx(TINY_QWEN, spans=spans, trace=tr, profiled=(1.0, 2.0))
    roof = reader("moe_roofline.turns")
    assert roof.decode_tokens(cx) == [3, 3]
    # two decode calls x 2 layers x (two products + two preparations)
    assert roof.decode_kernels(tr) == (pytest.approx(4 * 16e-6), 8)
    want = 2 * roof.bound_s(3, TINY_QWEN) / (4 * 16e-6)
    assert roof.read(cx) == pytest.approx(100 * want)
    # a trace that lost one decode product: the bound follows the launches
    lost = common.Trace([e for i, e in enumerate(ev) if i != 3], [], 0.0,
                        1e6)
    assert roof.read(ctx(TINY_QWEN, spans=spans, trace=lost,
                         profiled=(1.0, 2.0))) == pytest.approx(
        100 * 2 * roof.bound_s(3, TINY_QWEN) * 7 / 8 / (4 * 16e-6 - 10e-6))
    mfu = reader("mfu_moe.turns")
    pairs = (6 + 3 + 1) + sum(range(1, 101)) + (8 + 2 + 4)
    flops = 2 * mfu.active_params(TINY_QWEN) * 106 \
        + 4 * 32 * 4 * 2 * pairs
    assert mfu.read(cx) == pytest.approx(100 * flops / (1.0 * PEAK_FLOPS))


def test_moe_readers_are_silent_without_their_inputs():
    dense = json.loads((REPO / "portbench/configs/mistral-7b.json")
                       .read_text())
    tr = common.Trace([("gemm", 0.0, 1.0)], [], 0.0, 1e6)
    for name in ("moe_roofline.turns", "mfu_moe.turns"):
        assert reader(name).read(ctx(QWEN)) is None  # untraced
        assert reader(name).read(ctx(dense, trace=tr)) is None
    # traced, but no expert kernel ran and no call was profiled
    assert reader("moe_roofline.turns").read(ctx(QWEN, trace=tr)) is None
    assert reader("mfu_moe.turns").read(ctx(QWEN, trace=tr)) is None


def tiny_qwen_bench(tmp_path):
    bench, root = make_bench(tmp_path)
    (root / "configs/tiny_qwen.json").write_text(json.dumps(TINY_QWEN))
    mix = mixes()["tlong"]
    (root / "traffic/tturns.json").write_text(json.dumps(mix))
    bench["configs"].append({"name": "tiny_qwen", "source": "test",
                             "file": "portbench/configs/tiny_qwen.json",
                             "reduced": [], "why": "CPU tests"})
    cell = next(w for w in bench["workloads"]
                if w["name"] == "qwen3-30b-a3b.turns")
    cell["config"], cell["traffic"] = "tiny_qwen", "tturns"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, root


def test_tiny_qwen_cell_runs_and_is_correct(tmp_path):
    bench, root = tiny_qwen_bench(tmp_path)
    out = run_cell(bench, root, "qwen3-30b-a3b.turns")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert set(out["metrics"]) == {"setup_s", "itl_p95_ms",
                                   "output_tokens_per_s"}
    assert out["checks"]["logit_gap"]["value"] < 1e-3
    traced = run_cell(bench, root, "qwen3-30b-a3b.turns", trace=True)
    # On the CPU no expert kernel runs: the roofline is silent.
    assert set(traced["metrics"]) == {"mfu_moe.turns"}
