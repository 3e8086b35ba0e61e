"""Whole runs of the tiny cells on the CPU, past the look for a card: a
new cell made of files and entries alone, the traced run, the import
guard, and the faults that ``correct`` has to catch."""

import json
import sys
import types

import pytest
import torch

from portbench.tests.tiny import make_bench, run_cell, tiny_config

NEW_METRIC = '''
def read(ctx):
    return len(ctx.served) if ctx.kind == "serve" else None
'''


@pytest.mark.parametrize("cell", ["mistral7b.longdoc", "mistral7b.train8k"])
def test_tiny_cells_run_and_are_correct(tmp_path, cell):
    bench, root = make_bench(tmp_path)
    out = run_cell(bench, root, cell)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    names = {m["name"] for m in bench["end_to_end"]
             if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == names
    assert list(out)[-1] == "checks"
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_a_new_cell_needs_only_files_and_entries(tmp_path):
    bench, root = make_bench(tmp_path)
    (root / "configs/other.json").write_text(json.dumps(
        tiny_config(num_hidden_layers=1, sliding_window=None)))
    mix = json.loads((root / "traffic/tlong.json").read_text())
    mix["clients"] = 2
    (root / "traffic/slow.json").write_text(json.dumps(mix))
    (root / "metrics/requests_seen.py").write_text(NEW_METRIC)
    bench["configs"].append({"name": "other", "source": "test",
                             "file": "portbench/configs/other.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "other.slow", "config": "other",
                               "traffic": "slow", "chips": 1, "why": "t"})
    bench["end_to_end"][1]["workloads"].append("other.slow")
    bench["per_layer"].append({"name": "requests_seen", "unit": "1",
                               "better": "higher",
                               "source": "program_counter", "layer": "x",
                               "moves": "ttft_p95_ms",
                               "workloads": ["other.slow"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cell(bench, root, "other.slow")
    assert out["correct"]
    assert set(out["metrics"]) == {"setup_s", "ttft_p95_ms"}
    traced = run_cell(bench, root, "other.slow", trace=True)
    assert traced["metrics"]["requests_seen"]["value"] == \
        traced["attempted"]


def test_traced_run_reports_layers_and_window(tmp_path):
    bench, root = make_bench(tmp_path)
    out = run_cell(bench, root, "mistral7b.longdoc", trace=True)
    assert {"engine_host_ms.longdoc", "decode_step_ms.longdoc",
            "chunk_prefill_ms.longdoc", "prefill_pad_share.longdoc"} <= \
        set(out["metrics"])
    assert out["device"]["window_s"] > 0.3
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_a_loaded_jax_module_withholds_the_result(tmp_path, monkeypatch):
    bench, root = make_bench(tmp_path)
    monkeypatch.setitem(sys.modules, "flash_attn_tpu",
                        types.ModuleType("flash_attn_tpu"))
    assert run_cell(bench, root, "mistral7b.longdoc", seconds=1.0) is None


# ------------------------------------------------------------- faults


def test_fault_state_unchanged_fails(tmp_path):
    bench, root = make_bench(tmp_path)

    def frozen(step):
        return lambda batch: torch.tensor(0.0)

    out = run_cell(bench, root, "mistral7b.train8k", wrap_step=frozen)
    assert not out["correct"]


def test_fault_half_batch_fails(tmp_path):
    bench, root = make_bench(tmp_path)

    def half(step):
        return lambda b: step({k: v[: v.shape[0] // 2] for k, v in
                               b.items()})

    out = run_cell(bench, root, "mistral7b.train8k", wrap_step=half)
    assert not out["correct"]


def test_fault_altered_token_fails(tmp_path, monkeypatch):
    """Every 7th decode step's logits favour a token the model did not
    choose, where the token is produced."""
    from portbench.families import llama
    bench, root = make_bench(tmp_path)
    fns = llama.model_fns
    calls = {"n": 0}

    def decode_step(*a, **kw):
        logits, caches = fns.decode_step(*a, **kw)
        calls["n"] += 1
        if calls["n"] % 7 == 0:
            logits = logits.clone()
            logits[:, 0] = logits.max() + 10.0
        return logits, caches

    monkeypatch.setattr(llama, "model_fns", types.SimpleNamespace(
        chunk_prefill_step=fns.chunk_prefill_step,
        decode_step=decode_step))
    # the runner loads families by path: patch the module it will load
    from portbench.harness import cell as cell_mod
    real = cell_mod.load_file_module

    def load(path):
        mod = real(path)
        if path.name == "llama.py" and path.parent.name == "families":
            mod.model_fns = llama.model_fns
        return mod

    monkeypatch.setattr(cell_mod, "load_file_module", load)
    out = run_cell(bench, root, "mistral7b.longdoc")
    assert not out["correct"]
    assert out["checks"]["logit_gap"]["value"] > \
        out["checks"]["logit_gap"]["limit"]


def test_the_loop_is_open_before_the_window(tmp_path):
    """Set-up runs the closed loop until each client's first request has
    finished; the window's first-token times are of its own submissions,
    and the requests in flight as it opens count for tokens and gaps."""
    import time as _time

    from portbench.harness import cell, serve
    from portbench.harness.common import Device
    from portbench.harness.traffic import Mix

    bench, root = make_bench(tmp_path)
    r = cell.make_run(bench, "mistral7b.longdoc", seed=5, seconds=1.0,
                      trace=False, t_start=_time.perf_counter(),
                      device=Device(torch.device("cpu")), root=root)
    weights, engine, fns, spans = serve.setup(r)
    mix = Mix(r.traffic, r.seed, r.config["vocab_size"])
    loop = serve.ramp(r, engine, fns, spans, mix)
    clients = r.traffic["clients"]
    assert loop.k > clients and len(loop.open) == clients
    first = {q.seq_id for q in engine.finished}
    assert len(first) == loop.k - clients  # each finished one replaced
    assert all(s.req.seq_id not in first for s in loop.open)
    rec = serve.window(r, loop, mix)
    t0, _ = rec["window"]
    assert rec["in_flight"] and all(s.submitted < t0 for s in rec["in_flight"])
    assert rec["served"] and all(s.submitted >= t0 for s in rec["served"])
    assert {id(s) for s in rec["in_flight"]}.isdisjoint(
        id(s) for s in rec["served"])
