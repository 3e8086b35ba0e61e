"""The port's host spans (``flash_attn_tpu_torch.tracing``): free when no
profiler runs, and under ``torch.profiler`` ranges of their names that nest
as the engine's phases do, one per call of what they wrap, with the same
tokens as without."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from flash_attn_tpu_torch import tracing
from flash_attn_tpu_torch.models import llama_decode
from flash_attn_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from flash_attn_tpu_torch.serving.engine import ServingEngine

NAMES = ("serve.step", "serve.chunk", "serve.to_device", "serve.readback",
         "llama.chunk_prefill_step", "llama.decode_step")
PROMPT_LENS = (9, 40, 23)


@pytest.fixture(scope="module")
def model():
    cfg = LlamaConfig.tiny()
    gen = torch.Generator().manual_seed(0)
    return cfg, LlamaForCausalLM(cfg, generator=gen, device="cpu")


def serve(model):
    """Three prompts on a tiny engine in 16-token chunks (rows padded to
    4, the 40-token prompt in three chunks); the greedy tokens."""
    cfg, m = model
    eng = ServingEngine(m, cfg, model_fns=llama_decode, max_batch=4,
                        num_pages=32, page_size=16, pages_per_seq=4,
                        prefill_chunk=16)
    rng = np.random.default_rng(3)
    for n in PROMPT_LENS:
        eng.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                   max_new_tokens=4)
    done = eng.run(max_steps=50)
    assert len(done) == len(PROMPT_LENS)
    return {r.seq_id: r.generated for r in done}


def profiled(model, tmp_path):
    """``serve`` under the CPU profiler: its tokens, and the exported
    trace's program spans as (name, start us, end us)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tokens = serve(model)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] in NAMES]
    return tokens, spans


@pytest.mark.parametrize("name", ["serve.step", "serve.chunk",
                                  "llama.decode_step"])
def test_off_span_is_one_shared_object_and_records_nothing(name,
                                                           monkeypatch):
    """With no profiler, every span is the same no-op, which never opens a
    profiler range."""
    def refuse(*a, **k):
        raise AssertionError("an off span opened a profiler range")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    first = tracing.span(name)
    for _ in range(3):
        with tracing.span(name) as sp:
            assert sp is first is tracing._OFF


def test_spans_nest_by_time(model, tmp_path):
    """Each span lies inside the one its caller opened around it:
    ``llama.chunk_prefill_step`` in ``serve.chunk`` in ``serve.step``,
    ``llama.decode_step`` in ``serve.step`` outside any chunk, and every
    copy and read-back in a step."""
    _, spans = profiled(model, tmp_path)
    assert {s[0] for s in spans} == set(NAMES)
    for name, t0, t1 in spans:
        assert t0 <= t1, name

    def chain(s):
        """The names of the spans around ``s``, innermost first."""
        outer = [o for o in spans if o is not s and o[1] <= s[1]
                 and s[2] <= o[2] and (o[1], o[2]) != (s[1], s[2])]
        return tuple(o[0] for o in sorted(outer, key=lambda o: o[2] - o[1]))

    chains = {(s[0],) + chain(s) for s in spans}
    assert chains == {
        ("serve.step",),
        ("serve.chunk", "serve.step"),
        ("llama.chunk_prefill_step", "serve.chunk", "serve.step"),
        ("llama.decode_step", "serve.step"),
        ("serve.to_device", "serve.step"),
        ("serve.to_device", "serve.chunk", "serve.step"),
        ("serve.readback", "serve.step"),
        ("serve.readback", "serve.chunk", "serve.step")}


def test_tokens_are_the_same_with_tracing_on_and_off(model, tmp_path):
    off = serve(model)
    on, spans = profiled(model, tmp_path)
    assert spans
    assert on == off


@pytest.mark.parametrize("name, owner, method", [
    ("serve.step", ServingEngine, "step"),
    ("serve.to_device", ServingEngine, "_to_device"),
    ("serve.readback", ServingEngine, "_sample"),
    ("serve.chunk", llama_decode, "chunk_prefill_step"),
    ("llama.chunk_prefill_step", llama_decode, "chunk_prefill_step"),
    ("llama.decode_step", llama_decode, "decode_step")])
def test_span_counts_are_the_engines_calls(model, tmp_path, monkeypatch,
                                           name, owner, method):
    """One span per call: each ``_to_device`` is one copy, each
    ``_sample`` one read-back, each model chunk call one chunk."""
    calls = {"n": 0}
    real = getattr(owner, method)

    def counted(*a):
        calls["n"] += 1
        return real(*a)

    monkeypatch.setattr(owner, method, counted)
    _, spans = profiled(model, tmp_path)
    assert calls["n"] > 0
    assert sum(1 for s in spans if s[0] == name) == calls["n"]


def test_spans_are_profiler_ranges(model, tmp_path):
    """Under a running profiler every span is a ``user_annotation`` event
    of its name in the exported trace; after it, spans are off again."""
    _, spans = profiled(model, tmp_path)
    assert {s[0] for s in spans} == set(NAMES)
    assert tracing.span("serve.step") is tracing._OFF
