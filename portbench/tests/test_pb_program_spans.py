"""The readers of the program's own spans (``harness/program_spans.py``):
hand-built traces against hand counts, silence where there is nothing to
read, and a tiny traced cell on the CPU, whose untraced run leaves the
port's spans off."""

import json
import types

import pytest

from portbench.harness import common
from portbench.harness.common import Trace
from portbench.tests.tiny import make_bench, run_cell

NEW = ("chunk_issue_ms.longdoc", "decode_issue_ms.longdoc",
       "host_syncs_per_step.longdoc")

# Two engine steps (us): an admission of one chunk, then a decode step,
# each inside the harness's own spans; the first step's model calls lie
# inside the harness's call spans, which synchronize after them.
HOST = [
    ("engine.step", 0.0, 1000.0),
    ("serve.step", 10.0, 980.0),
    ("serve.to_device", 20.0, 30.0),  # the admission's page table
    ("serve.chunk", 60.0, 700.0),
    ("serve.to_device", 70.0, 10.0),
    ("serve.to_device", 80.0, 10.0),
    ("chunk_prefill_step", 100.0, 500.0),
    ("llama.chunk_prefill_step", 100.0, 300.0),
    ("serve.readback", 620.0, 40.0),
    ("serve.to_device", 800.0, 20.0),
    ("decode_step", 830.0, 140.0),
    ("llama.decode_step", 830.0, 60.0),
    ("serve.readback", 975.0, 10.0),
    ("engine.step", 1000.0, 500.0),
    ("serve.step", 1010.0, 480.0),
    ("serve.to_device", 1020.0, 5.0),
    ("llama.decode_step", 1100.0, 100.0),
    ("serve.readback", 1300.0, 20.0),
]


def reader(name):
    return common.metric_reader(name)


def ctx(host=HOST, kind="serve", trace=True):
    tr = Trace([("gemm", 0.0, 1.0)], list(host), 0.0, 2000.0) if trace \
        else None
    return types.SimpleNamespace(kind=kind, config={}, traffic={}, spans=[],
                                 trace=tr, profiled=None)


@pytest.mark.parametrize("name, want", [
    ("chunk_issue_ms.longdoc", 300.0 / 1e3),
    ("decode_issue_ms.longdoc", (60.0 + 100.0) / 2 / 1e3),
    ("host_syncs_per_step.longdoc", (6 + 2) / 2),
])
def test_reader_is_the_hand_count(name, want):
    assert reader(name).read(ctx()) == pytest.approx(want, rel=1e-12)


HARNESS_ONLY = [h for h in HOST if not h[0].startswith(("serve.", "llama."))]


@pytest.mark.parametrize("name", NEW)
@pytest.mark.parametrize("case", ["no trace", "train", "no program span"])
def test_reader_with_nothing_to_read_returns_none(name, case):
    c = {"no trace": ctx(trace=False), "train": ctx(kind="train"),
         "no program span": ctx(host=HARNESS_ONLY)}[case]
    assert reader(name).read(c) is None


@pytest.mark.parametrize("trace", [False, True])
def test_only_the_traced_run_turns_the_spans_on(tmp_path, monkeypatch,
                                                trace):
    """The port's spans turn on only under the traced run's profiler, and
    its line then holds the readers' metrics."""
    from flash_attn_tpu_torch import tracing

    live = {"n": 0}
    real = tracing.span

    def span(name):
        sp = real(name)
        live["n"] += sp is not tracing._OFF
        return sp

    monkeypatch.setattr(tracing, "span", span)
    bench, root = make_bench(tmp_path)
    mix = root / "traffic/tlong.json"  # a profiled sub-window of 3 s of 4
    mix.write_text(json.dumps(dict(json.loads(mix.read_text()),
                                   trace_seconds=3.0)))
    out = run_cell(bench, root, "mistral7b.longdoc", seconds=4.0,
                   trace=trace)
    assert out["correct"]
    if not trace:
        assert live["n"] == 0
        return
    assert live["n"] > 0
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(NEW) <= set(m)
    assert m["host_syncs_per_step.longdoc"] >= 4  # 3 copies, 1 read a step
    assert all(m[k] > 0 for k in NEW)
