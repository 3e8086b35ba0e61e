"""The reader of ``graph_replay_share`` (``metrics/graph_replay_share.py``)
on hand-built traces: the share of the Llama serving calls that hold a
``llama.graph_replay`` span, silence where the program replays nothing,
and no count for a replay whose call began before the sub-window."""

import types

import pytest

from portbench.harness import common
from portbench.harness.common import Trace

NAME = "graph_replay_share.longdoc"

# Host spans (name, start us, length us): an engine step that admits one
# chunk, then decodes; a decode step; a decode step that captured; and a
# chunk that ran eagerly (neither span inside it).
HOST = [
    ("serve.step", 0.0, 400.0),
    ("llama.chunk_prefill_step", 10.0, 100.0),
    ("llama.graph_replay", 20.0, 80.0),
    ("llama.decode_step", 200.0, 50.0),
    ("llama.graph_replay", 205.0, 40.0),
    ("serve.step", 500.0, 100.0),
    ("llama.decode_step", 510.0, 60.0),
    ("llama.graph_replay", 515.0, 50.0),
    ("serve.step", 700.0, 300.0),
    ("llama.decode_step", 710.0, 200.0),
    ("llama.graph_capture", 715.0, 180.0),
    ("llama.chunk_prefill_step", 920.0, 60.0),
]


def ctx(host, kind="serve", trace=True):
    tr = Trace([("gemm", 0.0, 1.0)], list(host), 0.0, 2000.0) if trace \
        else None
    return types.SimpleNamespace(kind=kind, config={}, traffic={}, spans=[],
                                 trace=tr, profiled=None)


def read(c):
    return common.metric_reader(NAME).read(c)


def test_share_is_the_hand_count():
    assert read(ctx(HOST)) == pytest.approx(100.0 * 3 / 5, rel=1e-12)


def test_every_call_replayed_reads_100():
    host = [h for h in HOST[:8]]
    assert read(ctx(host)) == 100.0


def test_a_replay_outside_any_counted_call_is_not_counted():
    """The sub-window keeps the spans that start in it: a replay whose
    call began before it is no call of the window's."""
    host = [("llama.graph_replay", 5.0, 10.0)] + HOST[3:5]
    assert read(ctx(host)) == 100.0
    assert read(ctx([("llama.graph_replay", 5.0, 10.0),
                     ("llama.decode_step", 30.0, 10.0)])) == 0.0


@pytest.mark.parametrize("case", ["no trace", "train", "no replay span",
                                  "no call"])
def test_nothing_to_read_returns_none(case):
    c = {"no trace": ctx(HOST, trace=False),
         "train": ctx(HOST, kind="train"),
         "no replay span": ctx([h for h in HOST
                                if h[0] != "llama.graph_replay"]),
         "no call": ctx([("serve.step", 0.0, 10.0),
                         ("llama.graph_replay", 1.0, 2.0)])}[case]
    assert read(c) is None
