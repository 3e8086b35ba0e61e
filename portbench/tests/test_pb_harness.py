"""CPU tests of the harness's shared pieces: the traffic generator,
percentiles, the union of device intervals, the import guard and which
metrics a cell reports."""

import json
import types
from pathlib import Path

import numpy as np
import pytest

from portbench.harness import common
from portbench.harness.traffic import Mix, quantiles

REPO = Path(__file__).resolve().parents[2]
MIXES = ["longdoc"]


def mix(name, seed):
    t = json.loads((REPO / f"portbench/traffic/{name}.json").read_text())
    return t, Mix(t, seed, vocab=32000)


@pytest.mark.parametrize("name", MIXES)
def test_mix_is_deterministic_per_seed(name):
    big = 2 ** 40 + 3
    _, a = mix(name, big)
    _, b = mix(name, big)
    _, c = mix(name, big + 1)
    assert a.ids(50) == b.ids(50)
    assert a.ids(50) != c.ids(50)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_gets_the_same_schedule(name):
    t, a = mix(name, 1)
    _, b = mix(name, 2)
    draws = lambda m: [m.draw(k) for k in range(m.n)]  # noqa: E731
    assert draws(a) == draws(b)
    t2 = dict(t, schedule_seed=t["schedule_seed"] + 1)
    c = Mix(t2, 1, vocab=32000)
    assert sorted(c.prompts) == sorted(a.prompts)  # the same sizes
    assert draws(c) != draws(a)  # in another order


@pytest.mark.parametrize("name", MIXES)
def test_mix_is_drawn_at_its_distribution(name):
    t, m = mix(name, 7)
    for part, lengths in (("prompt", m.prompts), ("output", m.outputs)):
        spec = t[part]
        assert lengths.min() >= spec["min"] and lengths.max() <= spec["max"]
        if spec["dist"] == "lognormal":
            assert abs(np.median(lengths) - spec["median"]) <= \
                0.02 * spec["median"]
            inner = lengths[(lengths > spec["min"]) & (lengths < spec["max"])]
            sigma = np.std(np.log(inner))
            assert sigma == pytest.approx(spec["sigma"], rel=0.25)
        else:
            assert lengths.mean() == pytest.approx(
                (spec["min"] + spec["max"]) / 2, rel=0.02)
    ids = np.array(m.ids(20000))
    assert ids.min() >= 0 and ids.max() < 32000
    assert abs(ids.mean() - 16000) < 300


def test_quantile_clips():
    x = quantiles({"dist": "lognormal", "median": 100, "sigma": 3.0,
                   "min": 50, "max": 200}, 1000)
    assert x.min() == 50 and x.max() == 200
    u = quantiles({"dist": "uniform", "min": 3, "max": 5}, 300)
    assert sorted(set(u.tolist())) == [3, 4, 5]


@pytest.mark.parametrize("q", [0, 5, 50, 95, 99, 100])
def test_percentile_over_all_samples_matches_numpy(q):
    xs = np.random.default_rng(q).exponential(size=1001)
    assert common.percentile(xs.tolist(), q) == pytest.approx(
        np.percentile(xs, q), rel=1e-12)


def test_union_of_device_intervals():
    ev = [("a", 0.0, 10.0), ("b", 5.0, 10.0), ("c", 30.0, 5.0),
          ("d", 31.0, 1.0), ("e", 50.0, 0.0)]
    tr = common.Trace(ev, [("decode_step", 12.0, 20.0)], 0.0, 100.0)
    assert tr.union_us() == 20.0
    assert tr.busy_s == pytest.approx(20e-6)
    assert tr.idle_gaps() == [(15.0, 15.0), (35.0, 15.0), (50.0, 50.0)]
    bd = tr.breakdown()
    assert dict(bd["idle_gaps"])["decode_step"] == pytest.approx(15e-6)


def test_import_guard_compares_whole_top_level_names():
    mods = {"flash_attn_tpu_torch": 1, "flash_attn_tpu_torch.models": 1,
            "numpy": 1, "jaxtyping": 1}
    assert common.forbidden_modules(mods) == []
    for bad in ("flash_attn_tpu", "flash_attn_tpu.ops", "jax", "jax.numpy",
                "jaxlib", "flax.linen"):
        assert common.forbidden_modules({**mods, bad: 1}) == [bad]


def test_import_guard_rejects_a_stub_module(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "flash_attn_tpu",
                        types.ModuleType("flash_attn_tpu"))
    assert common.forbidden_modules() == ["flash_attn_tpu"]


def test_each_cell_reports_its_metrics():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        e2e = {m["name"] for m in common.cell_metrics(bench, w["name"],
                                                       "end_to_end")}
        layer = common.cell_metrics(bench, w["name"], "per_layer")
        assert "setup_s" in e2e and len(e2e) >= 2 and layer
        assert all(m["moves"] in e2e for m in layer)
        for m in [*layer, *bench["end_to_end"]]:
            if m["name"] != "setup_s":
                assert hasattr(common.metric_reader(m["name"]), "read")
