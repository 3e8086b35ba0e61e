"""One run of one cell: find its files by the names in ``BENCHMARK.json``,
run it, reduce the records to its metrics and print the result line.

A cell names a configuration (``configs/<config>.json``, whose
``family`` names ``families/<family>.py``, the program, and
``reference/<family>.py``, the plain reference) and a traffic mix
(``traffic/<mix>.json``, whose ``kind`` picks the serving or training
runner). Each metric is read by ``metrics/<name>.py`` (or
``metrics/<stem>.py`` for ``<stem>.<suffix>``).
"""

from __future__ import annotations

import dataclasses
import json
import math
import types
from pathlib import Path

import torch

from portbench.harness import serve, train
from portbench.harness.common import (
    BENCH_DIR,
    Device,
    cell_metrics,
    forbidden_modules,
    load_file_module,
    log,
    metric_reader,
    result_line,
)

RUNNERS = {"serve": serve.run, "train": train.run}


@dataclasses.dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    family: types.ModuleType
    reference: types.ModuleType
    device: Device
    seed: int
    seconds: float
    trace: bool
    t_start: float
    wrap_step: object = None  # training step wrapper (fault tests)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def make_run(bench: dict, name: str, *, seed, seconds, trace, t_start,
             device, root: Path = BENCH_DIR, **kw) -> Run:
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"]
                     if c["name"] == cell["config"])
    config = load_json(root.parent / cfg_entry["file"])
    traffic = load_json(root / "traffic" / f"{cell['traffic']}.json")
    fam = config["family"]
    return Run(cell, config, traffic,
               load_file_module(root / "families" / f"{fam}.py"),
               load_file_module(root / "reference" / f"{fam}.py"),
               device, seed, seconds, trace, t_start, **kw)


def reduce(bench: dict, r: Run, rec: dict, root: Path = BENCH_DIR) -> dict:
    """{metric: {"value", "unit"}} of the cell: end-to-end metrics in an
    untraced run, per-layer ones in a traced run; readers that find
    nothing to read are left out."""
    ctx = types.SimpleNamespace(kind=r.traffic["kind"], config=r.config,
                                traffic=r.traffic, **rec)
    kind = "per_layer" if r.trace else "end_to_end"
    out = {}
    for m in cell_metrics(bench, r.cell["name"], kind):
        if m["name"] == "setup_s":
            value = rec["setup_s"]
        else:
            value = metric_reader(m["name"], root).read(ctx)
        if value is None:
            log(f"metric {m['name']}: nothing to read in this run")
            continue
        out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def execute(bench: dict, r: Run, root: Path = BENCH_DIR):
    """Run the cell; returns (result line, ok). ``ok`` is False where the
    run may not print a result (a forbidden module was loaded)."""
    rec = RUNNERS[r.traffic["kind"]](r)
    metrics = reduce(bench, r, rec, root)
    device = r.device.info()
    device["memory_peak_bytes"] = int(rec["peak"])
    breakdown = None
    if r.trace:
        tr = rec["trace"]
        device["busy_s"] = tr.busy_s if tr is not None else 0.0
        device["window_s"] = tr.window_s if tr is not None else 0.0
        breakdown = tr.breakdown() if tr is not None else None
    checks = rec["checks"]
    correct = rec["failed"] == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    for name, c in checks.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return None, False
    return result_line(correct, rec["attempted"], rec["failed"], metrics,
                       device, checks, breakdown), True


def require_cuda(chips: int):
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark measures the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} devices, "
                         f"{torch.cuda.device_count()} present")
