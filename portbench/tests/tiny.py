"""A tiny copy of the benchmark for the CPU tests: the real files plus a
tiny configuration and tiny mixes, and a BENCHMARK.json whose cells use
them, in a temporary directory."""

import json
import shutil
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
TINY = dict(vocab_size=512, hidden_size=128, intermediate_size=352,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, sliding_window=64,
            max_position_embeddings=4096, torch_dtype="float32")
TINY_ENGINE = {"page_size": 16, "pages_per_seq": 16, "prefill_chunk": 32,
               "stream_free_pages": True}


def tiny_config(**kw):
    c = json.loads((REPO / "portbench/configs/mistral-7b.json").read_text())
    c.update(TINY, **kw)
    return c


def mixes():
    long = json.loads((REPO / "portbench/traffic/longdoc.json").read_text())
    long.update(
        clients=4, pool=16, prompt={"dist": "uniform", "min": 40, "max": 150},
        output={"dist": "uniform", "min": 4, "max": 8},
        engine=dict(TINY_ENGINE, max_batch=4, num_pages=65),
        trace_seconds=0.5)
    long["check"] = {"tokens": 30, "logit_gap_limit": 0.05}
    tr = json.loads((REPO / "portbench/traffic/train8k.json").read_text())
    tr.update(batch=2, seq=128, lm_loss_chunk=32)
    tr["check"] = {"steps": 3, "limits": {"loss_gap": 1e-3,
                                          "grad_gap": 1e-3,
                                          "change_gap": 1e-3}}
    return {"tlong": long, "ttrain": tr}


CELLS = {"mistral7b.longdoc": "tlong", "mistral7b.train8k": "ttrain"}


def make_bench(tmp: Path, config=None) -> tuple[dict, Path]:
    """A copy of portbench/ and BENCHMARK.json under ``tmp`` whose cells
    run the tiny configuration and mixes. Returns (bench, root)."""
    root = tmp / "portbench"
    shutil.copytree(REPO / "portbench", root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    (root / "configs/tiny.json").write_text(json.dumps(config
                                                       or tiny_config()))
    for name, t in mixes().items():
        (root / "traffic" / f"{name}.json").write_text(json.dumps(t))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "test",
                             "file": "portbench/configs/tiny.json",
                             "reduced": [], "why": "CPU tests"})
    for w in bench["workloads"]:
        w["config"], w["traffic"] = "tiny", CELLS[w["name"]]
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return bench, root


def run_cell(bench, root, name, *, seed=2 ** 33 + 7, seconds=2.0,
             trace=False, **kw):
    """One run of a cell on the CPU, past the look for a card: (result
    line as a dict, or None where the run may print none)."""
    from portbench.harness import cell
    from portbench.harness.common import Device

    r = cell.make_run(bench, name, seed=seed, seconds=seconds, trace=trace,
                      t_start=time.perf_counter(),
                      device=Device(torch.device("cpu")), root=root, **kw)
    line, ok = cell.execute(bench, r, root=root)
    return json.loads(line) if ok else None
