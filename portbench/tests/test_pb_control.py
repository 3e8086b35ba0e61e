"""The lower-precision control at a size a test run holds: the reference
computed in fp8 in the program's place must read a wider logit gap (and
training gaps) than the program does at the configuration's own
precision, bf16. At the cells' own sizes the control runs on the card
(``tools/control.py``); PERF.md gives its readings and the limits set
from them."""

import sys
import time
import types
from pathlib import Path

import torch

from portbench.tests.tiny import make_bench, tiny_config

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))


def readings(tmp_path, cell, seed):
    import control
    from portbench.harness import cell as cell_mod
    from portbench.harness import serve, train
    from portbench.harness.common import Device
    from portbench.harness.traffic import Mix

    bench, root = make_bench(tmp_path, tiny_config(torch_dtype="bfloat16"))
    r = cell_mod.make_run(bench, cell, seed=seed, seconds=2.0, trace=False,
                          t_start=time.perf_counter(),
                          device=Device(torch.device("cpu")), root=root)
    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        empty_cache=lambda: None))
    if r.traffic["kind"] == "serve":
        return control.serve_seed(r, serve, Mix, fake)
    return control.train_seed(r, train, True, fake)


def test_serving_control_reads_wider_than_the_program(tmp_path):
    prog, ctl = [], []
    for seed in (1, 2):
        res = readings(tmp_path / str(seed), "mistral7b.longdoc", seed)
        prog.append(res["program"])
        ctl.append(res["control"])
    assert min(ctl) > 2 * max(prog), (prog, ctl)


def test_training_control_and_fault_read_wider_than_the_program(tmp_path):
    """Each has to fail one of the cell's numbers, not each: here one of
    them reads three times the program's or more."""
    res = readings(tmp_path, "mistral7b.train8k", 3)
    for bad in ("control", "half_batch"):
        assert max(res[bad][k] / max(res["program"][k], 1e-12)
                   for k in res["program"]) >= 3, res
