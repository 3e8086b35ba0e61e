"""On the card: one short run of each cell through the command the driver
runs, with its result line checked. Skipped without a CUDA device; run
with ``python -m pytest -m gpu portbench/tests/test_pb_card.py``."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["mistral7b.train8k",
                                  "mistral7b.longdoc"])
def test_cell_runs_on_the_card(cuda, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 32 + 17), "--seconds", "5", "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
