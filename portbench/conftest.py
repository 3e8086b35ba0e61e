"""Set-up of the benchmark's CPU tests. ``tests/tiny.py`` runs each cell of
``BENCHMARK.json`` on a tiny mix chosen by the cell's name (``CELLS``);
the cells named here came after that table and run on the tiny mix of
their kind (``tests/test_pb_qwen3_moe.py`` runs the Qwen3-MoE cell on its
own tiny configuration)."""

from portbench.tests import tiny

tiny.CELLS.setdefault("mistral7b.train4k", "ttrain")
tiny.CELLS.setdefault("qwen3-30b-a3b.turns", "tlong")
