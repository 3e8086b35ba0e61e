"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port (``flash_attn_tpu_torch``)
and ``BENCHMARK.json``. Needs a CUDA device; exits non-zero without one,
without the port, or when a JAX module was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from portbench.harness import cell
    from portbench.harness.common import Device

    bench = cell.load_json(ROOT / "BENCHMARK.json")
    chips = next((w["chips"] for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if chips is None:
        print(f"no workload {args.workload!r}", file=sys.stderr)
        return 2
    cell.require_cuda(chips)
    run = cell.make_run(bench, args.workload, seed=args.seed,
                        seconds=args.seconds, trace=bool(args.trace),
                        t_start=T_START, device=Device(torch.device("cuda")))
    line, ok = cell.execute(bench, run)
    if not ok:
        return 3
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
