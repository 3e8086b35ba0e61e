"""Readings that set a cell's correctness limits, at the cell's own size,
on several seeds in one process (not part of the benchmark's runs):

    python3 portbench/tools/control.py --workload mistral7b.longdoc \
        --seeds 1,2,3 --seconds 20

Serving cells: per seed a short window at the cell's own load and its
drain, then over the sampled requests the program's widest logit gap
against the float32 reference, and the control's: the reference computed
in fp8 (``mode="fp8"``) put in the program's place, its first token at
each position of the same prompts and served tokens read in the float32
reference. Training cells: per seed the program's gaps over the first
steps, the control's (the fp8 reference in the program's place), and
with ``--faults`` those of the program with half of each batch left out
(the mean taken over the rest). One JSON line per seed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def half_batch(step):
    def wrapped(batch):
        return step({k: v[: v.shape[0] // 2] for k, v in batch.items()})
    return wrapped


def serve_seed(r, serve, Mix, torch):
    weights, engine, fns, spans = serve.setup(r)
    mix = Mix(r.traffic, r.seed, r.config["vocab_size"])
    loop = serve.ramp(r, engine, fns, spans, mix)
    rec = serve.window(r, loop, mix)
    del engine, fns, loop
    torch.cuda.empty_cache()
    picked = serve.sample(r, rec["in_flight"] + rec["served"])
    seqs = serve.teacher_forced(picked, r.device.torch_device)
    r.reference.no_tf32()
    ref = r.reference.served_logits(weights, r.config, seqs)
    ctl = r.reference.served_logits(weights, r.config, seqs, mode="fp8")
    return {"requests": len(picked),
            "tokens": sum(len(s.req.generated) for s in picked),
            "failed": rec["failed"],
            "program": serve.widest_gap(ref, [s.req.generated
                                              for s in picked]),
            "control": serve.widest_gap(ref, [lg.argmax(-1) for lg in ctl])}


def train_seed(r, train, faults, torch):
    out = {}
    variants = [("program", None)] + ([("half_batch", half_batch)]
                                      if faults else [])
    for name, wrap in variants:
        r.wrap_step = wrap
        model, opt, step, feed, spec, wseed = train.build(r)
        out[name] = train.first_steps(r, model, opt, step, feed, spec,
                                      wseed)
        del model, opt, step
        torch.cuda.empty_cache()
    r.wrap_step = None
    ref = train.reference_readings(r)
    res = {k: train.compare(v, ref) for k, v in out.items()}
    res["control"] = train.compare(train.reference_readings(r, "fp8"), ref)
    res["losses"] = ref["losses"]
    return res


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=15)
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()

    import torch

    from portbench.harness import cell, serve, train
    from portbench.harness.common import Device
    from portbench.harness.traffic import Mix

    bench = cell.load_json(ROOT / "BENCHMARK.json")
    cell.require_cuda(1)
    for seed in (int(x) for x in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = cell.make_run(bench, args.workload, seed=seed,
                          seconds=args.seconds, trace=False,
                          t_start=t0, device=Device(torch.device("cuda")))
        res = (serve_seed(r, serve, Mix, torch)
               if r.traffic["kind"] == "serve"
               else train_seed(r, train, args.faults, torch))
        res.update(seed=seed, seconds=time.perf_counter() - t0)
        print(json.dumps(res), flush=True)
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
