"""Device time of a call on one CUDA card, and the dense kernels' rows.

    python3 dense_timing.py [--repo DIR]

As a module it holds how chip_smoke.py times a call: ``busy_ms``, the
device busy time of one call in a profiler trace (the union of its kernel,
memcpy and memset intervals, so the gaps the host leaves between launches
do not count), and ``host_ms``, the host time to issue one call. On a card
whose host issues a call more slowly than the shortest kernels run, CUDA
events around back-to-back calls time the host, not the card.

As a script it times the flash_attn_tpu_torch package of the checkout at
DIR (default: the one holding this file): K1 (flash_attention_fwd) and K2
(flash_attention_bwd) at the rows of PERF.md's table, each by busy_ms and
host_ms, and one GPT-2 admission of 8 prompts (9..700 tokens, bucket 768)
through ServingEngine, traced for K1's device time per launch on the
serving path, with the median host time of three untraced admissions. To
compare two commits by the same method, unpack the other one with `git
archive` into a git-ignored directory and run both in one session on the
card (other, this, this, other). Needs a CUDA card; prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# Seconds of calls before busy_ms traces, to bring the card's clocks up
# from idle.
WARM_S = 0.2
# The profiler range that holds the calls busy_ms measures, and the seconds
# of calls traced before and after it.
MEASURED = "busy_ms: measured calls"
PAD_S = 0.025
# Host-side calls that put work on the card, by their names in the trace.
LAUNCHES = ("Launch", "Memset", "Memcpy")


def trace_call(fn, record_shapes=False):
    """``fn()`` under torch.profiler: (host wall ms, the operator names, the
    chrome-trace events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    names = {e.key for e in prof.key_averages()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return wall, names, events


def device_events(events):
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not dev:
        raise RuntimeError("the trace holds no device events")
    return dev


def union_us(dev) -> float:
    """Microseconds covered by the union of the device events' intervals."""
    busy, end = 0.0, -math.inf
    for a, b in sorted((e["ts"], e["ts"] + e["dur"]) for e in dev):
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy


def busy_ms(fn, n=10, warm_s=WARM_S) -> float:
    """Device busy time of one call of ``fn`` in ms: the union of the
    kernel, memcpy and memset intervals of ``n`` calls, over n.

    The calls run after ``warm_s`` seconds of calls, inside a profiler
    range with PAD_S seconds of calls before and after it in the same
    trace: the trace drops device events near its start and end, over a
    span that grows the longer the process has run (over 0.5 ms after a
    few minutes). The measured calls' device events are found by the
    correlation ids of the launches made inside the range; every one of
    those launches must have its device event, else the trace is taken
    again, and after three incomplete traces this raises."""
    from torch.profiler import record_function

    def repeat(seconds):
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            fn()

    repeat(warm_s)
    torch.cuda.synchronize()

    def calls():
        repeat(PAD_S)
        with record_function(MEASURED):
            for _ in range(n):
                fn()
        repeat(PAD_S)

    for _ in range(3):
        _, _, events = trace_call(calls)
        span = next(e for e in events if e.get("name") == MEASURED
                    and e.get("cat") == "user_annotation")
        launched = {e["args"]["correlation"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and any(k in e["name"] for k in LAUNCHES)
                    and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]}
        dev = [e for e in device_events(events)
               if e["args"].get("correlation") in launched]
        if launched and len({e["args"]["correlation"] for e in dev}) \
                == len(launched):
            return union_us(dev) / 1e3 / n
    raise RuntimeError(
        f"busy_ms: {len(launched)} launches in the measured range, device "
        f"events for {len({e['args']['correlation'] for e in dev})} of them")


def host_ms(fn, n=20, warmup=3) -> float:
    """Host time to issue one call of ``fn`` in ms: ``n`` calls with no
    synchronisation between them. Where it exceeds busy_ms, the host sets
    the pace of back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e3


def dense_rows(fwd, bwd, dev):
    """{row: call} for K1 and K2 at PERF.md's rows, on contiguous bf16
    (b, h, s, d) inputs from torch.Generator seed 0."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    rows = {}
    q, k, v = (randn(8, 12, 768, 64) for _ in range(3))
    rows["K1 serving bucket b8 h12 s768 d64"] = lambda: fwd(
        q, k, v, causal=True, softmax_scale=0.125, save_lse=False)
    for label, (b, h, h_kv, s, d), p in (
            ("train b8 h12 s1024 d64", (8, 12, 12, 1024, 64), 0.1),
            ("config 4 b1 h8 s8192 d64", (1, 8, 8, 8192, 64), 0.0),
            ("Llama-3-8B widths b2 h32/8 s2048 d128", (2, 32, 8, 2048, 128),
             0.0)):
        qt, dt = randn(b, h, s, d), randn(b, h, s, d)
        kt, vt = randn(b, h_kv, s, d), randn(b, h_kv, s, d)
        kw = dict(causal=True, softmax_scale=d ** -0.5, dropout_p=p,
                  seed=1234 if p else None)
        ot, lt = fwd(qt, kt, vt, save_lse=True, **kw)
        rows[f"K1 {label}, dropout {p}, lse"] = (
            lambda a=(qt, kt, vt), kw=kw: fwd(*a, save_lse=True, **kw))
        if p:
            rows[f"K1 {label}, dropout 0, lse"] = (
                lambda a=(qt, kt, vt), d=d: fwd(
                    *a, causal=True, softmax_scale=d ** -0.5, save_lse=True))
        rows[f"K2 {label}, dropout {p}"] = (
            lambda a=(qt, kt, vt, ot, dt, lt), kw=kw: bwd(*a, **kw))
    return rows


def serve_admission(dev):
    """K1's launches and device ms per launch in one traced GPT-2 admission
    of 8 prompts, the admission's device busy ms, and the median host ms
    of three untraced admissions (time to first token)."""
    from flash_attn_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
    from flash_attn_tpu_torch.serving.engine import ServingEngine
    cfg = GPT2Config(param_dtype=torch.bfloat16)
    model = GPT2LMHeadModel(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in np.linspace(9, 700, 8).astype(int)]

    def engine():
        eng = ServingEngine(model, cfg, max_batch=8, page_size=128,
                            num_pages=128, pages_per_seq=8)
        for p in prompts:
            eng.submit(p, max_new_tokens=1000)
        torch.cuda.synchronize()
        return eng

    engine()._admit()  # cuBLAS handles, the allocator
    walls = []
    for _ in range(3):
        eng = engine()
        t0 = time.perf_counter()
        eng._admit()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    _, _, events = trace_call(engine()._admit)
    dev_events = device_events(events)
    k1 = [e["dur"] for e in dev_events if "flash_fwd" in e["name"]]
    copies = sum(e["dur"] for e in dev_events
                 if "copy" in (e.get("cat", "") + e["name"]).lower())
    return {"k1_launches": len(k1),
            "k1_ms_per_launch": sum(k1) / max(len(k1), 1) / 1e3,
            "busy_ms": union_us(dev_events) / 1e3,
            "copies_ms": copies / 1e3,
            "ttft_ms_median": statistics.median(walls)}


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=os.path.dirname(
        os.path.abspath(__file__)), help="checkout whose kernels are timed")
    parser.add_argument("--warm-s", type=float, default=WARM_S,
                        help="seconds of calls before each trace")
    args = parser.parse_args()
    repo, warm_s = os.path.abspath(args.repo), args.warm_s
    if not torch.cuda.is_available():
        sys.exit("dense_timing.py needs a CUDA card")
    sys.path.insert(0, repo)
    import flash_attn_tpu_torch as pkg
    from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
    from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd
    if os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) != repo:
        sys.exit(f"imported {pkg.__file__}, not the package under {repo}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    from flash_attn_tpu_torch.kernels import _build
    _build.lib()
    build_s = time.perf_counter() - t0
    rows = {}
    for name, fn in dense_rows(flash_attention_fwd, flash_attention_bwd,
                               dev).items():
        rows[name] = {"busy_ms": [busy_ms(fn, warm_s=warm_s),
                                  busy_ms(fn, warm_s=warm_s)],
                      "host_ms": host_ms(fn)}
        print(f"{name}: device busy {rows[name]['busy_ms'][0]:.4f} / "
              f"{rows[name]['busy_ms'][1]:.4f} ms, host "
              f"{rows[name]['host_ms']:.4f} ms per call", flush=True)
    admission = serve_admission(dev)
    print(f"GPT-2 admission of 8: {admission}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"repo": repo, "card": card, "warm_s": warm_s,
                      "build_s": build_s,
                      "rows": rows, "admission": admission}))


if __name__ == "__main__":
    main()
