"""Device time of a call on one CUDA card, and every kernel row's time.

    python3 dense_timing.py [--repo DIR] [--rows PREFIX]

As a module it holds how the repo times work on the card: ``busy_ms``, the
device busy time of one call in a profiler trace (the union of its kernel,
memcpy and memset intervals, so the gaps the host leaves between launches
do not count); ``host_ms``, the host time to issue one call; ``trace_call``,
one profiled call whose device events are all found; ``device_summary``, a
trace's busy time, idle share and device time by kernel class; and the
inputs chip_smoke.py checks at the same shapes (CHUNK_SHAPES, APPEND_SHAPES,
CHAIN_MODELS, the BERT padding, the Mistral window). On a card whose host
issues a call more slowly than the shortest kernels run, CUDA events around
back-to-back calls time the host, not the card.

As a script it is the one tool that times the kernels, those of the
flash_attn_tpu_torch package of the checkout at DIR (default: the one
holding this file): every row of PERF.md's kernel table and the rows beside
them that isolate one cost. Each row is timed twice by busy_ms, with
host_ms; where PERF.md's table has the column, also its plain twin (busy_ms
over 3 calls: it launches hundreds of small kernels a call), the one
library call that computes the same function (SDPA under each of its
flash, cuDNN and efficient backends pinned in turn, the fastest reported;
index_copy_ or index_put_ for the cache writes) and the bound (``bound``).
The rows, by the prefix ``--rows`` selects them with (several: K5,K6):
  K1, K2   flash_attention_fwd / _bwd at the serving bucket, GPT-2's train
           step, config 4, the Llama-3-8B-width train step, ViT-B/16's
           attention; in segment form at BERT's padding masks (beside the
           same kernels with no mask, with every token real, and the tile
           plan alone) and on the same batch packed as one sequence;
  K5, K6   paged decode / chunk attention at GPT-2's and Llama-3-8B's decode
           and chunk shapes and at verification, alone and with the append
           in their launch;
  K7a-c    the cache writes alone and the two-launch route of the appends;
  K8       blocksparse forward, dK/dV and dQ (K8a-c) at BS_SHAPES (i), (ii);
  W        the sliding-window rows: K1 and K2 at Mistral-7B's train step
           (b2 h32/8 s8192 d128, window 4096), K5 and K6 at its decode and
           chunked-prefill shapes, each with and without the window on the
           same tensors;
  chain    add_rmsnorm, qk_rope and swiglu at Mistral-7B's and
           Qwen3-30B-A3B's chunk and decode shapes.
Without ``--rows``, then: one GPT-2 admission of 8 prompts (9..700 tokens,
bucket 768) through ServingEngine, traced for K1's and K7c's launches and
device time, with the median host time of three untraced admissions, then
16 decode steps of it traced (decode_window: device busy ms, launches and
wall ms per step, idle share, and the copy kernels between each layer's
projection and K5); one chunked admission of 8 prompts at Llama-3-8B's
widths cut to 4 layers, traced for K7c's launches and device time, then 4
of its decode steps traced the same way; and two traced GPT-2 train steps
through blocksparse attention (full width, b=8, s=1024, the LocalGlobal(256)
mask), for their device busy time and K8a-c's share of it. A row whose
inputs fit in the 50 MB L2 would time L2, not the path: the K7c Llama chunk
and the chain's chunk rows cycle through input sets (``rotating``).

To compare two commits by the same method, unpack the other one with `git
archive` into a git-ignored directory and run both in one session on the
card (other, this, this, other), with ``--rows`` naming the rows at stake.
Needs a CUDA card; prints a line per row and one JSON line.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import itertools
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

from portbench.harness.common import PEAK_BYTES, PEAK_FLOPS

# Seconds of calls before busy_ms traces, to bring the card's clocks up
# from idle.
WARM_S = 0.2
# The profiler range that holds a traced call, and the seconds of padding
# calls traced before and after it.
MEASURED = "trace_call: measured call"
PAD_S = 0.025
# Traces of one call that trace_call takes before it gives up.
TRACE_TRIES = 3
# Input sets that a timed row cycles through, one per call, where one set
# fits in the card's 50 MB L2: four sets of one Llama chunk layer's write
# (34 MB each: k, v and the cache) make every call miss L2.
ROTATE = 4
L2_BYTES = 50 * 2**20  # H100 SXM
# Layers of the Llama-3-8B admission the script traces: K7c's launches and
# time grow with the depth, so a cut depth shows the change at 1/8 the
# cost of building the full model.
LLAMA_LAYERS = 4
# Host-side calls that put work on the card, by their names in the trace.
LAUNCHES = ("Launch", "Memset", "Memcpy")
# Trace event categories of work on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# (class, substrings of the kernel name), first match: device_summary's
# classes. portbench/harness/common.py has its own table for the
# benchmark's breakdown (with the split merge, without the dropout RNG).
KERNEL_CLASSES = [
    ("blocksparse (K8)", ("bs_fwd", "bs_dkv", "bs_dq", "bs_stats")),
    ("flash_bwd (K2)", ("flash_bwd", "bwd_stats", "bwd_dq")),
    ("flash_fwd (K1)", ("flash_fwd",)),
    ("paged_decode (K5)", ("paged_decode",)),
    ("paged_chunk (K6)", ("paged_chunk",)),
    ("cache writes (K7)", ("append_token", "append_span", "write_pages")),
    ("GEMM", ("gemm", "cutlass", "nvjet", "xmma", "sm90_")),
    ("optimizer", ("multi_tensor", "adam")),
    ("loss", ("cross_entropy", "softmax", "nll")),
    ("layer_norm", ("layer_norm",)),
    ("dropout RNG", ("philox", "distribution", "uniform")),
    ("copies", ("memcpy", "memset", "copy")),
]


def _repeat(fn, seconds):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        fn()


def trace_call(fn, record_shapes=False, setup=None, pad=None):
    """``fn()`` (``fn(setup())`` when ``setup`` is given) under
    torch.profiler: (host wall ms of the call, ending in a synchronize;
    the operator names; the chrome-trace events, of which the device
    events are those of the call's own launches).

    The trace drops device events near its start and end, over a span that
    grows the longer the process has run (whole calls, after a few minutes
    of chip_smoke.py). So the call runs inside a profiler range with PAD_S
    seconds of ``pad()`` calls (default: a one-element add) before and
    after it in the same trace, its device events are found by the
    correlation ids of the launches made inside the range, and every one
    of those launches must have its device event: a trace that misses any
    is taken again (``setup()`` builds the call's input afresh, outside the
    trace), and after TRACE_TRIES incomplete traces this raises."""
    from torch.profiler import ProfilerActivity, profile, record_function
    if pad is None:
        one = torch.zeros(1, device="cuda")
        pad = functools.partial(one.add_, 1)
    for _ in range(TRACE_TRIES):
        arg = setup() if setup is not None else None
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     record_shapes=record_shapes) as prof:
            _repeat(pad, PAD_S)
            with record_function(MEASURED):
                t0 = time.perf_counter()
                fn() if setup is None else fn(arg)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            _repeat(pad, PAD_S)
            torch.cuda.synchronize()
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        span = next(e for e in events if e.get("name") == MEASURED
                    and e.get("cat") == "user_annotation")
        launched = {e["args"]["correlation"] for e in events
                    if e.get("cat") in ("cuda_runtime", "cuda_driver")
                    and any(k in e["name"] for k in LAUNCHES)
                    and span["ts"] <= e["ts"] <= span["ts"] + span["dur"]}
        dev = [e for e in events if e.get("cat") in DEVICE_CATS
               and e["args"].get("correlation") in launched]
        found = len({e["args"]["correlation"] for e in dev})
        if launched and found == len(launched):
            names = {e.key for e in prof.key_averages()}
            host = [e for e in events if e.get("cat") not in DEVICE_CATS]
            return wall, names, host + dev
    raise RuntimeError(f"trace_call: {len(launched)} launches in the traced "
                       f"call, device events for {found} of them")


def device_events(events):
    dev = [e for e in events if e.get("cat") in DEVICE_CATS]
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


def device_summary(wall, events):
    """GPU span, busy time (the union of the trace's kernel, memcpy and
    memset intervals), idle share and device time by KERNEL_CLASSES."""
    dev = device_events(events)
    busy = union_us(dev)
    span = (max(e["ts"] + e["dur"] for e in dev)
            - min(e["ts"] for e in dev))
    by_class = {}
    for e in dev:
        name = (e.get("cat", "") + " " + e.get("name", "")).lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in name for k in keys)), "elementwise/other")
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"]
    total = sum(by_class.values())
    shares = ", ".join(f"{c} {t / total * 100:.1f}%" for c, t in sorted(
        by_class.items(), key=lambda kv: -kv[1]))
    return (f"wall {wall:.2f} ms (traced), GPU span {span / 1e3:.2f} ms, "
            f"device busy {busy / 1e3:.2f} ms, idle "
            f"{(1 - busy / span) * 100:.1f}% of the span; {len(dev)} device "
            f"events; device time by class: {shares}")


def busy_ms(fn, n=10, warm_s=WARM_S) -> float:
    """Device busy time of one call of ``fn`` in ms: the union of the
    kernel, memcpy and memset intervals of ``n`` calls, over n, after
    ``warm_s`` seconds of calls, traced by ``trace_call`` padded with calls
    of ``fn`` itself (every launch matched to its device event)."""
    _repeat(fn, warm_s)
    torch.cuda.synchronize()
    _, _, events = trace_call(lambda: [fn() for _ in range(n)], pad=fn)
    return union_us(device_events(events)) / 1e3 / n


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


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it: each
    input read once and each output written once at the HBM rate, or the
    tensor-core products at the bf16 peak (PEAK_BYTES, PEAK_FLOPS)."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@dataclasses.dataclass
class Row:
    """A timed row: the kernel's ``call``, and where PERF.md's table has
    them its plain twin, its library call (a call returning (ms, what it
    ran): ``sdpa`` or ``torch_call``), and the bytes and tensor-core
    operations of its bound."""
    call: object
    plain: object = None
    library: object = None
    n_bytes: float = 0
    flops: float = 0


SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa(q, k, v, dout=None, p=0.0, mask=None, causal=True, wrt="qkv"):
    """A row's library call through scaled_dot_product_attention on (b, h,
    s, d) operands, causal or under the boolean ``mask``: the forward, or
    with ``dout`` the gradients ``wrt`` of a graph built under the pinned
    backend. Returns a call that times it by busy_ms under each backend of
    SDPA_BACKENDS in turn and returns (the fastest accepting backend's ms,
    what ran: that backend and every backend's time or refusal)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    kw = dict(is_causal=causal) if mask is None else dict(attn_mask=mask)
    kw.update(dropout_p=p, enable_gqa=k.shape[1] != q.shape[1])
    attend = torch.nn.functional.scaled_dot_product_attention

    def make():
        if dout is None:
            return lambda: attend(q, k, v, **kw)
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = attend(*leaves, **kw)
        wanted = [leaves["qkv".index(c)] for c in wrt]
        return lambda: torch.autograd.grad(out, wanted, dout,
                                           retain_graph=True)

    def timed():
        times = {}
        for name in SDPA_BACKENDS:
            with sdpa_kernel(getattr(SDPBackend, name)):
                try:
                    fn = make()
                    fn()
                    torch.cuda.synchronize()
                except RuntimeError:
                    times[name] = None
                    continue
                times[name] = busy_ms(fn)
        ok = {k: t for k, t in times.items() if t is not None}
        if not ok:
            raise RuntimeError("no SDPA backend accepts the library call")
        best = min(ok, key=ok.get)
        return ok[best], f"SDPA {best}; " + ", ".join(
            f"{k} {'refused' if t is None else f'{t:.4f}'}"
            for k, t in times.items())
    return timed


def torch_call(label, fn):
    """A library call that is plain PyTorch, not SDPA."""
    return lambda: (busy_ms(fn), label)


def band_pairs(sq: int, sk: int, left: int) -> int:
    """Visible (query, key) pairs of causal attention with a left window:
    row i sees keys [max(0, i - left), min(i, sk - 1)]."""
    i = np.arange(sq)
    return int((np.minimum(i, sk - 1) - np.maximum(0, i - left) + 1).clip(
        min=0).sum())


def bf16_randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(
        torch.bfloat16)


def dense_rows(dev):
    """{row: Row} for K1 and K2 on contiguous bf16 (b, h, s, d) inputs from
    torch.Generator seed 0: the serving bucket (no lse); then each of
    GPT-2's train step, config 4, the Llama-3-8B-width train step and
    ViT-B/16's attention with lse, and K1 there without its dropout too.
    Bound: q, k, v (and o, dout) read, the outputs written once; 4 d
    operations a visible pair forward, 10 d backward."""
    from flash_attn_tpu_torch.kernels.flash_bwd import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )
    from flash_attn_tpu_torch.kernels.flash_fwd import (
        flash_attention_fwd,
        flash_attention_fwd_plain,
    )
    fwd, bwd = flash_attention_fwd, flash_attention_bwd
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = functools.partial(bf16_randn, gen)
    rows = {}
    a = tuple(randn(8, 12, 768, 64) for _ in range(3))
    kw = dict(causal=True, softmax_scale=0.125, save_lse=False)
    rows["K1 serving bucket b8 h12 s768 d64"] = Row(
        functools.partial(fwd, *a, **kw),
        functools.partial(flash_attention_fwd_plain, *a, **kw), sdpa(*a),
        nbytes(*a, a[0]), 4 * 8 * 12 * band_pairs(768, 768, 768) * 64)
    for label, (b, h, h_kv, s, d), p, causal in (
            ("train b8 h12 s1024 d64", (8, 12, 12, 1024, 64), 0.1, True),
            ("config 4 b1 h8 s8192 d64", (1, 8, 8, 8192, 64), 0.0, True),
            ("Llama train b4 h32/8 s2048 d128", (4, 32, 8, 2048, 128), 0.0,
             True),
            ("ViT-B/16 b64 h12 s196 d64 non-causal", (64, 12, 12, 196, 64),
             0.1, False)):
        qt, dt = randn(b, h, s, d), randn(b, h, s, d)
        kt, vt = randn(b, h_kv, s, d), randn(b, h_kv, s, d)
        kw = dict(causal=causal, softmax_scale=d ** -0.5, dropout_p=p,
                  seed=1234 if p else None)
        ot, lt = fwd(qt, kt, vt, save_lse=True, **kw)
        pairs = b * h * (band_pairs(s, s, s) if causal else s * s)
        a, g = (qt, kt, vt), (qt, kt, vt, ot, dt, lt)
        rows[f"K1 {label}, dropout {p}, lse"] = Row(
            lambda a=a, kw=kw: fwd(*a, save_lse=True, **kw),
            lambda a=a, kw=kw: flash_attention_fwd_plain(*a, save_lse=True,
                                                         **kw),
            sdpa(*a, p=p, causal=causal), nbytes(*a, qt, lt), 4 * pairs * d)
        if p:
            rows[f"K1 {label}, dropout 0, lse"] = Row(
                lambda a=a, kw=dict(kw, dropout_p=0.0, seed=None):
                    fwd(*a, save_lse=True, **kw))
        rows[f"K2 {label}, dropout {p}"] = Row(
            lambda g=g, kw=kw: bwd(*g, **kw),
            lambda g=g, kw=kw: flash_attention_bwd_plain(*g, **kw),
            sdpa(*a, dout=dt, p=p, causal=causal), nbytes(*g, *a),
            10 * pairs * d)
    return rows


# Mistral-7B-v0.1's attention: 32 query heads over 8 kv heads of d 128,
# sliding_window 4096; its train step's b x s, and the decode and chunked
# prefill (8 sequences, contexts 1000..7000, page 128) of the serving phase.
MISTRAL_TRAIN = (2, 32, 8, 8192, 128)
MISTRAL_WINDOW = 4096
MISTRAL_DECODE = [int(x) for x in np.linspace(1000, 7000, 8)]
MISTRAL_CHUNK = 512


def window_inputs(dev):
    """bf16 inputs of the window rows from torch.Generator seed 0: the
    train step's (q, k, v, dout, o, lse) with the window, the decode's
    (q, pages, lengths, table) and the chunk's (q, pages, lengths, table,
    chunk_lens) (lengths include the chunk)."""
    from flash_attn_tpu_torch.kernels.common import Band
    from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd
    from flash_attn_tpu_torch.serving import cache
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = functools.partial(bf16_randn, gen)
    b, h, h_kv, s, d = MISTRAL_TRAIN
    q, dout = randn(b, h, s, d), randn(b, h, s, d)
    k, v = randn(b, h_kv, s, d), randn(b, h_kv, s, d)
    o, lse = flash_attention_fwd(q, k, v, causal=True,
                                 softmax_scale=d ** -0.5, save_lse=True,
                                 band=Band(MISTRAL_WINDOW))
    ps = 128
    lengths = MISTRAL_DECODE
    pmax = -(-max(lengths) // ps)
    pages = cache.init_cache(h_kv, 1 + len(lengths) * pmax, ps, d,
                             dtype=torch.bfloat16, device=dev)
    pages.k_pages.copy_(randn(*pages.k_pages.shape))
    pages.v_pages.copy_(randn(*pages.v_pages.shape))
    table = (1 + torch.randperm(len(lengths) * pmax, generator=gen,
                                device=dev)).reshape(len(lengths), pmax).to(
        torch.int32)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    qd = randn(len(lengths), h, d)
    qc = randn(len(lengths), MISTRAL_CHUNK, h, d)
    chunk = torch.full((len(lengths),), MISTRAL_CHUNK, dtype=torch.int32,
                       device=dev)
    return ((q, k, v, dout, o, lse), (qd, pages, lens, table),
            (qc, pages, lens, table, chunk))


def window_rows(dev):
    """{row: Row} for the window rows ("W ..."), each kernel with the
    window and without it on the same tensors. With the window: K1 and K2
    beside SDPA with the band as a boolean attn_mask (their dense twins'
    fp32 scores would not fit on the card), K5 and K6 beside their twins
    (no one-call library equivalent); bounds over the visible pairs and
    the keys the band holds."""
    from flash_attn_tpu_torch.kernels import common
    from flash_attn_tpu_torch.kernels.chunk import (
        paged_chunk_attention,
        paged_chunk_attention_plain,
    )
    from flash_attn_tpu_torch.kernels.decode import (
        paged_decode_attention,
        paged_decode_attention_plain,
    )
    from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
    from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd
    from flash_attn_tpu_torch.reference import build_mask
    (q, k, v, dout, o, lse), dec, chk = window_inputs(dev)
    b, h, h_kv, s, d = MISTRAL_TRAIN
    L = MISTRAL_WINDOW
    train = f"Mistral train b{b} h{h}/{h_kv} s{s} d{d}"
    kw = dict(causal=True, softmax_scale=d ** -0.5)
    mask = build_mask(s, s, causal=True, window_left=L, device=dev)
    pairs = b * h * band_pairs(s, s, L)
    qd, pages, lens, table = dec
    qc, _, _, _, chunk = chk
    kp, vp = pages.k_pages, pages.v_pages
    n, c = lens.tolist(), MISTRAL_CHUNK
    keys5 = sum(min(x, L + 1) for x in n)
    keys6 = sum(x - max(0, x - c - L) for x in n)
    pairs6 = sum(min(x - c + t, L) + 1 for x in n for t in range(c))
    tables = nbytes(lens, table, chunk)
    plain = dict(softmax_scale=d ** -0.5, terms=(L, 0, None, None))
    shape = f"b{len(n)} h{h}/{h_kv} d{d} contexts {n[0]}..{n[-1]}"
    rows = {}
    for label, band, window in (
            (f"window {L}", common.Band(L), L),
            ("no window", common.NO_BAND, None)):
        rows[f"W K1 {train}, {label}, lse"] = Row(functools.partial(
            flash_attention_fwd, q, k, v, save_lse=True, band=band, **kw))
        rows[f"W K2 {train}, {label}"] = Row(functools.partial(
            flash_attention_bwd, q, k, v, o, dout, lse, band=band, **kw))
        rows[f"W K5 Mistral decode {shape}, {label}"] = Row(
            functools.partial(paged_decode_attention, qd, kp, vp, lens,
                              table, window_left=window))
        rows[f"W K6 Mistral chunk sq{c} {shape}, {label}"] = Row(
            functools.partial(paged_chunk_attention, qc, kp, vp, lens, table,
                              chunk_lens=chunk, window_left=window))
    for name, extra in {
            f"W K1 {train}, window {L}, lse": dict(
                library=sdpa(q, k, v, mask=mask),
                n_bytes=nbytes(q, k, v, o, lse), flops=4 * pairs * d),
            f"W K2 {train}, window {L}": dict(
                library=sdpa(q, k, v, dout=dout, mask=mask),
                n_bytes=nbytes(q, k, v, o, dout, lse, q, k, v),
                flops=10 * pairs * d),
            f"W K5 Mistral decode {shape}, window {L}": dict(
                plain=functools.partial(paged_decode_attention_plain, qd, kp,
                                        vp, lens, table, **plain),
                n_bytes=2 * nbytes(qd) + 4 * keys5 * h_kv * d + tables,
                flops=4 * keys5 * h * d),
            f"W K6 Mistral chunk sq{c} {shape}, window {L}": dict(
                plain=functools.partial(paged_chunk_attention_plain, qc, kp,
                                        vp, lens, table, chunk_lens=chunk,
                                        **plain),
                n_bytes=2 * nbytes(qc) + 4 * keys6 * h_kv * d + tables,
                flops=4 * pairs6 * h * d)}.items():
        rows[name] = dataclasses.replace(rows[name], **extra)
    return rows


def bert_lengths(b=32, s=512, seed=0):
    """Row lengths of the BERT batch (chip_smoke.py): uniform in [s/3, s]
    (the reference's generate_random_padding_mask;
    tests/test_varlen.py:28-31) from numpy's default_rng(seed)."""
    return np.random.default_rng(seed).integers(s // 3, s + 1, size=b)


def bert_padding(dev, b=32, s=512, seed=0):
    """The key-padding layout of rows of ``bert_lengths``, as (q_seg,
    kv_seg, q_pos, kv_pos) int32 (b, s) on ``dev``: id 0 at real tokens,
    -1 at padding, positions arange (models/modules.py makes the same from
    key_padding_mask)."""
    lengths = torch.as_tensor(bert_lengths(b, s, seed), device=dev)
    pos = torch.arange(s, device=dev, dtype=torch.int32)
    seg = torch.where(pos[None] < lengths[:, None], 0, -1).to(torch.int32)
    pos = pos.expand_as(seg).contiguous()
    return seg, seg, pos, pos


def segment_rows(dev, b=32, s=512):
    """{row: Row} for K1 and K2 in segment form: at BERT's attention shape
    (b32 h12 s512 d64, bert_padding, dropout 0.1, lse; K1's calls make
    their tile plan, K2's reuse one) beside their twins and SDPA with the
    key-padding mask (b, 1, 1, s) as attn_mask, the same kernels with no
    mask, in segment form with every token real (the plan lists every
    tile, all full: the segment form's own cost) and the tile plan alone;
    and on the same batch packed as one super-sequence (b1, the 32
    sequences back to back: the cu_seqlens interface's layout); bf16 from
    torch.Generator seed 0. Bound: the real rows of q, k, v (and o, dout)
    read, the outputs written whole, the products over the visible pairs
    (4 d operations a pair forward, 10 d backward)."""
    from flash_attn_tpu_torch.kernels.common import (
        Segments,
        segment_mask,
        segment_plan,
    )
    from flash_attn_tpu_torch.kernels.flash_bwd import (
        flash_attention_bwd,
        flash_attention_bwd_plain,
    )
    from flash_attn_tpu_torch.kernels.flash_fwd import (
        flash_attention_fwd,
        flash_attention_fwd_plain,
    )
    fwd, bwd = flash_attention_fwd, flash_attention_bwd
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = functools.partial(bf16_randn, gen)
    kw = dict(causal=False, softmax_scale=0.125, dropout_p=0.1, seed=1234)
    ids = bert_padding(dev, b, s)
    q, k, v, do = (randn(b, 12, s, 64) for _ in range(4))
    n = int((ids[0] >= 0).sum())
    lengths = (ids[0] >= 0).sum(1).tolist()
    seq = torch.repeat_interleave(torch.arange(b, device=dev),
                                  torch.as_tensor(lengths, device=dev))
    start = torch.cumsum(torch.as_tensor([0] + lengths[:-1], device=dev), 0)
    local = torch.arange(n, device=dev) - start[seq]
    packed = tuple(x.to(torch.int32)[None].contiguous()
                   for x in (seq, seq, local, local))
    qp, kp, vp, dp = (randn(1, 12, n, 64) for _ in range(4))
    rows = {}
    for label, args, seg in ((f"BERT b{b} s{s} padding", (q, k, v, do), ids),
                             (f"BERT batch packed b1 s{n}", (qp, kp, vp, dp),
                              packed)):
        plan = Segments(*seg)
        o, lse = fwd(*args[:3], save_lse=True, segments=plan, **kw)
        grads = (*args[:3], o, args[3], lse)
        rows[f"K1 {label}, segments"] = Row(
            lambda a=args, seg=seg: fwd(*a[:3], save_lse=True,
                                        segments=Segments(*seg), **kw))
        rows[f"K2 {label}, segments"] = Row(
            lambda g=grads, plan=plan: bwd(*g, segments=plan, **kw))
        if "packed" in label:
            continue
        pairs = int(segment_mask(plan, False).sum()) * 12
        real = n / (b * s)
        row = nbytes(q)  # one (b, h, s, d) bf16 operand
        key_mask = (seg[1] >= 0)[:, None, None, :]
        rows[f"K1 {label}, segments"] = dataclasses.replace(
            rows[f"K1 {label}, segments"],
            plain=lambda: flash_attention_fwd_plain(
                q, k, v, save_lse=True, segments=Segments(*ids), **kw),
            library=sdpa(q, k, v, p=0.1, mask=key_mask),
            n_bytes=3 * real * row + row + nbytes(lse), flops=4 * 64 * pairs)
        rows[f"K2 {label}, segments"] = dataclasses.replace(
            rows[f"K2 {label}, segments"],
            plain=lambda g=grads: flash_attention_bwd_plain(
                *g, segments=Segments(*ids), **kw),
            library=sdpa(q, k, v, dout=do, p=0.1, mask=key_mask),
            n_bytes=5 * real * row + 3 * row + nbytes(lse),
            flops=10 * 64 * pairs)
        real_ids = (torch.zeros_like(seg[0]),) * 2 + seg[2:]
        rows[f"K1 {label}, segments, all tokens real"] = Row(
            lambda: fwd(q, k, v, save_lse=True,
                        segments=Segments(*real_ids), **kw))
        rows[f"K1 {label}, its tile plan alone"] = Row(
            lambda: segment_plan(Segments(*ids), False))
        od, lsed = fwd(q, k, v, save_lse=True, **kw)
        rows[f"K1 {label}, no mask"] = Row(
            lambda: fwd(q, k, v, save_lse=True, **kw))
        rows[f"K2 {label}, no mask"] = Row(
            lambda: bwd(q, k, v, od, do, lsed, **kw))
    return rows


def rotating(calls):
    """A call that runs the next of ``calls`` each time."""
    turn = itertools.cycle(calls)
    return lambda: next(turn)()


def k7c_inputs(dev):
    """K7c's inputs at PERF.md's rows, bf16 from torch.Generator seed 0:
    GPT-2's prompt (cache, k, v, page ids: 768 tokens into 6 pages, h 12,
    d 64), and ROTATE sets of one layer of Llama-3-8B's chunk (cache, k, v,
    page table: 8 rows x 512 tokens into 4 pages each, h_kv 8, d 128)."""
    from flash_attn_tpu_torch.serving import cache
    gen = torch.Generator(device=dev).manual_seed(0)
    gpt2 = (cache.init_cache(12, 65, 128, 64, dtype=torch.bfloat16,
                             device=dev),
            bf16_randn(gen, 768, 12, 64), bf16_randn(gen, 768, 12, 64),
            torch.tensor([7, 3, 9, 11, 5, 13], dtype=torch.int32, device=dev))
    tbl = (torch.randperm(32, generator=torch.Generator().manual_seed(1))
           + 1).reshape(8, 4).to(dev, torch.int32)
    llama = [(cache.init_cache(8, 33, 128, 128, dtype=torch.bfloat16,
                               device=dev),
              bf16_randn(gen, 8, 512, 8, 128), bf16_randn(gen, 8, 512, 8, 128),
              tbl) for _ in range(ROTATE)]
    return gpt2, llama


def copy_pages(c, k, v, table):
    """write_pages' library call: index_copy_ along the page axis of row
    r's pages (zero-tailed) of k, v (b, n, h, d) to table[r], K then V,
    from sources put in the cache's layout here, outside the timed call."""
    ps = c.k_pages.shape[2]
    b, n_pages = table.shape
    ids = table.reshape(-1).long()
    src = []
    for x in (k, v):
        xp = x.new_zeros((b, n_pages * ps, *x.shape[2:]))
        xp[:, : x.shape[1]] = x
        src.append(xp.reshape(b * n_pages, ps, *x.shape[2:])
                   .permute(2, 0, 1, 3).contiguous())
    return lambda: (c.k_pages.index_copy_(1, ids, src[0]),
                    c.v_pages.index_copy_(1, ids, src[1]))


def put_rows(c, table, lens, new, k, v):
    """The appends' library call: index_put_ of the new rows k, v (b, sq,
    h, d) that the append stores (sequence i's first new[i], at positions
    lens[i] on within its table; none where lens[i] < 0), K then V, the
    indices made here. Returns (the call, the rows it stores)."""
    ps = c.k_pages.shape[2]
    t = torch.arange(k.shape[1], device=k.device)
    pos = lens.long()[:, None] + t
    live = (lens[:, None] >= 0) & (t < new[:, None]) \
        & (pos // ps < table.shape[1])
    b_idx, t_idx = live.nonzero(as_tuple=True)
    p = pos[b_idx, t_idx]
    idx = (torch.arange(k.shape[2], device=k.device)[:, None],
           table[b_idx, p // ps].long(), p % ps)
    kt, vt = (x[b_idx, t_idx].transpose(0, 1).contiguous() for x in (k, v))
    return (lambda: (c.k_pages.index_put_(idx, kt),
                     c.v_pages.index_put_(idx, vt)), len(p))


# name: (lengths after the step, new rows per sequence, sq, h, h_kv, d,
# pages_max) on 128-token pages: an engine chunk of GPT-2 (rows in their
# first to fourth chunk, short rows, a padding row) and of Llama-3-8B (GQA
# 32/8, head_dim 128), and speculative verification ([last, d1..d4]).
CHUNK_SHAPES = {
    "GPT-2 chunk": ([9, 200, 256, 300, 512, 777, 1000, 600],
                    [9, 200, 256, 44, 256, 9, 232, 0], 256, 12, 12, 64, 8),
    "Llama chunk": ([300, 512, 1024, 1500, 2048, 3000, 4000, 700],
                    [300, 512, 512, 476, 512, 440, 416, 188], 512, 32, 8,
                    128, 32),
    "verify": ([5, 6, 130, 500, 505, 1000, 17, 0],
               [5, 5, 5, 5, 5, 3, 5, 0], 5, 12, 12, 64, 8),
}
# The same for the appends' rows: chip_smoke.py's DECODE_SHAPES "GPT-2
# decode" and "Llama decode" (new rows None: one each) and verification.
APPEND_SHAPES = {
    "GPT-2 decode": ([1, 127, 128, 129, 400, 777, 1000, 0], None, 1, 12, 12,
                     64, 8),
    "Llama decode": ([300, 831, 1362, 1894, 2425, 2957, 3488, 4020], None, 1,
                     32, 8, 128, 32),
    "verify": CHUNK_SHAPES["verify"],
}


def paged_inputs(dev, shape):
    """APPEND_SHAPES[shape] or CHUNK_SHAPES[shape] in bf16 from
    torch.Generator seed 0: the cache (each sequence on its own pages in
    random order, page 0 never used), the page table, the lengths after the
    step and before it (``cache_lens``; a length 0 is an inactive slot,
    -1), the new rows' count (decode: None), and q, k, v as the serving
    path hands them over: views of GPT-2's fused projection where h ==
    h_kv, else Llama's separate contiguous projections; (b, h, d) at
    decode, (b, sq, h, d) otherwise."""
    from flash_attn_tpu_torch.serving import cache
    lengths, chunk, sq, h, h_kv, d, pages_max = {**CHUNK_SHAPES,
                                                 **APPEND_SHAPES}[shape]
    gen = torch.Generator(device=dev).manual_seed(0)
    ps, b = 128, len(lengths)
    need = [-(-n // ps) for n in lengths]
    pages = cache.init_cache(h_kv, 1 + sum(need), ps, d,
                             dtype=torch.bfloat16, device=dev)
    pages.k_pages.copy_(bf16_randn(gen, *pages.k_pages.shape))
    pages.v_pages.copy_(bf16_randn(gen, *pages.v_pages.shape))
    perm = torch.randperm(sum(need), generator=gen, device=dev) + 1
    table = torch.zeros((b, pages_max), dtype=torch.int32, device=dev)
    used = 0
    for i, n in enumerate(need):
        table[i, :n] = perm[used:used + n].to(torch.int32)
        used += n
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    rows = (b,) if chunk is None else (b, sq)
    if h == h_kv:
        q, k, v = bf16_randn(gen, *rows, 3, h, d).unbind(-3)
    else:
        q, k, v = (bf16_randn(gen, *rows, n, d) for n in (h, h_kv, h_kv))
    if chunk is None:
        return pages, table, lens, lens - 1, None, q, k, v
    new = torch.tensor(chunk, dtype=torch.int32, device=dev)
    return pages, table, lens, lens - new, new, q, k, v


def decode_work(q, kp, lens, table):
    """Bytes and tensor-core operations paged decode needs: the cached K and
    V of each active sequence read once, q read and out written for each
    active sequence (an inactive one's output is 0 by definition), the
    int32 tables; QK^T and PV over every cached key for each query head."""
    h, d = q.shape[1:]
    live, active = int(lens.clamp(min=0).sum()), int((lens > 0).sum())
    elem = q.element_size()
    return (2 * live * kp.shape[0] * d * elem + 2 * active * h * d * elem
            + nbytes(lens, table), 4 * live * h * d)


def chunk_work(shape, elem=2):
    """Bytes and tensor-core operations paged chunk attention needs on
    CHUNK_SHAPES[shape]: q read for each live row (a padding row's output
    is 0 by definition), out written for every row, the cached K and V of
    each sequence with a live row read once, the int32 tables; QK^T and PV
    over each live row's visible keys."""
    lengths, chunk_lens, sq, h, h_kv, d, pages_max = CHUNK_SHAPES[shape]
    keys = sum(n for n, c in zip(lengths, chunk_lens) if c > 0)
    pairs = sum(n - c + t + 1 for n, c in zip(lengths, chunk_lens)
                for t in range(c))
    rows = sum(chunk_lens) + len(lengths) * sq  # q read, out written
    n_bytes = (rows * h * d + 2 * keys * h_kv * d) * elem \
        + 4 * len(lengths) * (2 + pages_max)
    return n_bytes, 4 * pairs * h * d


def paged_rows(dev):
    """{row: Row} for the paged kernels: K6 alone at the GPT-2 and Llama
    chunk shapes; and at APPEND_SHAPES K7a or K7b alone (on contiguous
    rows, beside index_put_), K5 or K6 alone, the two-launch route as the
    serving path ran it before the append moved into the attention launch
    (the callers' .contiguous() copies, the append, the attention kernel),
    and that attention launch with the append (its plain side: the twins
    of the two-launch route; its bound adds each new row's read and
    write)."""
    from flash_attn_tpu_torch.kernels import chunk as k6
    from flash_attn_tpu_torch.kernels import decode as k5
    from flash_attn_tpu_torch.serving import cache
    rows = {}
    for shape in {**CHUNK_SHAPES, **APPEND_SHAPES}:
        c, table, lens, before, new, q, k, v = paged_inputs(dev, shape)
        kc, vc = k.contiguous(), v.contiguous()
        pages = (c.k_pages, c.v_pages)
        h_kv, d = k.shape[-2:]
        scale = d ** -0.5
        if new is None:
            work = decode_work(q, c.k_pages, lens, table)
            put, n_put = put_rows(c, table, before, torch.ones_like(lens),
                                  kc[:, None], vc[:, None])
            rows[f"K7a alone, {shape}"] = Row(
                functools.partial(cache.append_token, c, kc, vc, table,
                                  before),
                functools.partial(cache.append_token_plain, c, kc, vc, table,
                                  before),
                torch_call("index_put_ of token rows, K and V", put),
                4 * n_put * h_kv * d * 2 + nbytes(table, before))
            rows[f"K5 alone, {shape}"] = Row(
                functools.partial(k5.paged_decode_attention, q, *pages, lens,
                                  table),
                functools.partial(k5.paged_decode_attention_plain, q, *pages,
                                  lens, table, softmax_scale=scale),
                None, *work)
            rows[f"K7a + K5 (two launches, copies), {shape}"] = Row(
                lambda c=c, a=(q, k, v, table, lens, before): (
                    cache.append_token(c, a[1].contiguous(),
                                       a[2].contiguous(), a[3], a[5]),
                    k5.paged_decode_attention(a[0], c.k_pages, c.v_pages,
                                              a[4], a[3])))
            rows[f"K5 with the append, {shape}"] = Row(
                functools.partial(k5.paged_decode_with_append, q, k, v,
                                  *pages, before, table),
                lambda c=c, a=(q, k, v, table, before), s=scale: (
                    cache.append_token_plain(c, *a[1:]),
                    k5.paged_decode_attention_plain(
                        a[0], c.k_pages, c.v_pages,
                        (a[4].clamp(min=0) + 1).int(), a[3],
                        softmax_scale=s)),
                None, work[0] + 4 * len(lens) * h_kv * d * 2, work[1])
            continue
        work = chunk_work(shape)
        rows[f"K6 alone, {shape}"] = Row(
            functools.partial(k6.paged_chunk_attention, q, *pages, lens,
                              table, chunk_lens=new),
            functools.partial(k6.paged_chunk_attention_plain, q, *pages,
                              lens, table, chunk_lens=new,
                              softmax_scale=scale),
            None, *work)
        if shape not in APPEND_SHAPES:
            continue
        put, n_put = put_rows(c, table, before, new, kc, vc)
        rows[f"K7b alone, {shape}"] = Row(
            functools.partial(cache.append_span, c, kc, vc, table, before,
                              new),
            functools.partial(cache.append_span_plain, c, kc, vc, table,
                              before, new),
            torch_call("index_put_ of token rows, K and V", put),
            4 * n_put * h_kv * d * 2 + nbytes(table, before, new))
        rows[f"K7b + K6 (two launches, copies), {shape}"] = Row(
            lambda c=c, a=(q, k, v, table, lens, before, new): (
                cache.append_span(c, a[1].contiguous(), a[2].contiguous(),
                                  a[3], a[5], a[6]),
                k6.paged_chunk_attention(a[0].contiguous(), c.k_pages,
                                         c.v_pages, a[4], a[3],
                                         chunk_lens=a[6])))
        rows[f"K6 with the append, {shape}"] = Row(
            functools.partial(k6.paged_chunk_attention, q, *pages, lens,
                              table, chunk_lens=new, new_k=k, new_v=v,
                              cache_seqlens=before),
            lambda c=c, a=(q, k, v, table, before, new, lens), s=scale: (
                cache.append_span_plain(c, *a[1:6]),
                k6.paged_chunk_attention_plain(
                    a[0], c.k_pages, c.v_pages, a[6], a[3], chunk_lens=a[5],
                    softmax_scale=s)),
            None, work[0] + 4 * n_put * h_kv * d * 2, work[1])
    return rows


def k8b_inputs(dev):
    """{shape: (q, k, v, dout, layout, dropout_p)} at chip_smoke.py's
    BS_SHAPES (i) and (ii), bf16 (b, h, s, d): (i) from torch.Generator
    seed 0, (ii) config 4's q, k, v and 25% cell mask from numpy's
    default_rng(0), as the benchmark draws them."""
    from flash_attn_tpu_torch.kernels.blocksparse import build_layout
    from flash_attn_tpu_torch.models.blocksparse_modules import (
        LocalGlobalSparsityConfig,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    rng = np.random.default_rng(0)
    inputs = {}
    for shape, b, h, s, p in (("(i) GPT-2 train", 8, 12, 1024, 0.1),
                              ("(ii) config 4", 1, 8, 8192, 0.0)):
        if p:
            bm = LocalGlobalSparsityConfig(window=256).make_layout(s)
            q, k, v = (bf16_randn(gen, b, h, s, 64) for _ in range(3))
        else:
            q, k, v = (torch.from_numpy(rng.standard_normal(
                (b, s, h, 64))).to(dev, torch.bfloat16).transpose(1, 2)
                .contiguous() for _ in range(3))
            bm = rng.random((s // 16, s // 256)) < 0.25
        layout = build_layout(bm, sq=s, sk=s, causal=True)
        inputs[shape] = (q, k, v, bf16_randn(gen, b, h, s, 64), layout, p)
    return inputs


def k7c_k8_rows(dev):
    """{row: Row} for K7c (the paged page write) on k7c_inputs beside
    index_copy_, and for K8a, K8b and K8c (blocksparse forward, dK/dV and
    dQ) on k8b_inputs beside SDPA with the element mask as attn_mask (its
    forward, its backward for k, v and for q; K8b's and K8c's plain side
    is the whole plain backward), bound by operations over the visible
    pairs (4 d forward, 8 d dK/dV, 6 d dQ). The Llama chunk row writes the
    8 rows of one layer's chunk in one launch, on the next of its ROTATE
    input sets each call."""
    from flash_attn_tpu_torch.kernels.blocksparse import (
        blocksparse_attention_bwd_plain,
        blocksparse_attention_dkv,
        blocksparse_attention_dq,
        blocksparse_attention_fwd,
        blocksparse_attention_fwd_plain,
    )
    from flash_attn_tpu_torch.serving import cache
    gpt2, llama = k7c_inputs(dev)
    pages, k, v, ids = gpt2
    copy = "index_copy_ of pages, K and V"
    rows = {"K7c GPT-2 prompt, 768 tokens into 6 pages, h12 d64": Row(
        functools.partial(cache.write_prompt, *gpt2),
        functools.partial(cache.write_prompt_plain, *gpt2),
        torch_call(copy, copy_pages(pages, k[None], v[None], ids[None])),
        2 * nbytes(k, v) + nbytes(ids))}
    rows[f"K7c Llama chunk, 8 rows x 512 tokens, h_kv8 d128, one layer, "
         f"{ROTATE} input sets in turn"] = Row(
        rotating([functools.partial(cache._write_prompts, *x)
                  for x in llama]),
        rotating([functools.partial(cache._write_prompts_plain, *x)
                  for x in llama]),
        torch_call(copy, rotating([copy_pages(*x) for x in llama])),
        2 * nbytes(*llama[0][1:3]) + nbytes(llama[0][3]))
    for shape, (q, k, v, dout, layout, p) in k8b_inputs(dev).items():
        b, h, s, d = q.shape
        kw = dict(softmax_scale=d ** -0.5, dropout_p=p,
                  seed=1234 if p else None)
        out, lse = blocksparse_attention_fwd(q, k, v, layout, **kw)
        di = (out.float() * dout.float()).sum(-1)
        mask = layout.visible(dev)
        pairs = int(mask.sum()) * b * h
        lay = layout.on(dev)
        q_lists = nbytes(lay["q_indices"], lay["q_counts"], lay["q_full"],
                         lay["rowmask"])
        kv_lists = nbytes(lay["kv_indices"], lay["kv_counts"],
                          lay["kv_full"], lay["rowmask"])
        bwd = (q, k, v, dout, lse, di, layout)
        label = f"{shape} b{b} h{h} s{s} d{d}, dropout {p}"
        plain_bwd = functools.partial(blocksparse_attention_bwd_plain, *bwd,
                                      **kw)
        rows[f"K8a {label}"] = Row(
            functools.partial(blocksparse_attention_fwd, q, k, v, layout,
                              **kw),
            functools.partial(blocksparse_attention_fwd_plain, q, k, v,
                              layout, **kw),
            sdpa(q, k, v, p=p, mask=mask), nbytes(q, k, v, q, lse) + kv_lists,
            4 * pairs * d)
        rows[f"K8b {label}"] = Row(
            functools.partial(blocksparse_attention_dkv, *bwd, **kw),
            plain_bwd, sdpa(q, k, v, dout=dout, p=p, mask=mask, wrt="kv"),
            nbytes(q, k, v, dout, lse, di, k, v) + q_lists, 8 * pairs * d)
        rows[f"K8c {label}"] = Row(
            functools.partial(blocksparse_attention_dq, *bwd, **kw),
            plain_bwd, sdpa(q, k, v, dout=dout, p=p, mask=mask, wrt="q"),
            nbytes(q, k, v, dout, lse, di, q) + kv_lists, 6 * pairs * d)
    return rows


# The serving chain's kernels (kernels/llama_chain.py) at the widths of the
# two served models: Mistral-7B (longdoc's chunk of 8 x 512 tokens and its
# 64-row decode step) and Qwen3-30B-A3B (a 512-token chunk and turns'
# 32-row decode step: QK-norm, and SwiGLU on the halves of the routed
# experts' fused product, top-8 slots a token).
CHAIN_MODELS = {
    # model: (n_embd, n_head, n_kv_head, head_dim, rope_theta, rms_norm_eps,
    #         MLP width, experts per token (None: dense), {shape: (b, s)})
    "Mistral-7B": (4096, 32, 8, 128, 1e4, 1e-5, 14336, None,
                   {"chunk 8x512": (8, 512), "decode 64": (64, 1)}),
    "Qwen3-30B-A3B": (2048, 32, 4, 128, 1e6, 1e-6, 768, 8,
                      {"chunk 1x512": (1, 512), "decode 32": (32, 1)}),
}
CHAIN_KERNELS = ("add_rmsnorm", "qk_rope", "swiglu")


def chain_inputs(dev, model, b, s, seed):
    """One layer's chain operands of CHAIN_MODELS[model] for b x s tokens,
    bf16 from torch.Generator seed ``seed``: the residual and the pending
    sublayer output (b s, n_embd) with the norm weight, q (b, s, n_head,
    hd) and k (b, s, n_kv_head, hd) as views of one projection with
    positions to 7000 (with QK-norm weights where the model has them), and
    gate and up: two (b s, width) products, or for routed experts the
    halves gu[:, :I] and gu[:, I:] of one (b s top_k, 2 I) product."""
    from flash_attn_tpu_torch.kernels.llama_chain import rope_inv_freq
    e, h, h_kv, hd, theta, eps, width, top_k, _ = CHAIN_MODELS[model]
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = b * s
    qkv = bf16_randn(g, b, s, h + 2 * h_kv, hd)
    pos = (torch.randint(0, 7000 - s + 1, (b, 1), generator=g, device=dev)
           + torch.arange(s, device=dev))

    def weight(n):
        return (0.5 + torch.rand(n, generator=g, device=dev)).to(
            torch.bfloat16)

    if top_k is None:
        gate, up = bf16_randn(g, rows, width), bf16_randn(g, rows, width)
    else:
        gu = bf16_randn(g, rows * top_k, 2 * width)
        gate, up = gu[:, :width], gu[:, width:]
    return {"x": bf16_randn(g, rows, e), "d": bf16_randn(g, rows, e),
            "w": weight(e), "eps": eps,
            "q": qkv[:, :, :h], "k": qkv[:, :, h:h + h_kv], "pos": pos,
            "inv_freq": rope_inv_freq(hd, theta, dev),
            "norms": ((None, None) if top_k is None
                      else (weight(hd), weight(hd))),
            "gate": gate, "up": up}


def chain_calls(a, plain=False):
    """{kernel: (call, bytes it must move)} on chain_inputs ``a``."""
    from flash_attn_tpu_torch.kernels import llama_chain as m
    norm = m.add_rmsnorm_plain if plain else m.add_rmsnorm
    rope = m.qk_rope_plain if plain else m.qk_rope
    glu = m.swiglu_plain if plain else m.swiglu
    norms = [w for w in a["norms"] if w is not None]
    return {
        "add_rmsnorm": (lambda: norm(a["x"], a["d"], a["w"], a["eps"]),
                        4 * nbytes(a["x"]) + nbytes(a["w"])),
        "qk_rope": (lambda: rope(a["q"], a["k"], a["pos"], a["inv_freq"],
                                 *a["norms"], eps=a["eps"]),
                    2 * (a["q"].numel() + a["k"].numel()) * 2
                    + nbytes(a["pos"], a["inv_freq"], *norms)),
        "swiglu": (lambda: glu(a["gate"], a["up"]),
                   3 * nbytes(a["gate"])),
    }


def chain_rows(dev):
    """{row: Row} for the chain's kernels at every shape of CHAIN_MODELS,
    beside their twins, bound by bytes: a chunk's calls cycle through
    enough input sets that each kernel's operands over the sets are twice
    the L2, so that no call runs from it."""
    rows = {}
    for model, (*_, shapes) in CHAIN_MODELS.items():
        for shape, (b, s) in shapes.items():
            a = chain_inputs(dev, model, b, s, 0)
            least = min(n for _, n in chain_calls(a).values())
            n_sets = max(ROTATE, -(-2 * L2_BYTES // least)) if s > 1 else 1
            sets = [a] + [chain_inputs(dev, model, b, s, 1 + i)
                          for i in range(n_sets - 1)]
            kernel = [chain_calls(x) for x in sets]
            plain = [chain_calls(x, plain=True) for x in sets]
            for name in CHAIN_KERNELS:
                rows[f"chain {name} {model} {shape}, {n_sets} input sets"] = \
                    Row(rotating([c[name][0] for c in kernel]),
                        rotating([c[name][0] for c in plain]), None,
                        kernel[0][name][1])
    return rows


# Substrings of the blocksparse kernels' names in a trace (K8b's stats
# launch counts with K8b).
K8_KERNELS = {"K8a": ("bs_fwd",), "K8b": ("bs_dkv", "bs_stats"),
              "K8c": ("bs_dq",)}


def bs_train_step(dev, n_traced=2):
    """Device busy ms and K8a-c's device ms and share of ``n_traced``
    traced GPT-2 train steps through blocksparse attention: full
    GPT2Config(dropout=0.1) width, fp32 weights, bf16 compute, AdamW, one
    b=8 x s=1024 batch from numpy's default_rng(0), attn_impl = causal
    blocksparse_attention over LocalGlobalSparsityConfig(window=256) (the
    chip_smoke.py path); two untraced steps first."""
    from flash_attn_tpu_torch.kernels.blocksparse import build_layout
    from flash_attn_tpu_torch.models.blocksparse_modules import (
        LocalGlobalSparsityConfig,
    )
    from flash_attn_tpu_torch.models.gpt2 import (
        GPT2Config,
        GPT2LMHeadModel,
        make_train_step,
    )
    from flash_attn_tpu_torch.ops.blocksparse import blocksparse_attention
    cfg = GPT2Config(dropout=0.1)
    layout = build_layout(
        LocalGlobalSparsityConfig(window=256).make_layout(1024), sq=1024,
        sk=1024, causal=True)

    def attn(q, k, v, dropout_seed=None):
        return blocksparse_attention(
            q, k, v, layout, causal=True, dropout_seed=dropout_seed,
            dropout_p=0.0 if dropout_seed is None else cfg.dropout)
    model = GPT2LMHeadModel(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0),
        attn_impl=attn)
    step = make_train_step(model, torch.optim.AdamW(
        model.parameters(), lr=1e-4, weight_decay=1e-4))
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 1024))).to(dev)
    batch = {"input_ids": ids, "labels": ids}
    gen = torch.Generator().manual_seed(0)
    for _ in range(2):
        step(batch, gen)
    steps = []
    for _ in range(n_traced):
        _, _, events = trace_call(lambda: step(batch, gen))
        dev_events = device_events(events)
        total = sum(e["dur"] for e in dev_events)
        k8 = {name: sum(e["dur"] for e in dev_events
                        if any(key in e["name"] for key in keys)) / 1e3
              for name, keys in K8_KERNELS.items()}
        steps.append({"busy_ms": union_us(dev_events) / 1e3,
                      "k8_ms": k8, "k8_share": sum(k8.values()) * 1e3 / total})
    return steps


# Substrings of GEMM kernel names, and the ops whose kernels are GEMMs.
GEMM_KERNELS = ("gemm", "gemv", "cutlass", "nvjet", "xmma", "sm90_")
GEMM_OPS = ("aten::addmm", "aten::mm", "aten::linear", "aten::matmul")


def decode_window(engine, n_steps, warmup=3):
    """``n_steps`` engine steps (every slot decoding) traced after
    ``warmup`` untraced ones: device busy ms, launches (device events),
    busy ms and wall ms per step, the idle share of the GPU span, K5's
    and the standalone K7a's launches, and the copy kernels between each
    K5 launch and the GEMM before it (the layer's qkv projection), with
    the names of the kernels seen there; then the host wall ms per step of
    ``n_steps`` untraced steps."""
    for _ in range(warmup):
        engine.step()
    torch.cuda.synchronize()
    wall, _, events = trace_call(
        lambda: [engine.step() for _ in range(n_steps)])
    ops = {e["args"]["External id"]: e["name"] for e in events
           if e.get("cat") == "cpu_op" and "External id" in e.get("args", {})}
    dev = sorted(device_events(events), key=lambda e: e["ts"])

    def op(e):
        return ops.get(e.get("args", {}).get("External id"), "")

    def is_gemm(e):
        return op(e) in GEMM_OPS or any(
            k in e["name"].lower() for k in GEMM_KERNELS)

    k5 = [i for i, e in enumerate(dev) if "paged_decode" in e["name"]]
    copies, between = 0, set()
    for i in k5:
        j = i - 1
        while j >= 0 and not is_gemm(dev[j]):
            name = dev[j]["name"]
            between.add(name[:80])
            copies += "copy" in (name + op(dev[j])).lower() \
                or op(dev[j]) in ("aten::contiguous", "aten::clone")
            j -= 1
    busy = union_us(dev)
    span = dev[-1]["ts"] + dev[-1]["dur"] - dev[0]["ts"]
    t0 = time.perf_counter()
    for _ in range(n_steps):
        engine.step()
    torch.cuda.synchronize()
    untraced = (time.perf_counter() - t0) * 1e3 / n_steps
    return {"steps": n_steps, "busy_ms": busy / 1e3,
            "busy_ms_per_step": busy / 1e3 / n_steps,
            "launches_per_step": len(dev) / n_steps,
            "idle_share": 1 - busy / span,
            "wall_ms_per_step_traced": wall / n_steps,
            "wall_ms_per_step": untraced,
            "k5_launches": len(k5),
            "k7a_launches": sum("append_token" in e["name"] for e in dev),
            "copies_before_k5": copies,
            "between_gemm_and_k5": sorted(between)}


def serve_admission(dev):
    """K1's launches and device ms per launch and K7c's launches and device
    ms in one traced GPT-2 admission of 8 prompts, the admission's device
    busy ms, and the median host ms of three untraced admissions (time to
    first token); then ``decode_window`` over 16 decode steps of a fresh
    admission of the same prompts."""
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
    _, _, events = trace_call(lambda eng: eng._admit(), setup=engine)
    dev_events = device_events(events)
    k1 = [e["dur"] for e in dev_events if "flash_fwd" in e["name"]]
    k7c = [e["dur"] for e in dev_events if "write_pages" in e["name"]]
    copies = sum(e["dur"] for e in dev_events
                 if "copy" in (e.get("cat", "") + e["name"]).lower())
    eng = engine()
    eng._admit()
    return {"k1_launches": len(k1),
            "k1_ms_per_launch": sum(k1) / max(len(k1), 1) / 1e3,
            "k7c_launches": len(k7c), "k7c_ms": sum(k7c) / 1e3,
            "busy_ms": union_us(dev_events) / 1e3,
            "copies_ms": copies / 1e3,
            "ttft_ms_median": statistics.median(walls),
            "decode": decode_window(eng, 16)}


def llama_admission(dev):
    """K7c's launches and device ms, and the device busy ms, of one traced
    chunked admission of 8 prompts (300..4000 tokens, chunks of 512) at
    Llama-3-8B's widths (meta-llama/Meta-Llama-3-8B config.json) cut to
    LLAMA_LAYERS layers, bf16, random weights from seed 0; then
    ``decode_window`` over 4 decode steps of that engine."""
    from flash_attn_tpu_torch.models import llama_decode
    from flash_attn_tpu_torch.models.llama import (
        LlamaConfig,
        LlamaForCausalLM,
    )
    from flash_attn_tpu_torch.serving.engine import ServingEngine
    cfg = LlamaConfig(
        vocab_size=128256, n_layer=LLAMA_LAYERS, n_embd=4096, n_head=32,
        n_kv_head=8, intermediate_size=14336, rope_theta=500000.0,
        max_position_embeddings=8192, rms_norm_eps=1e-5,
        dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    model = LlamaForCausalLM(
        cfg, device=dev, generator=torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in np.linspace(300, 4000, 8).astype(int)]
    held = {}

    def engine():
        held["engine"] = None  # free the last one's caches first
        held["engine"] = ServingEngine(
            model, cfg, model_fns=llama_decode, max_batch=8, page_size=128,
            pages_per_seq=32, num_pages=8 * 32 + 1, prefill_chunk=512)
        for p in prompts:
            held["engine"].submit(p, max_new_tokens=1000)
        torch.cuda.synchronize()
        return held["engine"]

    engine()._admit()  # cuBLAS handles, the allocator
    _, _, events = trace_call(lambda eng: eng._admit(), setup=engine)
    dev_events = device_events(events)
    k7c = [e["dur"] for e in dev_events if "write_pages" in e["name"]]
    busy = union_us(dev_events)
    return {"n_layer": LLAMA_LAYERS, "k7c_launches": len(k7c),
            "k7c_ms": sum(k7c) / 1e3,
            "k7c_ms_per_launch": sum(k7c) / max(len(k7c), 1) / 1e3,
            "k7c_share": sum(k7c) / sum(e["dur"] for e in dev_events),
            "busy_ms": busy / 1e3,
            "decode": decode_window(held["engine"], 4)}


def time_row(name, row, warm_s):
    """busy_ms twice and host_ms of ``row``'s call, and where it has them
    its plain twin, its library call and its bound; prints and returns the
    record."""
    rec = {"busy_ms": [busy_ms(row.call, warm_s=warm_s),
                       busy_ms(row.call, warm_s=warm_s)],
           "host_ms": host_ms(row.call)}
    line = (f"{name}: device busy {rec['busy_ms'][0]:.4f} / "
            f"{rec['busy_ms'][1]:.4f} ms, host {rec['host_ms']:.4f} ms per "
            "call")
    if row.plain is not None:
        rec["plain_ms"] = busy_ms(row.plain, n=3, warm_s=warm_s)
        line += f"; plain {rec['plain_ms']:.4f} ms"
    if row.library is not None:
        rec["library_ms"], rec["library"] = row.library()
        line += f"; library {rec['library_ms']:.4f} ms ({rec['library']})"
    if row.n_bytes or row.flops:
        rec["bound_ms"], rec["bound_by"] = bound(row.n_bytes, row.flops)
        line += (f"; bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}: "
                 f"{row.n_bytes / 1e6:.1f} MB, {row.flops / 1e9:.2f} GFLOP)")
    print(line, flush=True)
    return rec


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repo", default=os.path.dirname(
        os.path.abspath(__file__)), help="checkout whose kernels are timed")
    parser.add_argument("--warm-s", type=float, default=WARM_S,
                        help="seconds of calls before each trace")
    parser.add_argument("--rows", default="", metavar="PREFIX",
                        help="time only the rows whose names start with "
                        "PREFIX (e.g. K8, or K5,K6,K7 for several), and skip "
                        "the admissions, the decode windows and the train "
                        "step")
    args = parser.parse_args()
    repo, warm_s = os.path.abspath(args.repo), args.warm_s
    if not torch.cuda.is_available():
        sys.exit("dense_timing.py needs a CUDA card")
    sys.path.insert(0, repo)
    import flash_attn_tpu_torch as pkg
    if os.path.dirname(os.path.dirname(os.path.abspath(pkg.__file__))) != repo:
        sys.exit(f"imported {pkg.__file__}, not the package under {repo}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    from flash_attn_tpu_torch.kernels import _build
    _build.lib()
    build_s = time.perf_counter() - t0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    rows = {}
    for make_rows in (dense_rows, segment_rows, paged_rows, k7c_k8_rows,
                    window_rows, chain_rows):
        for name, row in make_rows(dev).items():
            if name.startswith(tuple(args.rows.split(","))):
                rows[name] = time_row(name, row, warm_s)
        torch.cuda.empty_cache()
    admission = llama = bs_steps = None
    if not args.rows:
        admission = serve_admission(dev)
        print(f"GPT-2 admission of 8: {admission}")
        llama = llama_admission(dev)
        print(f"Llama-3-8B widths, {llama['n_layer']} layers, chunked "
              f"admission of 8: {llama}")
        bs_steps = bs_train_step(dev)
        print(f"GPT-2 blocksparse train step, traced: {bs_steps}")
    print(json.dumps({"repo": repo, "card": card, "warm_s": warm_s,
                      "build_s": build_s,
                      "rows": rows, "admission": admission,
                      "llama_admission": llama,
                      "blocksparse_train_step": bs_steps}))


if __name__ == "__main__":
    main()
