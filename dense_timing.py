"""Device time of a call on one CUDA card, and the redesigned kernels' rows.

    python3 dense_timing.py [--repo DIR] [--rows PREFIX]

As a module it holds how chip_smoke.py times a call: ``busy_ms``, the
device busy time of one call in a profiler trace (the union of its kernel,
memcpy and memset intervals, so the gaps the host leaves between launches
do not count), and ``host_ms``, the host time to issue one call. On a card
whose host issues a call more slowly than the shortest kernels run, CUDA
events around back-to-back calls time the host, not the card.

As a script it times the flash_attn_tpu_torch package of the checkout at
DIR (default: the one holding this file): K1 (flash_attention_fwd), K2
(flash_attention_bwd), both also in segment form where the checkout has
it (BERT's padding masks, and the same batch packed as one sequence), K7c (the paged page write, GPT-2's prompt and one
layer of Llama-3-8B's chunk, the latter on four input sets in turn so that
it cannot run from L2), K8a, K8b and K8c (blocksparse forward, dK/dV
and dQ), and the cache appends at GPT-2's and Llama-3-8B's decode shapes
and at verification (APPEND_SHAPES: K7a or K7b alone, K5 or K6 alone, the
two-launch route with the copies its callers made, and, where the
checkout has it, the attention kernel with the append in its launch) at
the rows of PERF.md's table, each by busy_ms and host_ms; one
GPT-2 admission of 8 prompts (9..700 tokens, bucket 768) through
ServingEngine, traced for K1's and K7c's launches and device time, with the
median host time of three untraced admissions, then 16 decode steps of it
traced (decode_window: device busy ms, launches and wall ms per step, idle
share, and the copy kernels between each layer's projection and K5); one
chunked admission of 8 prompts at Llama-3-8B's widths cut to 4 layers,
traced for K7c's launches and device time, then 4 of its decode steps
traced the same way; and two traced GPT-2 train steps through blocksparse
attention (full width, b=8, s=1024, the LocalGlobal(256) mask), for their
device busy time and K8a-c's share of it; and the sliding-window rows
("W ..."; where the checkout has the window): K1 and K2 at Mistral-7B's
train step (b=2 h=32/8 s=8192 d=128, window 4096) and K5 and K6 at its
decode and chunked-prefill shapes (MISTRAL_DECODE, MISTRAL_CHUNK), each
with and without the window on the same tensors. To
compare two commits by the same method, unpack the other one with `git
archive` into a git-ignored directory and run both in one session on the
card (other, this, this, other). Needs a CUDA card; prints one JSON line.
"""

from __future__ import annotations

import argparse
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
# Layers of the Llama-3-8B admission the script traces: K7c's launches and
# time grow with the depth, so a cut depth shows the change at 1/8 the
# cost of building the full model.
LLAMA_LAYERS = 4
# Host-side calls that put work on the card, by their names in the trace.
LAUNCHES = ("Launch", "Memset", "Memcpy")
# Trace event categories of work on the card.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


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


def bf16_randn(gen, *shape):
    return torch.randn(shape, generator=gen, device=gen.device).to(
        torch.bfloat16)


def dense_rows(fwd, bwd, dev):
    """{row: call} for K1 and K2 at PERF.md's rows, on contiguous bf16
    (b, h, s, d) inputs from torch.Generator seed 0."""
    gen = torch.Generator(device=dev).manual_seed(0)
    randn = functools.partial(bf16_randn, gen)
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


# Mistral-7B-v0.1's attention: 32 query heads over 8 kv heads of d 128,
# sliding_window 4096; its train step's b x s, and the decode and chunked
# prefill (8 sequences, contexts 1000..7000, page 128) of the serving phase.
MISTRAL_TRAIN = (2, 32, 8, 8192, 128)
MISTRAL_WINDOW = 4096
MISTRAL_DECODE = [int(x) for x in np.linspace(1000, 7000, 8)]
MISTRAL_CHUNK = 512


def band_pairs(sq: int, sk: int, left: int) -> int:
    """Visible (query, key) pairs of causal attention with a left window:
    row i sees keys [max(0, i - left), min(i, sk - 1)]."""
    i = np.arange(sq)
    return int((np.minimum(i, sk - 1) - np.maximum(0, i - left) + 1).clip(
        min=0).sum())


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
    """{row: call} for the window rows ("W ..."), each kernel with the
    window and without it on the same tensors; empty where the checkout
    has no window."""
    from flash_attn_tpu_torch.kernels import common
    if not hasattr(common, "Band"):
        return {}
    from flash_attn_tpu_torch.kernels.chunk import paged_chunk_attention
    from flash_attn_tpu_torch.kernels.decode import paged_decode_attention
    from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
    from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd
    (q, k, v, dout, o, lse), dec, chk = window_inputs(dev)
    b, h, h_kv, s, d = MISTRAL_TRAIN
    train = f"Mistral train b{b} h{h}/{h_kv} s{s} d{d}"
    kw = dict(causal=True, softmax_scale=d ** -0.5)
    rows = {}
    for label, band in ((f"window {MISTRAL_WINDOW}",
                         common.Band(MISTRAL_WINDOW)),
                        ("no window", common.NO_BAND)):
        rows[f"W K1 {train}, {label}, lse"] = functools.partial(
            flash_attention_fwd, q, k, v, save_lse=True, band=band, **kw)
        rows[f"W K2 {train}, {label}"] = functools.partial(
            flash_attention_bwd, q, k, v, o, dout, lse, band=band, **kw)
    qd, pages, lens, table = dec
    qc, _, _, _, chunk = chk
    shape = f"b{len(MISTRAL_DECODE)} h{h}/{h_kv} d{d} contexts " \
        f"{MISTRAL_DECODE[0]}..{MISTRAL_DECODE[-1]}"
    for label, window in ((f"window {MISTRAL_WINDOW}", MISTRAL_WINDOW),
                          ("no window", None)):
        rows[f"W K5 Mistral decode {shape}, {label}"] = functools.partial(
            paged_decode_attention, qd, pages.k_pages, pages.v_pages, lens,
            table, window_left=window)
        rows[f"W K6 Mistral chunk sq{MISTRAL_CHUNK} {shape}, {label}"] = (
            functools.partial(paged_chunk_attention, qc, pages.k_pages,
                              pages.v_pages, lens, table, chunk_lens=chunk,
                              window_left=window))
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


def segment_rows(fwd, bwd, dev, b=32, s=512):
    """{row: call} for K1 and K2 in segment form, where the checkout has it:
    at BERT's attention shape (b32 h12 s512 d64, bert_padding, dropout 0.1,
    lse; K1's calls make their tile plan, K2's reuse one) beside the same
    kernels with no mask and in segment form with every token real (the
    plan lists every tile, all full: the segment form's own cost), and on
    the same batch packed as one super-sequence (b1, the 32 sequences back
    to back: the cu_seqlens interface's layout), bf16 from
    torch.Generator seed 0."""
    import inspect
    if "segments" not in inspect.signature(fwd).parameters:
        return {}
    from flash_attn_tpu_torch.kernels.common import Segments
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
        rows[f"K1 {label}, segments"] = (
            lambda a=args, seg=seg: fwd(*a[:3], save_lse=True,
                                        segments=Segments(*seg), **kw))
        rows[f"K2 {label}, segments"] = (
            lambda a=args, o=o, lse=lse, plan=plan: bwd(
                *a[:3], o, a[3], lse, segments=plan, **kw))
        if "padding" in label:
            real = (torch.zeros_like(seg[0]),) * 2 + seg[2:]
            rows[f"K1 {label}, segments, all tokens real"] = (
                lambda a=args, seg=real: fwd(*a[:3], save_lse=True,
                                             segments=Segments(*seg), **kw))
            od, lsed = fwd(*args[:3], save_lse=True, **kw)
            rows[f"K1 {label}, no mask"] = (
                lambda a=args: fwd(*a[:3], save_lse=True, **kw))
            rows[f"K2 {label}, no mask"] = (
                lambda a=args, o=od, lse=lsed: bwd(*a[:3], o, a[3], lse,
                                                   **kw))
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


# name: (lengths after the step's append, chunk rows or None for decode,
# sq, h, h_kv, d, pages_max): chip_smoke.py's DECODE_SHAPES "GPT-2 decode"
# and "Llama decode" and CHUNK_SHAPES "verify", on 128-token pages.
APPEND_SHAPES = {
    "GPT-2 decode": ([1, 127, 128, 129, 400, 777, 1000, 0], None, 1, 12, 12,
                     64, 8),
    "Llama decode": ([300, 831, 1362, 1894, 2425, 2957, 3488, 4020], None, 1,
                     32, 8, 128, 32),
    "verify": ([5, 6, 130, 500, 505, 1000, 17, 0], [5, 5, 5, 5, 5, 3, 5, 0],
               5, 12, 12, 64, 8),
}


def append_inputs(dev, shape):
    """APPEND_SHAPES[shape] in bf16 from torch.Generator seed 0: the cache
    (each sequence on its own pages in random order, page 0 never used),
    the page table, the lengths after the append and before it
    (``cache_lens``; a length 0 is an inactive slot, -1), the new rows'
    count (decode: None), and q, k, v as the serving path hands them over:
    views of GPT-2's fused projection where h == h_kv, else Llama's
    separate contiguous projections; (b, h, d) at decode, (b, sq, h, d) at
    verification."""
    from flash_attn_tpu_torch.serving import cache
    lengths, chunk, sq, h, h_kv, d, pages_max = APPEND_SHAPES[shape]
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


def append_rows(dev):
    """{row: call} for the cache appends at APPEND_SHAPES: K7a or K7b
    alone (on contiguous rows, which every checkout takes), K5 or K6 alone,
    the two-launch route as the serving path ran it before the append moved
    into the attention launch (the callers' .contiguous() copies, the
    append, the attention kernel), and that attention launch with the
    append, where the checkout has it."""
    from flash_attn_tpu_torch.kernels import chunk as k6
    from flash_attn_tpu_torch.kernels import decode as k5
    from flash_attn_tpu_torch.serving import cache
    fused_k5 = getattr(k5, "paged_decode_with_append", None)
    fused_k6 = "cache_seqlens" in k6.paged_chunk_attention.__code__.co_varnames
    rows = {}
    for shape in APPEND_SHAPES:
        c, table, lens, before, new, q, k, v = append_inputs(dev, shape)
        kc, vc = k.contiguous(), v.contiguous()
        pages = (c.k_pages, c.v_pages)
        if new is None:
            rows[f"K7a alone, {shape}"] = functools.partial(
                cache.append_token, c, kc, vc, table, before)
            rows[f"K5 alone, {shape}"] = functools.partial(
                k5.paged_decode_attention, q, *pages, lens, table)
            rows[f"K7a + K5 (two launches, copies), {shape}"] = (
                lambda c=c, a=(q, k, v, table, lens, before): (
                    cache.append_token(c, a[1].contiguous(),
                                       a[2].contiguous(), a[3], a[5]),
                    k5.paged_decode_attention(a[0], c.k_pages, c.v_pages,
                                              a[4], a[3])))
            if fused_k5 is not None:
                rows[f"K5 with the append, {shape}"] = functools.partial(
                    fused_k5, q, k, v, *pages, before, table)
            continue
        rows[f"K7b alone, {shape}"] = functools.partial(
            cache.append_span, c, kc, vc, table, before, new)
        rows[f"K6 alone, {shape}"] = functools.partial(
            k6.paged_chunk_attention, q, *pages, lens, table, chunk_lens=new)
        rows[f"K7b + K6 (two launches, copies), {shape}"] = (
            lambda c=c, a=(q, k, v, table, lens, before, new): (
                cache.append_span(c, a[1].contiguous(), a[2].contiguous(),
                                  a[3], a[5], a[6]),
                k6.paged_chunk_attention(a[0].contiguous(), c.k_pages,
                                         c.v_pages, a[4], a[3],
                                         chunk_lens=a[6])))
        if fused_k6:
            rows[f"K6 with the append, {shape}"] = functools.partial(
                k6.paged_chunk_attention, q, *pages, lens, table,
                chunk_lens=new, new_k=k, new_v=v, cache_seqlens=before)
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
    """{row: call} for K7c (the paged page write) on k7c_inputs, and for
    K8a, K8b and K8c (blocksparse forward, dK/dV and dQ) on k8b_inputs. The
    Llama chunk row writes the 8 rows of one layer's chunk as the
    checkout's chunked prefill does (one batched launch, or one
    write_prompt per row where the checkout has no batched write), on the
    next of its ROTATE input sets each call."""
    from flash_attn_tpu_torch.kernels.blocksparse import (
        blocksparse_attention_dkv,
        blocksparse_attention_dq,
        blocksparse_attention_fwd,
    )
    from flash_attn_tpu_torch.serving import cache
    gpt2, llama = k7c_inputs(dev)
    rows = {"K7c GPT-2 prompt, 768 tokens into 6 pages, h12 d64":
            functools.partial(cache.write_prompt, *gpt2)}

    def per_row(pages, k, v, tbl):
        for r in range(k.shape[0]):
            cache.write_prompt(pages, k[r], v[r], tbl[r])
    write = getattr(cache, "_write_prompts", per_row)
    rows[f"K7c Llama chunk, 8 rows x 512 tokens, h_kv8 d128, one layer, "
         f"{ROTATE} input sets in turn"] = rotating(
        [functools.partial(write, *inputs) for inputs in llama])
    for shape, (q, k, v, dout, layout, p) in k8b_inputs(dev).items():
        b, h, s, d = q.shape
        kw = dict(softmax_scale=d ** -0.5, dropout_p=p,
                  seed=1234 if p else None)
        out, lse = blocksparse_attention_fwd(q, k, v, layout, **kw)
        di = (out.float() * dout.float()).sum(-1)
        label = f"{shape} b{b} h{h} s{s} d{d}, dropout {p}"
        rows[f"K8a {label}"] = (
            lambda a=(q, k, v, layout), kw=kw:
                blocksparse_attention_fwd(*a, **kw))
        bwd = (q, k, v, dout, lse, di, layout)
        rows[f"K8b {label}"] = (
            lambda a=bwd, kw=kw: blocksparse_attention_dkv(*a, **kw))
        rows[f"K8c {label}"] = (
            lambda a=bwd, kw=kw: blocksparse_attention_dq(*a, **kw))
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
    for name, fn in {**dense_rows(flash_attention_fwd, flash_attention_bwd,
                                  dev),
                      **segment_rows(flash_attention_fwd, flash_attention_bwd,
                                     dev),
                      **k7c_k8_rows(dev), **append_rows(dev),
                      **window_rows(dev)}.items():
        if not name.startswith(tuple(args.rows.split(","))):
            continue
        rows[name] = {"busy_ms": [busy_ms(fn, warm_s=warm_s),
                                  busy_ms(fn, warm_s=warm_s)],
                      "host_ms": host_ms(fn)}
        print(f"{name}: device busy {rows[name]['busy_ms'][0]:.4f} / "
              f"{rows[name]['busy_ms'][1]:.4f} ms, host "
              f"{rows[name]['host_ms']:.4f} ms per call", flush=True)
    admission = llama = bs_steps = None
    if not args.rows:
        admission = serve_admission(dev)
        print(f"GPT-2 admission of 8: {admission}")
        llama = llama_admission(dev)
        print(f"Llama-3-8B widths, {llama['n_layer']} layers, chunked "
              f"admission of 8: {llama}")
        bs_steps = bs_train_step(dev)
        print(f"GPT-2 blocksparse train step, traced: {bs_steps}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({"repo": repo, "card": card, "warm_s": warm_s,
                      "build_s": build_s,
                      "rows": rows, "admission": admission,
                      "llama_admission": llama,
                      "blocksparse_train_step": bs_steps}))


if __name__ == "__main__":
    main()
