"""Llama serving phases against the paged KV cache (port of
``flash_attn_tpu/models/llama_decode.py``).

The three phases the serving engine drives, with the contracts of
``gpt2_decode``: ``prefill`` (K1), ``chunk_prefill_step`` (K7c + K6) and
``decode_step`` (K5 with K7a's append, one launch). With
``cfg.num_experts`` each block's MLP is routed experts (``models/moe.py``),
told which tokens are live: a chunk's tokens within ``chunk_lens``, a
decode slot's with ``lengths`` >= 0, a prefill row's within ``lengths``;
the rest route to no expert. Rotary is applied at
each token's global position BEFORE the cache write, so the cache holds
post-rotary keys and decode never rotates history; GQA rides the kernels'
group axis. As in the port's GPT-2 serving, the projections compute in
``cfg.dtype`` (the JAX package promotes a bf16 activation times its fp32
kernel to fp32), so the parity tests run fp32 and the bf16 path is held to
the 2x rule on the card. ``cfg.window`` bands prefill, chunks and decode
alike; ``cfg.window_sinks`` adds StreamingLLM sinks in decode only
(llama_decode.py:185-186 there), so prefill and training keep the pure
band.

The elementwise chain around the products is three kernels
(``kernels/llama_chain.py``), each reading its inputs once: every phase
loop carries the residual stream and the pending MLP output of the layer
before, which ``LlamaBlock.qkv`` adds in the launch of its input norm
(``add_rmsnorm``) and the final norm adds for the rows the logits are
taken at; ``qk_rope`` applies QK-norm (``cfg.qk_norm``) and rotary to q
and k in place from the positions and ``LlamaForCausalLM.rope_inv_freq``
(no per-layer tables); ``LlamaBlock.finish`` adds the attention's output
in the launch of the post-attention norm, and the MLP's SwiGLU is one
launch (``swiglu``; on the routed experts' strided halves too). A layer
launches two norms, one rotary and one SwiGLU; on the CPU each is its
plain twin, the op-by-op chain it replaces.

CUDA graphs. ``chunk_prefill_step`` and ``decode_step`` replay a CUDA
graph of their whole call when every tensor argument and cache is on one
CUDA device; CPU inputs run the eager body as they always have. Issued
eagerly, a Mistral-7B decode step or a 1-2-row chunk was ~50 launches a
layer before the chain's kernels, and the host's ~58 ms of launching
outlasted the device's 20-35 ms of work; a replay launches the whole
call at once. The graphs of a model live
in ``_GRAPHS`` (weakly keyed by the model) under a signature: the phase,
the device, ``cfg``, the shape and dtype of every tensor argument, each
layer's ``k_pages`` / ``v_pages`` storage (address, shape, dtype) and the
address of every parameter. New caches (a new engine) or weights that
moved (a new parameter, or new data under one) capture anew, and the old
graphs are dropped, so no graph replays into freed pages or stale
weights. The parameters' places are looked up once per set of graphs and
their addresses read on every call (on the H100 machine's host 0.065 ms
for Mistral-7B's 291 parameters, 0.118 ms for Qwen3-30B-A3B's 531); a
submodule replaced whole is not seen. Weights updated in place
(``copy_``) are read by the graphs as they are.

The first call of a signature copies its arguments into the graph's own
static buffers, runs the eager body once on a side stream (the call's
result, and its cache writes), then captures the body into the graph
(all of a model's graphs share one memory pool); a later call copies its
arguments into those buffers on the card and replays. Capture executes
nothing, so the caches end as eager calls leave them. **The logits a
graphed call returns are the graph's static output: they hold until the
next call of that phase with the same signature**; clone them to keep
them longer (the engine samples them before its next call). The pages
are written in place, and ``caches`` comes back as given. Every kernel
on the path sizes its launch from shapes (the lengths stay on the card)
and launches on the current stream without synchronizing, so a replay
runs the same kernels on the same operands as the eager body: the
logits and the pages match it bit for bit (card tests). The launch
counters (``paged_decode_with_append.launches``,
``paged_chunk_attention.launches`` / ``.append_launches``,
``_write_prompts.launches``, the experts' ``grouped_mm.launches``, the
chain's ``add_rmsnorm`` / ``qk_rope`` / ``swiglu.launches``) grow on a
replay by what the eager body adds, and the capture adds nothing to
them.

Spans (``tracing``): ``llama.chunk_prefill_step`` and ``llama.decode_step``
around each call, ending when its last launch is queued; inside them
``llama.graph_capture`` around a first call's warm-up and capture, and
``llama.graph_replay`` around a replay (its input copies included). None
per layer: under a running profiler, the only time a span costs
anything, three spans a layer added ~3.5 ms to a Mistral-7B decode step
of ~73 ms and ~10 ms to a chunk's issue (H100 host).
"""

from __future__ import annotations

import weakref
from typing import Sequence

import torch

from flash_attn_tpu_torch import tracing
from flash_attn_tpu_torch.kernels.chunk import paged_chunk_attention
from flash_attn_tpu_torch.kernels.decode import paged_decode_with_append
from flash_attn_tpu_torch.kernels.llama_chain import (
    add_rmsnorm,
    qk_rope,
    swiglu,
)
from flash_attn_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    window_size,
)
from flash_attn_tpu_torch.models.moe import grouped_mm
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.serving.cache import (
    PagedKVCache,
    _write_prompts,
)


def _last(x, idx):
    """x (b, s, e) at one position per row."""
    return x[torch.arange(x.shape[0], device=x.device), idx]


@torch.no_grad()
def prefill(model: LlamaForCausalLM, cfg: LlamaConfig, input_ids,
            lengths=None):
    """(b, s) prompts -> (fp32 logits of each prompt's last token (b,
    vocab), per-layer k/v lists [(b, s, n_kv_head, hd)], post-rotary and
    contiguous). ``lengths``: see ``gpt2_decode.prefill``."""
    b, s = input_ids.shape
    positions = torch.arange(s, device=input_ids.device).expand(b, s)
    inv_freq = model.rope_inv_freq(positions.device)
    x, d = model.embed(input_ids), None
    live = None
    if cfg.num_experts and lengths is not None:
        live = positions < lengths.to(positions.device)[:, None]
    ks, vs = [], []
    for block in model.layers:
        x, q, k, v = block.qkv(x, d, positions, inv_freq)
        ks.append(k.contiguous())
        vs.append(v.contiguous())
        ctx = flash_attention(q, k, v, causal=True,
                              window_size=window_size(cfg))
        x, d = block.finish(x, ctx.flatten(2), live)
    idx = ((torch.full((b,), s, device=x.device) if lengths is None
            else lengths.long().to(x.device)) - 1).clamp(0, s - 1)
    return model.logits(_last(x, idx), _last(d, idx)), ks, vs


@torch.no_grad()
def chunk_prefill_step(model: LlamaForCausalLM, cfg: LlamaConfig,
                       caches: Sequence[PagedKVCache], input_ids, pos0,
                       chunk_lens, write_tbl, page_table):
    """One chunk of chunked prefill (contract: ``gpt2_decode
    .chunk_prefill_step``). Rotary uses the global positions pos0 + t, so
    chunked and single-shot prefill compute the same keys. On the card
    the call replays a CUDA graph, and the logits hold until the next
    chunk of the same shapes (module docstring)."""
    with tracing.span("llama.chunk_prefill_step"):
        logits = _call("chunk_prefill_step", _chunk_body, model, cfg, caches,
                       (input_ids, pos0, chunk_lens, write_tbl, page_table))
        return logits, caches


@torch.no_grad()
def _chunk_body(model, cfg, caches, input_ids, pos0, chunk_lens, write_tbl,
                page_table):
    """``chunk_prefill_step`` issued launch by launch: the logits."""
    b, C = input_ids.shape
    positions = pos0.long().clamp(min=0)[:, None] + torch.arange(
        C, device=pos0.device)
    inv_freq = model.rope_inv_freq(positions.device)
    x, d = model.embed(input_ids), None
    total = (pos0.clamp(min=0) + chunk_lens).to(torch.int32)
    live = (torch.arange(C, device=x.device) < chunk_lens[:, None]
            if cfg.num_experts else None)
    for block, cache in zip(model.layers, caches):
        x, q, k, v = block.qkv(x, d, positions, inv_freq)
        _write_prompts(cache, k, v, write_tbl)  # one K7c launch
        ctx = paged_chunk_attention(q, cache.k_pages, cache.v_pages, total,
                                    page_table, chunk_lens=chunk_lens,
                                    window_left=cfg.window)
        x, d = block.finish(x, ctx.flatten(2), live)
    idx = (chunk_lens.long() - 1).clamp(0, C - 1)
    return model.logits(_last(x, idx), _last(d, idx))


@torch.no_grad()
def decode_step(model: LlamaForCausalLM, cfg: LlamaConfig,
                caches: Sequence[PagedKVCache], page_table, lengths,
                token_ids):
    """One decode step for every slot (contract: ``gpt2_decode
    .decode_step``). Returns (logits (b, vocab) fp32, caches). On the card
    the call replays a CUDA graph, and the logits hold until the next
    decode step of the same shapes (module docstring)."""
    with tracing.span("llama.decode_step"):
        logits = _call("decode_step", _decode_body, model, cfg, caches,
                       (page_table, lengths, token_ids))
        return logits, caches


@torch.no_grad()
def _decode_body(model, cfg, caches, page_table, lengths, token_ids):
    """``decode_step`` issued launch by launch: the logits."""
    positions = lengths.long().clamp(min=0)[:, None]  # (b, 1)
    inv_freq = model.rope_inv_freq(positions.device)
    x, d = model.embed(token_ids[:, None]), None  # (b, 1, e)
    live = (lengths >= 0)[:, None] if cfg.num_experts else None
    for block, cache in zip(model.layers, caches):
        x, q, k, v = block.qkv(x, d, positions, inv_freq)  # (b, 1, h, hd)
        # One launch appends k, v (raw lengths: inactive slots go to the
        # scratch page) and attends over the cache with them.
        ctx = paged_decode_with_append(q[:, 0], k[:, 0], v[:, 0],
                                       cache.k_pages, cache.v_pages,
                                       lengths, page_table,
                                       window_left=cfg.window,
                                       num_sinks=cfg.window_sinks)
        x, d = block.finish(x, ctx.flatten(1)[:, None], live)
    return model.logits(x[:, 0], d[:, 0])


# ------------------------------------------------------------ CUDA graphs

# The launch counters of the kernels the phases run (chip_smoke.py's
# launch tables read them).
_COUNTERS = ((paged_decode_with_append, "launches"),
             (paged_chunk_attention, "launches"),
             (paged_chunk_attention, "append_launches"),
             (_write_prompts, "launches"),
             (grouped_mm, "launches"),
             (add_rmsnorm, "launches"),
             (qk_rope, "launches"),
             (swiglu, "launches"))


def _counts() -> list[int]:
    return [getattr(f, name) for f, name in _COUNTERS]


class _Graph:
    """One captured call: its static inputs and output, and how much each
    launch counter grows per call."""

    __slots__ = ("graph", "inputs", "out", "grown")

    def __init__(self, graph, inputs, out, grown):
        self.graph, self.inputs, self.out, self.grown = \
            graph, inputs, out, grown

    def replay(self, args):
        for static, a in zip(self.inputs, args):
            static.copy_(a)
        self.graph.replay()
        for (f, name), n in zip(_COUNTERS, self.grown):
            setattr(f, name, getattr(f, name) + n)
        return self.out


def _weight_slots(model) -> list:
    """[(module, name)] of every parameter of ``model``."""
    return [(m, n) for m in model.modules()
            for n, p in m._parameters.items() if p is not None]


def _weights(slots) -> tuple:
    """The address of each parameter at ``slots``."""
    return tuple(m._parameters[n].data_ptr() for m, n in slots)


class _Graphs:
    """A model's graphs over one set of caches and one placement of its
    weights: one memory pool, one side stream for the warm-ups, the graphs
    by signature."""

    def __init__(self, model, storage, device):
        self.slots = _weight_slots(model)
        self.weights = _weights(self.slots)
        self.storage = storage
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.by_sig: dict = {}

    def capture(self, body, model, cfg, caches, args):
        """The eager warm-up on the side stream, then the capture, both
        reading the static inputs. Returns (the graph, the warm-up's
        logits)."""
        inputs = [torch.empty(a.shape, dtype=a.dtype, device=a.device)
                  for a in args]
        for static, a in zip(inputs, args):
            static.copy_(a)
        current = torch.cuda.current_stream(args[0].device)
        self.stream.wait_stream(current)
        with torch.cuda.stream(self.stream):
            logits = body(model, cfg, caches, *inputs)
        current.wait_stream(self.stream)
        before = _counts()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool):
            out = body(model, cfg, caches, *inputs)
        grown = [a - b for a, b in zip(_counts(), before)]
        for (f, name), n in zip(_COUNTERS, before):
            setattr(f, name, n)  # the capture launched nothing
        return _Graph(graph, inputs, out, grown), logits


# model -> _Graphs; an entry dies with its model.
_GRAPHS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def _signature(phase, cfg, caches, args):
    """(storage, sig): the caches' storage (each layer's page addresses,
    shape and dtype), which a model's graphs share, and the call's key
    among them (the phase, the device, ``cfg``, each argument's shape and
    dtype)."""
    storage = tuple((c.k_pages.data_ptr(), c.v_pages.data_ptr(),
                     c.k_pages.shape, c.k_pages.dtype) for c in caches)
    sig = (phase, args[0].device, cfg,
           tuple((a.shape, a.dtype) for a in args))
    return storage, sig


def _call(phase, body, model, cfg, caches, args):
    """``body(model, cfg, caches, *args)``'s logits: eager unless every
    tensor is on one CUDA device, else from the signature's graph,
    captured on its first call."""
    dev = args[0].device
    if dev.type != "cuda" or any(a.device != dev for a in args) or any(
            c.k_pages.device != dev or c.v_pages.device != dev
            for c in caches):
        return body(model, cfg, caches, *args)
    storage, sig = _signature(phase, cfg, caches, args)
    graphs = _GRAPHS.get(model)
    if graphs is None or graphs.storage != storage or \
            graphs.weights != _weights(graphs.slots):
        graphs = _GRAPHS[model] = _Graphs(model, storage, dev)
    graph = graphs.by_sig.get(sig)
    if graph is None:
        with tracing.span("llama.graph_capture"):
            graph, logits = graphs.capture(body, model, cfg, caches, args)
        graphs.by_sig[sig] = graph
        return logits
    with tracing.span("llama.graph_replay"):
        return graph.replay(args)
