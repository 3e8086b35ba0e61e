"""Llama serving phases against the paged KV cache (port of
``flash_attn_tpu/models/llama_decode.py``).

The three phases the serving engine drives, with the contracts of
``gpt2_decode``: ``prefill`` (K1), ``chunk_prefill_step`` (K7c + K6) and
``decode_step`` (K5 with K7a's append, one launch). Rotary is applied at
each token's global position BEFORE the cache write, so the cache holds
post-rotary keys and decode never rotates history; GQA rides the kernels'
group axis. As in the port's GPT-2 serving, the projections compute in
``cfg.dtype`` (the JAX package promotes a bf16 activation times its fp32
kernel to fp32), so the parity tests run fp32 and the bf16 path is held to
the 2x rule on the card. ``cfg.window`` bands prefill, chunks and decode
alike; ``cfg.window_sinks`` adds StreamingLLM sinks in decode only
(llama_decode.py:185-186 there), so prefill and training keep the pure
band.

Spans (``tracing``): ``llama.chunk_prefill_step`` and ``llama.decode_step``
around each call, ending when its last launch is queued. None per layer:
under a running profiler, the only time a span costs anything, three
spans a layer added ~3.5 ms to a Mistral-7B decode step of ~73 ms and
~10 ms to a chunk's issue (H100 host).
"""

from __future__ import annotations

from typing import Sequence

import torch

from flash_attn_tpu_torch import tracing
from flash_attn_tpu_torch.kernels.chunk import paged_chunk_attention
from flash_attn_tpu_torch.kernels.decode import paged_decode_with_append
from flash_attn_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    window_size,
)
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
    x = model.embed(input_ids)
    ks, vs = [], []
    for block in model.layers:
        q, k, v = block.qkv(x, positions)
        ks.append(k.contiguous())
        vs.append(v.contiguous())
        ctx = flash_attention(q, k, v, causal=True,
                              window_size=window_size(cfg))
        x = block.finish(x, ctx.flatten(2))
    idx = (torch.full((b,), s, device=x.device) if lengths is None
           else lengths.long().to(x.device)) - 1
    return model.logits(_last(x, idx.clamp(0, s - 1))), ks, vs


@torch.no_grad()
def chunk_prefill_step(model: LlamaForCausalLM, cfg: LlamaConfig,
                       caches: Sequence[PagedKVCache], input_ids, pos0,
                       chunk_lens, write_tbl, page_table):
    """One chunk of chunked prefill (contract: ``gpt2_decode
    .chunk_prefill_step``). Rotary uses the global positions pos0 + t, so
    chunked and single-shot prefill compute the same keys."""
    with tracing.span("llama.chunk_prefill_step"):
        b, C = input_ids.shape
        positions = pos0.long().clamp(min=0)[:, None] + torch.arange(
            C, device=pos0.device)
        x = model.embed(input_ids)
        total = (pos0.clamp(min=0) + chunk_lens).to(torch.int32)
        for block, cache in zip(model.layers, caches):
            q, k, v = block.qkv(x, positions)
            _write_prompts(cache, k, v, write_tbl)  # one K7c launch
            ctx = paged_chunk_attention(q, cache.k_pages,
                                        cache.v_pages, total, page_table,
                                        chunk_lens=chunk_lens,
                                        window_left=cfg.window)
            x = block.finish(x, ctx.flatten(2))
        idx = (chunk_lens.long() - 1).clamp(0, C - 1)
        return model.logits(_last(x, idx)), caches


@torch.no_grad()
def decode_step(model: LlamaForCausalLM, cfg: LlamaConfig,
                caches: Sequence[PagedKVCache], page_table, lengths,
                token_ids):
    """One decode step for every slot (contract: ``gpt2_decode
    .decode_step``). Returns (logits (b, vocab) fp32, caches)."""
    with tracing.span("llama.decode_step"):
        positions = lengths.long().clamp(min=0)[:, None]  # (b, 1)
        x = model.embed(token_ids[:, None])  # (b, 1, e)
        for block, cache in zip(model.layers, caches):
            q, k, v = block.qkv(x, positions)  # (b, 1, h, hd)
            # One launch appends k, v (raw lengths: inactive slots go to
            # the scratch page) and attends over the cache with them.
            ctx = paged_decode_with_append(q[:, 0], k[:, 0], v[:, 0],
                                           cache.k_pages, cache.v_pages,
                                           lengths, page_table,
                                           window_left=cfg.window,
                                           num_sinks=cfg.window_sinks)
            x = block.finish(x, ctx.flatten(1)[:, None])
        return model.logits(x[:, 0]), caches
