"""Speculative decoding for GPT-2 on the paged KV cache (port of the
JAX package's ``examples/speculative_decode.py``).

Draft and verify: the first ``draft_layers`` layers of the same model (a
stand-in for a small draft model) propose ``k`` tokens greedily through
dense flash attention (K1); the whole model scores ``[last, d1..dk]`` in
one pass, each layer appending the chunk's K/V and attending to the cache
through ``flash_attn_with_kvcache`` (one K6 launch that appends first),
and keeps the longest draft prefix that agrees with its own greedy choice,
plus that choice. In exact arithmetic the output equals plain greedy decoding.
With ``cfg.window`` both passes attend through the band; ``window_sinks``
(decode-only) is refused, since the draft and the chunk scoring see no sinks.

Rejected drafts leave K/V in the slots after the accepted ones; the next
round's chunk starts at the first of those slots and overwrites them before
any query attends to them.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.models import gpt2_decode
from flash_attn_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from flash_attn_tpu_torch.serving.cache import init_cache, write_prompt
from flash_attn_tpu_torch.serving.kvcache import flash_attn_with_kvcache


@torch.no_grad()
def draft_greedy(model: GPT2LMHeadModel, n_layer: int, ids: list[int]
                 ) -> int:
    """Greedy next token from the first ``n_layer`` layers (the draft)."""
    dev = model.wte.weight.device
    x = model.embed(torch.tensor([ids], device=dev),
                    torch.arange(len(ids), device=dev))
    for block in model.h[:n_layer]:
        x = block(x)
    return int(model.lm_head(x[0, -1]).argmax())


@torch.no_grad()
def score_chunk(model: GPT2LMHeadModel, cfg: GPT2Config, caches, table,
                chunk: list[int], pos0: int):
    """Teacher-force ``chunk`` (the tokens at positions pos0.., K/V not yet
    cached) against the cached prefix of one sequence whose page table is
    ``table`` (1, pages_max). Updates the caches in place and returns fp32
    logits (len(chunk), vocab): row t predicts the token after chunk[t]."""
    dev = table.device
    n = len(chunk)
    x = model.embed(torch.tensor([chunk], device=dev),
                    pos0 + torch.arange(n, device=dev))
    seqlens = torch.tensor([pos0], dtype=torch.int32, device=dev)
    for block, cache in zip(model.h, caches):
        q, k, v = block.qkv(x)  # (1, n, n_head, head_dim) views
        ctx, _ = flash_attn_with_kvcache(q, cache, table, seqlens, k, v,
                                         window_left=cfg.window)
        x = block.finish(x, ctx.reshape(1, n, cfg.n_embd))
    return model.lm_head(x[0])


@torch.no_grad()
def speculative_decode(model: GPT2LMHeadModel, cfg: GPT2Config,
                       prompt: list[int], new_tokens: int, *, k: int = 4,
                       draft_layers: int | None = None,
                       page_size: int = 128):
    """Greedy speculative decoding of ``new_tokens`` after ``prompt``.
    Returns (the generated tokens, the verify rounds as (pos0, chunk,
    logits) with ``score_chunk``'s logits)."""
    if cfg.window_sinks:
        raise ValueError("speculative_decode: window_sinks are decode-only, "
                         "and the draft and the chunk scoring see none; "
                         "decode a model with sinks step by step")
    dev = model.wte.weight.device
    if draft_layers is None:
        draft_layers = cfg.n_layer // 2
    n_pages = -(-(len(prompt) + new_tokens + k + 2) // page_size)
    caches = [init_cache(cfg.n_kv_heads, 1 + n_pages, page_size,
                         cfg.head_dim, dtype=cfg.dtype, device=dev)
              for _ in range(cfg.n_layer)]
    table = torch.arange(1, 1 + n_pages, dtype=torch.int32, device=dev)[None]
    logits, ks, vs = gpt2_decode.prefill(model, cfg,
                                         torch.tensor([prompt], device=dev))
    for cache, kk, vv in zip(caches, ks, vs):
        write_prompt(cache, kk[0], vv[0],
                     table[0, : -(-len(prompt) // page_size)])
    ids = list(prompt) + [int(logits[0].argmax())]
    generated = ids[len(prompt):]
    cached = len(prompt)  # tokens whose K/V are in the pages
    rounds = []
    while len(generated) < new_tokens:
        drafts = []
        for _ in range(k):
            drafts.append(draft_greedy(model, draft_layers, ids + drafts))
        chunk = ids[cached:] + drafts  # [last, d1..dk]
        logits = score_chunk(model, cfg, caches, table, chunk, cached)
        rounds.append((cached, chunk, logits))
        greedy = logits.argmax(-1).tolist()
        n_acc = 0
        while n_acc < k and drafts[n_acc] == greedy[n_acc]:
            n_acc += 1
        cached += 1 + n_acc
        for t in drafts[:n_acc] + [greedy[n_acc]]:
            if len(generated) < new_tokens:
                ids.append(t)
                generated.append(t)
    return generated, rounds
