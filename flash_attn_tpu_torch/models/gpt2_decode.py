"""GPT-2 serving phases against the paged KV cache (port of
``flash_attn_tpu/models/gpt2_decode.py``).

  - ``prefill``: the prompts through the flash-attention forward (K1),
    returning each layer's K/V for the cache pages and the logits of each
    prompt's last token.
  - ``chunk_prefill_step``: one page-aligned chunk of every prompt; each
    layer writes the chunk's pages (K7c) and attends to the cache through
    multi-token paged attention (K6).
  - ``decode_step``: one token per sequence; each layer appends its K/V to
    the paged cache (K7a) and attends through paged decode attention (K5).

Numerics. The JAX package's parameters are fp32 (``param_dtype``) and its
``_dense`` multiplies a bf16 activation by an fp32 kernel, which JAX
promotes to fp32: its "bf16" serving runs the projections and both
attention kernels in fp32, and only the KV cache and the residual stream
in bf16. This port stores the weights in ``cfg.dtype`` and feeds the
kernels that dtype, so with ``cfg.dtype = bf16`` everything but LayerNorm
and the LM head runs in bf16. The parity tests against JAX therefore run
with ``cfg.dtype = float32``, where the two packages compute the same
thing; in bf16 on the card the path is held to the 2x rule and to teacher
forcing against ``GPT2LMHeadModel``, not to the JAX bf16 output.
"""

from __future__ import annotations

from typing import Sequence

import torch

from flash_attn_tpu_torch.kernels.chunk import paged_chunk_attention
from flash_attn_tpu_torch.kernels.decode import paged_decode_attention
from flash_attn_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.serving.cache import (
    PagedKVCache,
    append_token,
    write_prompt,
)


@torch.no_grad()
def prefill(model: GPT2LMHeadModel, cfg: GPT2Config, input_ids,
            lengths=None):
    """Run a batch of prompts (b, s). Returns (logits of each prompt's last
    token (b, vocab) fp32, per-layer k/v lists [(b, s, n_head, head_dim)],
    contiguous).

    ``lengths`` (b,) enables batched prefill of unequal prompts padded to a
    shared bucket: logits are taken at position lengths - 1 per row, and
    rows past a prompt's length are padding whose k/v must not be read."""
    b, s = input_ids.shape
    x = model.embed(input_ids, torch.arange(s, device=input_ids.device))
    ks, vs = [], []
    for block in model.h:
        q, k, v = block.qkv(x)
        ks.append(k.contiguous())
        vs.append(v.contiguous())
        ctx = flash_attention(q, k, v, causal=True)
        x = block.finish(x, ctx.reshape(b, s, cfg.n_embd))
    if lengths is None:
        last = x[:, -1]
    else:
        idx = (lengths.long() - 1).clamp(0, s - 1).to(x.device)
        last = x[torch.arange(b, device=x.device), idx]
    return model.lm_head(last), ks, vs


@torch.no_grad()
def chunk_prefill_step(model: GPT2LMHeadModel, cfg: GPT2Config,
                       caches: Sequence[PagedKVCache], input_ids, pos0,
                       chunk_lens, write_tbl, page_table):
    """One chunk of chunked prefill for every row: per layer, the chunk's
    K/V go to its page span (K7c, one ``write_prompt`` per row), then the
    chunk attends to the cache, earlier chunks included (K6).

    ``input_ids`` (b, C) this chunk's tokens; ``pos0`` (b,) int32 tokens
    already cached (a page_size multiple); ``chunk_lens`` (b,) int32 valid
    rows (0 = a padding row, whose ``write_tbl`` row names the scratch page
    0); ``write_tbl`` (b, C / page_size) the chunk's page ids;
    ``page_table`` (b, pages_max). Updates the caches in place and returns
    (logits (b, vocab) fp32 at each row's last valid chunk token, caches);
    a row whose prompt does not end in this chunk gets logits the caller
    ignores."""
    b, C = input_ids.shape
    pos = (pos0.long()[:, None] + torch.arange(C, device=pos0.device)
           ).clamp(0, cfg.max_position_embeddings - 1)
    x = model.embed(input_ids, pos)
    total = (pos0.clamp(min=0) + chunk_lens).to(torch.int32)
    for block, cache in zip(model.h, caches):
        q, k, v = block.qkv(x)  # (b, C, n_head, head_dim)
        k, v = k.contiguous(), v.contiguous()
        for r in range(b):
            write_prompt(cache, k[r], v[r], write_tbl[r])
        ctx = paged_chunk_attention(q, cache.k_pages,
                                    cache.v_pages, total, page_table,
                                    chunk_lens=chunk_lens)
        x = block.finish(x, ctx.reshape(b, C, cfg.n_embd))
    idx = (chunk_lens.long() - 1).clamp(0, C - 1)
    last = x[torch.arange(b, device=x.device), idx]
    return model.lm_head(last), caches


@torch.no_grad()
def decode_step(model: GPT2LMHeadModel, cfg: GPT2Config,
                caches: Sequence[PagedKVCache], page_table, lengths,
                token_ids):
    """One decode step for every slot. ``page_table`` (b, pages_max) and
    ``lengths`` (b,) int32 (tokens already cached; < 0 = inactive slot,
    still computed, its cache write redirected to the scratch page),
    ``token_ids`` (b,) the token at position ``lengths``. Updates the
    caches in place and returns (logits (b, vocab) fp32, caches)."""
    b = token_ids.shape[0]
    x = model.embed(
        token_ids, lengths.long().clamp(0, cfg.max_position_embeddings - 1))
    ctx_len = (lengths.clamp(min=0) + 1).to(torch.int32)
    for block, cache in zip(model.h, caches):
        q, k, v = block.qkv(x)  # (b, n_head, head_dim)
        # Raw lengths: append_token redirects inactive slots itself.
        append_token(cache, k.contiguous(), v.contiguous(), page_table,
                     lengths)
        ctx = paged_decode_attention(q, cache.k_pages,
                                     cache.v_pages, ctx_len, page_table)
        x = block.finish(x, ctx.reshape(b, cfg.n_embd))
    return model.lm_head(x), caches
