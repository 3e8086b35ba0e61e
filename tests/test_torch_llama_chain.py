"""The fused elementwise chain of the Llama serving phases
(``kernels/llama_chain.py``: ``add_rmsnorm``, ``qk_rope``, ``swiglu``), on
the CPU, where each wrapper runs its plain twin.

- The phases (prefill, a chunk, a decode step) of a tiny Mistral-like
  (window) and Qwen3-like (QK-norm, head_dim apart from n_embd / n_head,
  routed experts) model give the logits and pages of the op-by-op chain
  they replace, written out below as it stood: bit for bit in fp32 and in
  bf16.
- The carried (residual, pending MLP output) form gives the plain
  residual stream layer by layer.
- The wrappers refuse inputs that require grad, and the training step
  never calls them; the serving phases call each once or twice a layer.
The kernels themselves run on the card (``tests/test_torch_kernels.py``).
"""

import numpy as np
import pytest
import torch

from flash_attn_tpu_torch.kernels import llama_chain
from flash_attn_tpu_torch.models import llama as llama_module
from flash_attn_tpu_torch.models import llama_decode
from flash_attn_tpu_torch.models import moe as moe_module
from flash_attn_tpu_torch.models.gpt2 import tied_logits
from flash_attn_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    make_train_step,
    window_size,
)
from flash_attn_tpu_torch.models.modules import linear
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.serving import cache as torch_cache

PS, PMAX = 16, 6  # pages of 16 tokens, 96 a sequence

CONFIGS = {
    "mistral-like": dict(window=24),
    "qwen3-like": dict(head_dim=64, qk_norm=True, num_experts=8,
                       num_experts_per_tok=2, moe_intermediate_size=48,
                       norm_topk_prob=True, rope_theta=1e6,
                       rms_norm_eps=1e-6),
}
_models = {}


def model_of(name, dtype=torch.float32):
    key = (name, dtype)
    if key not in _models:
        cfg = LlamaConfig.tiny(**CONFIGS[name], dtype=dtype,
                               param_dtype=dtype)
        model = LlamaForCausalLM(
            cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        with torch.no_grad():  # norm weights away from ones
            g = torch.Generator().manual_seed(1)
            for n, p in model.named_parameters():
                if n.endswith("norm.weight"):
                    p.copy_(0.5 + torch.rand(p.shape, generator=g))
        _models[key] = cfg, model
    return _models[key]


# ----------------------------------- the op-by-op chain, as it stood


def plain_qkv(block, x, positions):
    return block.attn.qkv(block.input_layernorm(x), positions)


def plain_finish(block, x, ctx, live):
    cfg = block.config
    x = x + linear(ctx, block.attn.o_proj, cfg.dtype)
    h = block.post_attention_layernorm(x)
    return x + (block.mlp(h, live) if cfg.num_experts else block.mlp(h))


def plain_logits(model, x):
    return tied_logits(model.norm(x), model.lm_head.weight,
                       model.config.dtype)


def _last(x, idx):
    return x[torch.arange(x.shape[0]), idx]


@torch.no_grad()
def plain_prefill(model, cfg, input_ids, lengths):
    b, s = input_ids.shape
    positions = torch.arange(s).expand(b, s)
    x = model.embed(input_ids)
    live = positions < lengths[:, None] if cfg.num_experts else None
    ks, vs = [], []
    for block in model.layers:
        q, k, v = plain_qkv(block, x, positions)
        ks.append(k.contiguous())
        vs.append(v.contiguous())
        ctx = flash_attention(q, k, v, causal=True,
                              window_size=window_size(cfg))
        x = plain_finish(block, x, ctx.flatten(2), live)
    idx = (lengths.long() - 1).clamp(0, s - 1)
    return plain_logits(model, _last(x, idx)), ks, vs


@torch.no_grad()
def plain_chunk(model, cfg, caches, input_ids, pos0, chunk_lens, write_tbl,
                page_table):
    b, C = input_ids.shape
    positions = pos0.long().clamp(min=0)[:, None] + torch.arange(C)
    x = model.embed(input_ids)
    total = (pos0.clamp(min=0) + chunk_lens).to(torch.int32)
    live = (torch.arange(C) < chunk_lens[:, None]
            if cfg.num_experts else None)
    for block, cache in zip(model.layers, caches):
        q, k, v = plain_qkv(block, x, positions)
        torch_cache._write_prompts(cache, k, v, write_tbl)
        ctx = llama_decode.paged_chunk_attention(
            q, cache.k_pages, cache.v_pages, total, page_table,
            chunk_lens=chunk_lens, window_left=cfg.window)
        x = plain_finish(block, x, ctx.flatten(2), live)
    idx = (chunk_lens.long() - 1).clamp(0, C - 1)
    return plain_logits(model, _last(x, idx))


@torch.no_grad()
def plain_decode(model, cfg, caches, page_table, lengths, token_ids):
    positions = lengths.long().clamp(min=0)[:, None]
    x = model.embed(token_ids[:, None])
    live = (lengths >= 0)[:, None] if cfg.num_experts else None
    for block, cache in zip(model.layers, caches):
        q, k, v = plain_qkv(block, x, positions)
        ctx = llama_decode.paged_decode_with_append(
            q[:, 0], k[:, 0], v[:, 0], cache.k_pages, cache.v_pages, lengths,
            page_table, window_left=cfg.window, num_sinks=cfg.window_sinks)
        x = plain_finish(block, x, ctx.flatten(1)[:, None], live)
    return plain_logits(model, x[:, 0])


# ------------------------------------------------------------ inputs


def caches(cfg, rows, seed=0):
    g = torch.Generator().manual_seed(seed)
    shape = (cfg.n_kv_head, 1 + rows * PMAX, PS, cfg.head_dim)
    return [torch_cache.PagedKVCache(
        torch.randn(shape, generator=g).to(cfg.dtype),
        torch.randn(shape, generator=g).to(cfg.dtype))
        for _ in range(cfg.n_layer)]


def clone(cs):
    return [torch_cache.PagedKVCache(c.k_pages.clone(), c.v_pages.clone())
            for c in cs]


def int32(xs):
    return torch.tensor(xs, dtype=torch.int32)


def table(rows, rng):
    return torch.from_numpy((1 + rng.permutation(rows * PMAX)).reshape(
        rows, PMAX).astype(np.int32))


def chunk_args(cfg, rng, rows=3, width=32):
    """A chunk at pos0 32 or 48; the last row is padding."""
    tbl = table(rows, rng)
    pos0 = rng.choice([32, 48], rows)
    cl = rng.integers(1, width + 1, rows)
    cl[-1] = 0
    ids = rng.integers(0, cfg.vocab_size, (rows, width))
    ids[np.arange(width)[None] >= cl[:, None]] = 0
    wtbl = torch.stack([tbl[i, p // PS:p // PS + width // PS]
                        for i, p in enumerate(pos0)])
    wtbl[-1] = 0
    return (torch.from_numpy(ids), int32(pos0.tolist()), int32(cl.tolist()),
            wtbl.contiguous(), tbl)


def decode_args(cfg, rng, rows=4):
    """A decode step; the last slot is free (length -1)."""
    lens = rng.integers(1, PMAX * PS - 1, rows)
    lens[-1] = -1
    return (table(rows, rng), int32(lens.tolist()),
            torch.from_numpy(rng.integers(0, cfg.vocab_size, rows)))


# ------------------------------------------------------------- tests

CASES = [(name, dtype) for name in CONFIGS
         for dtype in (torch.float32, torch.bfloat16)]
IDS = [f"{n}-{str(d).split('.')[-1]}" for n, d in CASES]


@pytest.mark.parametrize("name, dtype", CASES, ids=IDS)
def test_prefill_is_the_plain_chain(name, dtype):
    cfg, model = model_of(name, dtype)
    rng = np.random.default_rng(2)
    ids = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 40)))
    lengths = int32([40, 23])
    logits, ks, vs = llama_decode.prefill(model, cfg, ids, lengths)
    want, wks, wvs = plain_prefill(model, cfg, ids, lengths)
    assert torch.equal(logits, want)
    for a, b in zip(ks + vs, wks + wvs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name, dtype", CASES, ids=IDS)
def test_chunk_is_the_plain_chain(name, dtype):
    cfg, model = model_of(name, dtype)
    args = chunk_args(cfg, np.random.default_rng(3))
    mine = caches(cfg, 3)
    theirs = clone(mine)
    logits, out = llama_decode.chunk_prefill_step(model, cfg, mine, *args)
    want = plain_chunk(model, cfg, theirs, *args)
    assert out is mine
    assert torch.equal(logits, want)
    for a, b in zip(mine, theirs):
        assert torch.equal(a.k_pages[:, 1:], b.k_pages[:, 1:])
        assert torch.equal(a.v_pages[:, 1:], b.v_pages[:, 1:])


@pytest.mark.parametrize("name, dtype", CASES, ids=IDS)
def test_decode_is_the_plain_chain(name, dtype):
    cfg, model = model_of(name, dtype)
    args = decode_args(cfg, np.random.default_rng(4))
    mine = caches(cfg, 4, seed=1)
    theirs = clone(mine)
    logits, _ = llama_decode.decode_step(model, cfg, mine, *args)
    want = plain_decode(model, cfg, theirs, *args)
    assert torch.equal(logits, want)
    for a, b in zip(mine, theirs):
        assert torch.equal(a.k_pages[:, 1:], b.k_pages[:, 1:])
        assert torch.equal(a.v_pages[:, 1:], b.v_pages[:, 1:])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_carried_residual_is_the_plain_stream(name):
    """Layer by layer, the carried x + d is the training forward's
    residual stream (``LlamaBlock.forward``) bit for bit."""
    cfg, model = model_of(name)
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 33)))
    positions = torch.arange(33).expand(2, 33)
    inv_freq = model.rope_inv_freq(positions.device)
    with torch.no_grad():
        plain = x = model.embed(ids)
        d = None
        for block in model.layers:
            plain = block(plain, positions)
            x, q, k, v = block.qkv(x, d, positions, inv_freq)
            ctx = flash_attention(q, k, v, causal=True,
                                  window_size=window_size(cfg))
            x, d = block.finish(x, ctx.flatten(2))
            assert torch.equal(x + d, plain)


def test_first_norm_without_pending_returns_the_stream_itself():
    x = torch.randn(3, 5, 16)
    w = torch.rand(16) + 0.5
    res, h = llama_chain.add_rmsnorm(x, None, w, 1e-5)
    assert res is x
    assert torch.equal(h, llama_chain.rms_norm_plain(x, w, 1e-5, x.dtype))


def test_qk_rope_is_in_place_and_matches_the_tables():
    """The twin rotates q and k in place with the per-layer tables'
    values (``llama_rope_tables`` + ``apply_llama_rope``)."""
    g = torch.Generator().manual_seed(6)
    q, k = torch.randn(2, 7, 4, 32, generator=g), torch.randn(2, 7, 2, 32,
                                                             generator=g)
    positions = torch.randint(0, 7000, (2, 7), generator=g)
    cos, sin = llama_module.llama_rope_tables(positions, 32, 1e4)
    want = (llama_chain.apply_llama_rope(q, cos, sin),
            llama_chain.apply_llama_rope(k, cos, sin))
    got = llama_chain.qk_rope(q, k, positions,
                              llama_chain.rope_inv_freq(32, 1e4, "cpu"))
    assert got[0] is q and got[1] is k
    assert torch.equal(q, want[0]) and torch.equal(k, want[1])


def _grad_calls():
    x = torch.randn(4, 32, requires_grad=True)
    w = torch.rand(32)
    q = torch.randn(1, 4, 2, 32, requires_grad=True)
    k = torch.randn(1, 4, 1, 32)
    pos = torch.arange(4)[None]
    return {
        "add_rmsnorm": lambda: llama_chain.add_rmsnorm(x, None, w, 1e-5),
        "qk_rope": lambda: llama_chain.qk_rope(
            q, k, pos, llama_chain.rope_inv_freq(32, 1e4, "cpu")),
        "swiglu": lambda: llama_chain.swiglu(x, x.detach()),
    }


@pytest.mark.parametrize("name", ["add_rmsnorm", "qk_rope", "swiglu"])
def test_wrappers_refuse_inputs_that_require_grad(name):
    call = _grad_calls()[name]
    with pytest.raises(RuntimeError, match="forward-only"):
        call()
    with torch.no_grad():
        call()  # no backward wanted: runs


@pytest.fixture
def spies(monkeypatch):
    """Each fused wrapper, where the models call it, wrapped to count its
    calls."""
    calls = {"add_rmsnorm": 0, "qk_rope": 0, "swiglu": 0}

    def spy(name):
        fn = getattr(llama_chain, name)

        def counted(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return counted

    for mod in (llama_module, moe_module):
        for name in calls:
            if hasattr(mod, name):
                monkeypatch.setattr(mod, name, spy(name))
    return calls


@pytest.mark.parametrize("name", list(CONFIGS))
def test_training_step_never_calls_a_fused_wrapper(name, spies):
    """A ``make_train_step`` step (the training forward under autograd)
    calls no fused wrapper and moves no launch counter; a decode step of
    the same model calls each once or twice a layer."""
    cfg = LlamaConfig.tiny(**CONFIGS[name])
    model = LlamaForCausalLM(cfg, generator=torch.Generator().manual_seed(7),
                             device="cpu")
    step = make_train_step(model, torch.optim.AdamW(model.parameters(),
                                                    lr=1e-3))
    ids = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 24)))
    before = llama_decode._counts()
    loss = step({"input_ids": ids, "labels": ids})
    assert torch.isfinite(loss)
    assert spies == {"add_rmsnorm": 0, "qk_rope": 0, "swiglu": 0}
    assert llama_decode._counts() == before
    llama_decode.decode_step(model, cfg, caches(cfg, 4),
                             *decode_args(cfg, np.random.default_rng(9)))
    L = cfg.n_layer
    assert spies == {"add_rmsnorm": 2 * L + 1, "qk_rope": L, "swiglu": L}
