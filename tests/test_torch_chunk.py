"""Chunked paged attention (K6), the span append (K7b),
``flash_attn_with_kvcache`` and speculative verification of the port
against the JAX package.

The same numpy inputs go to both. On the CPU the port runs the kernels'
plain-torch twins and JAX runs its Pallas kernels in interpret mode, all in
fp32. Tolerances: attention outputs atol = rtol = 1e-5 (fp32 sums in
another order; the observed gap is ~1e-6); cache writes bitwise equal
outside the scratch page 0, with each sequence on its own pages (in
interpret mode a JAX grid step read-modify-writes the page it fetched, so a
shared page loses writes); speculative logits atol = rtol = 1e-4 (two
128-wide fp32 layers, as in test_torch_gpt2_serving.py) and tokens exactly
equal. The kernels themselves are tested on the card in
test_torch_kernels.py.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels.chunk import (
    paged_chunk_attention as jax_paged_chunk_attention,
)
from flash_attn_tpu.models import gpt2_decode as jax_decode
from flash_attn_tpu.models.gpt2 import GPT2Config as JaxConfig
from flash_attn_tpu.models.gpt2 import GPT2LMHeadModel as JaxModel
from flash_attn_tpu.serving import cache as jax_cache
from flash_attn_tpu.serving import kvcache as jax_kvcache
from flash_attn_tpu_torch.kernels.chunk import (
    paged_chunk_attention,
    paged_chunk_attention_plain,
)
from flash_attn_tpu_torch.kernels.common import paged_block_live
from flash_attn_tpu_torch.models.convert import gpt2_from_jax_params
from flash_attn_tpu_torch.models.gpt2 import GPT2Config
from flash_attn_tpu_torch.reference import paged_chunk_ref
from flash_attn_tpu_torch.serving import cache as torch_cache
from flash_attn_tpu_torch.serving import kvcache as torch_kvcache
from flash_attn_tpu_torch.serving.speculative import speculative_decode

ATOL = RTOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent


def _paged(rng, lengths, h_kv, d, ps, num_pages, pages_max):
    """Random pages and a table giving each sequence its own pages (never
    the scratch page 0), in shuffled order."""
    kp = rng.standard_normal((h_kv, num_pages, ps, d)).astype(np.float32)
    vp = rng.standard_normal((h_kv, num_pages, ps, d)).astype(np.float32)
    table = np.zeros((len(lengths), pages_max), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    used = 0
    for i, n in enumerate(lengths):
        need = -(-max(n, 0) // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return kp, vp, table


# (lengths incl. the chunk, chunk_lens, sq, h, h_kv, page_size, pages_max)
CASES = [
    ([40, 17, 5, 33], [8, 3, 5, 0], 8, 2, 2, 16, 3),  # group 1, a padding row
    ([30, 64, 9], [5, 8, 1], 8, 4, 2, 16, 4),          # group 2, a full table
    ([20, 6, 0], [5, 2, 0], 5, 4, 2, 16, 2),           # ragged sq, length 0
]


@pytest.mark.parametrize("case", CASES, ids=str)
def test_paged_chunk_matches_jax_fp32(case):
    lengths, chunk_lens, sq, h, h_kv, ps, pmax = case
    rng = np.random.default_rng(0)
    kp, vp, table = _paged(rng, lengths, h_kv, 64, ps, 16, pmax)
    q = rng.standard_normal((len(lengths), sq, h, 64)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    cl = np.asarray(chunk_lens, np.int32)
    out_j = jax_paged_chunk_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(lens),
        jnp.asarray(table), chunk_lens=jnp.asarray(cl))
    args = [torch.from_numpy(x) for x in (q, kp, vp, lens, table)]
    out_t = paged_chunk_attention(*args, chunk_lens=torch.from_numpy(cl))
    assert out_t.shape == q.shape
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=RTOL)
    # padding rows are exactly zero
    for i, c in enumerate(chunk_lens):
        assert not out_t[i, c:].any()
    ref = paged_chunk_ref(*args, torch.from_numpy(cl))
    torch.testing.assert_close(out_t, ref, atol=ATOL, rtol=RTOL)


def test_paged_chunk_sq1_is_decode():
    """At sq = 1 the chunk twin is paged decode attention."""
    from flash_attn_tpu_torch.kernels.decode import paged_decode_attention
    rng = np.random.default_rng(1)
    lengths = [1, 16, 31, 0]
    kp, vp, table = (torch.from_numpy(x) for x in _paged(
        rng, lengths, 2, 64, 16, 12, 3))
    q = torch.from_numpy(rng.standard_normal((4, 1, 4, 64)).astype(
        np.float32))
    lens = torch.tensor(lengths, dtype=torch.int32)
    out = paged_chunk_attention(q, kp, vp, lens, table,
                                chunk_lens=(lens > 0).to(torch.int32))
    want = paged_decode_attention(q[:, 0], kp, vp, lens, table)
    torch.testing.assert_close(out[:, 0], want, atol=ATOL, rtol=RTOL)


def test_paged_block_live_and_unported_arguments():
    """paged_block_live as JAX's (the band floor and sinks included); the
    quantized cache (M5) and qk_quant (M8) still raise; window_left,
    softcap and ALiBi run and match JAX's chunk kernel."""
    from flash_attn_tpu.kernels.common import paged_block_live as jax_live
    lengths = torch.tensor([0, 16, 17, 40])
    assert paged_block_live(1, 16, length=lengths).tolist() == [
        False, False, True, True]
    floor = lengths - 1 - 4
    for j in range(3):
        for sinks in (0, 3):
            got = paged_block_live(j, 16, length=lengths, window_left=4,
                                   first_band_pos=floor, num_sinks=sinks)
            want = jax_live(j, 16, length=jnp.asarray(lengths.numpy()),
                            window_left=4,
                            first_band_pos=jnp.asarray(floor.numpy()),
                            num_sinks=sinks)
            assert got.tolist() == np.asarray(want).tolist(), (j, sinks)
    rng = np.random.default_rng(2)
    lens_np = [40, 23]
    kp, vp, table = _paged(rng, lens_np, 1, 64, 16, 8, 3)
    q = rng.standard_normal((2, 5, 1, 64)).astype(np.float32)
    lens, chunk = np.asarray(lens_np, np.int32), np.asarray([5, 3], np.int32)
    args = [q, kp, vp, lens, table]
    for kw in ({"k_scales": kp}, {"qk_quant": "int8"}):
        with pytest.raises(NotImplementedError, match="ROADMAP port item"):
            paged_chunk_attention(*(torch.from_numpy(x) for x in args),
                                  **kw)
    for kw in ({"window_left": 8}, {"softcap": 30.0},
               {"alibi_slopes": [1.0]}):
        out_j = jax_paged_chunk_attention(
            *(jnp.asarray(x) for x in args), chunk_lens=jnp.asarray(chunk),
            **kw)
        out_t = paged_chunk_attention(
            *(torch.from_numpy(x) for x in args),
            chunk_lens=torch.from_numpy(chunk), **kw)
        np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                                   atol=ATOL, rtol=RTOL, err_msg=str(kw))


H, D, PS, NUM_PAGES = 2, 64, 16, 13
# Each sequence owns three pages (C8).
TABLE = np.asarray([[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]], np.int32)


def _caches(seed):
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((H, NUM_PAGES, PS, D)).astype(np.float32)
    v = rng.standard_normal((H, NUM_PAGES, PS, D)).astype(np.float32)
    jc = jax_cache.PagedKVCache(jnp.asarray(k), jnp.asarray(v), None, None)
    tc = torch_cache.PagedKVCache(torch.from_numpy(k), torch.from_numpy(v))
    return jc, tc


def _assert_equal_outside_page0(jc, tc):
    for j, t in ((jc.k_pages, tc.k_pages), (jc.v_pages, tc.v_pages)):
        np.testing.assert_array_equal(t.numpy()[:, 1:],
                                      np.asarray(j)[:, 1:])


@pytest.mark.parametrize("lengths,new_lens", [
    ([0, 14, 16, 40], [5, 5, 3, 5]),   # page edges crossed, a short row
    ([5, -1, 45, 3], [5, 5, 5, 0]),    # inactive, past the table, padding
])
def test_append_span_matches_jax(lengths, new_lens):
    jc, tc = _caches(3)
    rng = np.random.default_rng(4)
    b, sq = len(lengths), 5
    nk = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    nv = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    nl = np.asarray(new_lens, np.int32)
    jc = jax_cache.append_span(jc, jnp.asarray(nk), jnp.asarray(nv),
                               jnp.asarray(TABLE), jnp.asarray(lens),
                               jnp.asarray(nl))
    out = torch_cache.append_span(
        tc, torch.from_numpy(nk), torch.from_numpy(nv),
        torch.from_numpy(TABLE), torch.from_numpy(lens), torch.from_numpy(nl))
    assert out is tc  # in place
    _assert_equal_outside_page0(jc, tc)


def test_chunk_write_of_projection_views_matches_jax_row_loop():
    """A chunk's K/V as GPT-2's chunked prefill hands them to the batched
    page write, strided views of the fused (b, C, 3, h, d) projection,
    against the JAX package's per-row write_prompt loop on the same values:
    rows with a short chunk and an all-padding row (its page list is the
    scratch page 0), bitwise outside page 0."""
    rng = np.random.default_rng(12)
    b, C, h, d, ps, num_pages = 4, 32, 2, 64, 16, 12
    kp, vp, _ = _paged(rng, [0], h, d, ps, num_pages, 1)
    qkv = rng.standard_normal((b, C, 3, h, d)).astype(np.float32)
    wtbl = np.asarray([[3, 7], [5, 0], [0, 0], [9, 11]], np.int32)
    jc = jax_cache.PagedKVCache(jnp.asarray(kp), jnp.asarray(vp), None, None)
    for r in range(b):
        jc = jax_cache.write_prompt(jc, jnp.asarray(qkv[r, :, 1]),
                                    jnp.asarray(qkv[r, :, 2]),
                                    jnp.asarray(wtbl[r]))
    tc = torch_cache.PagedKVCache(torch.from_numpy(kp.copy()),
                                  torch.from_numpy(vp.copy()))
    _, k, v = torch.from_numpy(qkv).unbind(2)
    assert not k.is_contiguous()
    torch_cache._write_prompts(tc, k, v, torch.from_numpy(wtbl))
    for j, t in ((jc.k_pages, tc.k_pages), (jc.v_pages, tc.v_pages)):
        np.testing.assert_array_equal(t.numpy()[:, 1:], np.asarray(j)[:, 1:])


@pytest.mark.parametrize("with_kv", [True, False])
def test_flash_attn_with_kvcache_matches_jax(with_kv):
    """With k/v: append, then attend with total = cache_seqlens + new_lens.
    Without: attend to what is cached, total = cache_seqlens."""
    jc, tc = _caches(5)
    rng = np.random.default_rng(6)
    b, sq, hq = 3, 4, 4
    seqlens = np.asarray([10, 20, 3], np.int32)
    new_lens = np.asarray([4, 2, 0], np.int32)
    q = rng.standard_normal((b, sq, hq, D)).astype(np.float32)
    nk = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    nv = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    kv_j = (jnp.asarray(nk), jnp.asarray(nv)) if with_kv else (None, None)
    kv_t = (torch.from_numpy(nk), torch.from_numpy(nv)) if with_kv \
        else (None, None)
    out_j, jc = jax_kvcache.flash_attn_with_kvcache(
        jnp.asarray(q), jc, jnp.asarray(TABLE[:b]), jnp.asarray(seqlens),
        *kv_j, new_lens=jnp.asarray(new_lens))
    out_t, tc = torch_kvcache.flash_attn_with_kvcache(
        torch.from_numpy(q), tc, torch.from_numpy(TABLE[:b]),
        torch.from_numpy(seqlens), *kv_t, new_lens=torch.from_numpy(new_lens))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=RTOL)
    _assert_equal_outside_page0(jc, tc)


@pytest.mark.parametrize("with_kv", [True, False])
def test_flash_attn_with_kvcache_apply_rotary_matches_jax(with_kv):
    """apply_rotary=True: q (and the new k) rotated at their global cache
    positions before the write and the attention (base 500000, as Llama-3
    has it); the output at the fp32 tolerance; outside page 0 the cache
    within 1e-6 where rotated keys were written (sin and cos of the same
    fp32 angles from two libraries), else bitwise."""
    jc, tc = _caches(7)
    rng = np.random.default_rng(8)
    b, sq, hq = 3, 4, 4
    seqlens = np.asarray([10, 20, 4], np.int32)
    new_lens = np.asarray([4, 2, 1], np.int32)
    q = rng.standard_normal((b, sq, hq, D)).astype(np.float32)
    nk = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    nv = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    kv_j = (jnp.asarray(nk), jnp.asarray(nv)) if with_kv else (None, None)
    kv_t = (torch.from_numpy(nk), torch.from_numpy(nv)) if with_kv \
        else (None, None)
    kw = dict(apply_rotary=True, rotary_base=500000.0)
    out_j, jc = jax_kvcache.flash_attn_with_kvcache(
        jnp.asarray(q), jc, jnp.asarray(TABLE[:b]), jnp.asarray(seqlens),
        *kv_j, new_lens=jnp.asarray(new_lens), **kw)
    out_t, tc = torch_kvcache.flash_attn_with_kvcache(
        torch.from_numpy(q), tc, torch.from_numpy(TABLE[:b]),
        torch.from_numpy(seqlens), *kv_t, new_lens=torch.from_numpy(new_lens),
        **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=RTOL)
    if with_kv:  # rotated keys, written as JAX writes them
        for j, t in ((jc.k_pages, tc.k_pages), (jc.v_pages, tc.v_pages)):
            np.testing.assert_allclose(t.numpy()[:, 1:],
                                       np.asarray(j)[:, 1:], atol=1e-6,
                                       rtol=1e-6)
    else:
        _assert_equal_outside_page0(jc, tc)


# (cache_seqlens, new_lens, q heads): page edges crossed, a short row;
# an inactive row, a span running past the table, a padding row; GQA
# group 2.
KVCACHE_CASES = [
    ([0, 14, 16, 40], [5, 5, 3, 5], 2),
    ([5, -1, 45, 3], [5, 5, 5, 0], 2),
    ([15, 31, 0, 20], [5, 1, 4, 5], 4),
]


@pytest.mark.parametrize("case", KVCACHE_CASES, ids=str)
def test_flash_attn_with_kvcache_appends_like_jax(case):
    """k/v given: the chunk is appended inside K6's launch on the card (its
    plain twins here), against JAX's flash_attn_with_kvcache (append_span,
    then the chunk kernel): the output at the fp32 tolerance, the cache
    bitwise outside page 0."""
    seqlens, new_lens, hq = case
    seqlens, new_lens = (np.asarray(x, np.int32) for x in (seqlens, new_lens))
    jc, tc = _caches(11)
    rng = np.random.default_rng(12)
    b, sq = len(seqlens), 5
    q = rng.standard_normal((b, sq, hq, D)).astype(np.float32)
    nk = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    nv = rng.standard_normal((b, sq, H, D)).astype(np.float32)
    out_j, jc = jax_kvcache.flash_attn_with_kvcache(
        jnp.asarray(q), jc, jnp.asarray(TABLE[:b]), jnp.asarray(seqlens),
        jnp.asarray(nk), jnp.asarray(nv), new_lens=jnp.asarray(new_lens))
    out_t, tc = torch_kvcache.flash_attn_with_kvcache(
        torch.from_numpy(q), tc, torch.from_numpy(TABLE[:b]),
        torch.from_numpy(seqlens), torch.from_numpy(nk), torch.from_numpy(nv),
        new_lens=torch.from_numpy(new_lens))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=RTOL)
    _assert_equal_outside_page0(jc, tc)


def test_kvcache_and_chunk_append_take_projection_views():
    """q, k and v as views of GPT-2's fused (b, sq, 3, h, d) projection,
    as score_chunk passes them: flash_attn_with_kvcache and
    paged_chunk_attention(new_k=...) give what their contiguous calls
    give, output and cache."""
    rng = np.random.default_rng(13)
    b, sq = 4, 5
    seqlens = torch.tensor([0, 14, -1, 40], dtype=torch.int32)
    new_lens = torch.tensor([5, 5, 5, 3], dtype=torch.int32)
    table = torch.from_numpy(TABLE)
    fused = torch.from_numpy(
        rng.standard_normal((b, sq, 3, H, D)).astype(np.float32))
    views = fused.unbind(2)
    assert not views[1].is_contiguous()
    for call in ("kvcache", "chunk"):
        outs = []
        for q, k, v in (views, [x.contiguous() for x in views]):
            _, tc = _caches(14)
            if call == "kvcache":
                out, _ = torch_kvcache.flash_attn_with_kvcache(
                    q, tc, table, seqlens, k, v, new_lens=new_lens)
            else:
                out = paged_chunk_attention(
                    q, tc.k_pages, tc.v_pages, seqlens + new_lens, table,
                    chunk_lens=new_lens, new_k=k, new_v=v,
                    cache_seqlens=seqlens)
            outs.append((out, tc.k_pages, tc.v_pages))
        for x, y in zip(*outs):
            assert torch.equal(x, y), call


def test_append_fits_one_row_tile():
    """K6 appends inside its launch when the chunk is one row tile: sq x
    group query rows within 128 (fp32: 64); past that,
    flash_attn_with_kvcache appends by append_span first."""
    from flash_attn_tpu_torch.kernels.chunk import append_fits
    bf16, f32 = torch.bfloat16, torch.float32
    assert append_fits(5, 1, bf16) and append_fits(128, 1, torch.float16)
    assert append_fits(32, 4, bf16) and not append_fits(33, 4, bf16)
    assert not append_fits(129, 1, bf16)
    assert append_fits(16, 4, f32) and not append_fits(17, 4, f32)
    q = torch.zeros((1, 2, 2, D))
    kp = torch.zeros((H, 4, PS, D))
    with pytest.raises(ValueError, match="go together"):
        paged_chunk_attention(q, kp, kp, torch.tensor([2], dtype=torch.int32),
                              torch.tensor([[1]], dtype=torch.int32),
                              new_k=q[:, :, :H])


def _load_example():
    spec = importlib.util.spec_from_file_location(
        "speculative_decode", ROOT / "examples" / "speculative_decode.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_speculative_decode_matches_greedy_and_jax():
    """The port's speculative loop on GPT2Config.tiny (fp32): its tokens
    equal plain greedy decoding, and its first verify rounds equal the
    JAX example's ``score_chunk`` on the same cache (greedy rows exactly,
    logits against JAX's full forward at the same positions)."""
    jcfg = JaxConfig.tiny(dtype=jnp.float32)
    jmodel = JaxModel(jcfg)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, jcfg.vocab_size, 40).tolist()
    params = jmodel.init(jax.random.PRNGKey(0),
                         jnp.asarray([prompt], jnp.int32))
    cfg = GPT2Config.tiny(dtype=torch.float32)
    model = gpt2_from_jax_params(jax.tree_util.tree_map(np.asarray, params),
                                 cfg, device="cpu")
    new = 10
    generated, rounds = speculative_decode(model, cfg, prompt, new, k=4,
                                           page_size=16)
    ids = torch.tensor([prompt])
    for _ in range(new):
        nxt = model(ids)[0, -1].argmax()
        ids = torch.cat([ids, nxt.reshape(1, 1)], dim=1)
    assert generated == ids[0, len(prompt):].tolist()
    assert len(rounds) < new  # some drafts were accepted

    # The JAX side: the same prompt cached on the same pages, then the
    # port's first two chunks scored by the example's score_chunk.
    example = _load_example()
    n_pages = -(-(len(prompt) + new + 4 + 2) // 16)
    table = jnp.arange(1, 1 + n_pages, dtype=jnp.int32)[None]
    jc = [jax_cache.init_cache(cfg.n_head, 1 + n_pages, 16, cfg.head_dim,
                               dtype=jnp.float32) for _ in range(cfg.n_layer)]
    _, ks, vs = jax_decode.prefill(params, jcfg,
                                   jnp.asarray([prompt], jnp.int32))
    for li in range(cfg.n_layer):
        jc[li] = jax_cache.write_prompt(jc[li], ks[li][0], vs[li][0],
                                        table[0, : -(-len(prompt) // 16)])
    final = prompt + generated
    for pos0, chunk, logits in rounds[:2]:
        greedy, jc = example.score_chunk(params, jcfg, jc, table, chunk, pos0)
        assert logits.argmax(-1).tolist() == greedy
        full = jmodel.apply(params, jnp.asarray([final[:pos0] + chunk],
                                                jnp.int32))
        np.testing.assert_allclose(logits.numpy(), np.asarray(full[0, pos0:]),
                                   atol=1e-4, rtol=1e-4)
