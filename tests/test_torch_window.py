"""Sliding windows, sinks, ALiBi and softcap (ROADMAP M4) of the port
against the JAX package: ``flash_attention`` (dense, GQA and segment
form, forward, lse and gradients), the cu_seqlens interface, the
``alibi_slopes`` schedule, the paged kernels' twins (K5, K6) and the
shared band algebra.

The same numpy inputs and cotangents go to both. On the CPU the port runs
the kernels' plain-torch twins and JAX runs its Pallas kernels in
interpret mode, all in fp32. Tolerances: atol = rtol = 1e-4 on out, lse
and gradients (fp32 sums in different orders; the softcap's tanh is
computed by each library's own tanh), atol = rtol = 1e-5 on the paged
kernels' outputs (as tests/test_torch_decode.py), slopes exactly equal,
and the band's predicates exactly equal. The kernels themselves are tested
on the card in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels import common as jax_common
from flash_attn_tpu.kernels.chunk import (
    paged_chunk_attention as jax_paged_chunk_attention,
)
from flash_attn_tpu.kernels.decode import (
    paged_decode_attention as jax_paged_decode_attention,
)
from flash_attn_tpu.ops import interface as jif
from flash_attn_tpu.ops.attention import alibi_slopes as jax_alibi_slopes
from flash_attn_tpu.ops.attention import flash_attention as jax_flash_attention
from flash_attn_tpu_torch import alibi_slopes, flash_attention
from flash_attn_tpu_torch.kernels import common
from flash_attn_tpu_torch.kernels.chunk import paged_chunk_attention
from flash_attn_tpu_torch.kernels.decode import paged_decode_attention
from flash_attn_tpu_torch.ops import interface as tif
from flash_attn_tpu_torch.reference import (
    alibi_bias,
    attention_ref,
    build_mask,
    paged_chunk_ref,
)
from flash_attn_tpu_torch.utils.testing import cu_seqlens, segment_layout

ATOL = RTOL = 1e-4
PAGED_ATOL = PAGED_RTOL = 1e-5

# (b, sq, sk, h, h_kv, d, causal, kwargs of flash_attention)
CASES = [
    (2, 96, 96, 2, 2, 64, True, dict(window_size=(16, 0))),
    (1, 96, 96, 2, 2, 64, False, dict(window_size=(8, 24))),
    (1, 96, 96, 2, 2, 64, False, dict(window_size=(None, 12))),
    (1, 80, 112, 2, 2, 64, True, dict(window_size=(20, -1))),   # sq < sk
    (1, 112, 80, 2, 2, 64, False, dict(window_size=(6, 9))),    # sq > sk
    (1, 96, 96, 4, 2, 64, True, dict(window_size=(16, 0), num_sinks=4)),
    (1, 96, 96, 2, 2, 64, False, dict(window_size=(10, 10),
                                      num_sinks=3)),
    (1, 96, 96, 2, 2, 64, True, dict(softcap=5.0)),
    (1, 96, 96, 2, 2, 64, False, dict(softcap=2.0)),
    (1, 96, 96, 4, 2, 64, True, dict(alibi_slopes="geometric")),
    (2, 64, 64, 2, 2, 64, False, dict(alibi_slopes="per-batch")),
    (1, 96, 96, 4, 2, 64, True, dict(window_size=(24, 0), softcap=30.0,
                                     alibi_slopes="geometric")),
    (1, 96, 96, 2, 2, 128, False, dict(window_size=(12, 20), softcap=3.0,
                                       alibi_slopes="geometric",
                                       num_sinks=2)),
    (1, 64, 64, 2, 2, 64, True, dict(window_size=(200, 0))),  # whole band
]


def _inputs(seed, b, sq, sk, h, h_kv, d):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (f(b, sq, h, d), f(b, sk, h_kv, d), f(b, sk, h_kv, d),
            f(b, sq, h, d), f(b, h, sq))


def _slopes(kind, b, h):
    if kind == "geometric":
        return np.asarray(jax_alibi_slopes(h))
    rng = np.random.default_rng(7)
    return rng.uniform(0.05, 0.5, (b, h)).astype(np.float32)


def _both(kw, b, h):
    """(JAX kwargs, torch kwargs): slopes as each library's array."""
    kw = dict(kw)
    if "alibi_slopes" in kw:
        a = np.array(_slopes(kw["alibi_slopes"], b, h))
        return ({**kw, "alibi_slopes": jnp.asarray(a)},
                {**kw, "alibi_slopes": torch.from_numpy(a)})
    return kw, kw


def _jax_grads(q, k, v, dout, dlse, **kw):
    def fn(q, k, v):
        return jax_flash_attention(q, k, v, return_lse=True, **kw)

    (out, lse), vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    grads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    return [np.asarray(x) for x in (out, lse, *grads)]


def _torch_grads(q, k, v, dout, dlse, **kw):
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out, lse = flash_attention(*leaves, return_lse=True, **kw)
    torch.autograd.backward([out, lse], [torch.from_numpy(dout),
                                         torch.from_numpy(dlse)])
    return [x.detach().numpy() for x in (out, lse, *(t.grad
                                                      for t in leaves))]


def _close(got, want, names, atol=ATOL, rtol=RTOL):
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g, w, atol=atol, rtol=rtol, err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_flash_attention_band_terms_match_jax(case):
    """out, lse, dq, dk, dv (a cotangent on both outputs) with the band
    terms, dense and GQA, against JAX's."""
    b, sq, sk, h, h_kv, d, causal, kw = case
    q, k, v, dout, dlse = _inputs(0, b, sq, sk, h, h_kv, d)
    jkw, tkw = _both(kw, b, h)
    want = _jax_grads(q, k, v, dout, dlse, causal=causal, **jkw)
    got = _torch_grads(q, k, v, dout, dlse, causal=causal, **tkw)
    _close(got, want, ["out", "lse", "dq", "dk", "dv"])


@pytest.mark.parametrize("window,alibi", [((8, 8), False), ((12, 0), True),
                                          ((None, 5), True)], ids=str)
@pytest.mark.parametrize("kind,causal", [("padding", False),
                                         ("packed", True),
                                         ("random", True)], ids=str)
def test_segment_form_band_terms_match_jax(kind, causal, window, alibi):
    """The segment form: the band and ALiBi by per-segment positions,
    forward, lse and gradients against JAX's."""
    b = 1 if kind == "packed" else 2
    s, h = 128, 2
    q, k, v, dout, dlse = _inputs(1, b, s, s, h, h, 64)
    ids = segment_layout(np.random.default_rng(2), kind, b, s, s)
    seg = dict(zip(("q_segment_ids", "kv_segment_ids", "q_positions",
                    "kv_positions"), ids))
    kw = dict(causal=causal, window_size=window)
    if alibi:
        kw["alibi_slopes"] = "geometric"
    jkw, tkw = _both(kw, b, h)
    want = _jax_grads(q, k, v, dout, dlse, **jkw,
                      **{n: jnp.asarray(x) for n, x in seg.items()})
    got = _torch_grads(q, k, v, dout, dlse, **tkw,
                       **{n: torch.from_numpy(np.ascontiguousarray(x))
                          for n, x in seg.items()})
    _close(got, want, ["out", "lse", "dq", "dk", "dv"])


@pytest.mark.parametrize("kw", [dict(window_size=(6, 0)),
                                dict(window_size=(4, 4), alibi_slopes=1),
                                dict(softcap=4.0, alibi_slopes=1)], ids=str)
def test_varlen_band_terms_match_jax(kw):
    """flash_attn_varlen_func with a window, ALiBi and softcap: the segment
    form compares per-sequence positions, so the band and the distances
    restart in each packed sequence; out and gradients against JAX's."""
    lens = [30, 7, 51, 16]
    cu = cu_seqlens(lens)
    h = 2
    q, k, v, dout, _ = _inputs(3, 1, int(cu[-1]), int(cu[-1]), h, h, 64)
    q, k, v, dout = (x[0] for x in (q, k, v, dout))
    kw = dict(kw)
    if "alibi_slopes" in kw:
        kw["alibi_slopes"] = "geometric"
    jkw, tkw = _both(kw, 1, h)

    def jfn(q, k, v):
        return jif.flash_attn_varlen_func(q, k, v, jnp.asarray(cu),
                                          jnp.asarray(cu), 51, 51, 0.0,
                                          causal=True, **jkw)

    out_j, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    want = [np.asarray(x) for x in (out_j, *vjp(jnp.asarray(dout)))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = tif.flash_attn_varlen_func(*leaves, torch.from_numpy(cu),
                                     torch.from_numpy(cu), 51, 51, 0.0,
                                     causal=True, **tkw)
    out.backward(torch.from_numpy(dout))
    got = [x.detach().numpy() for x in (out, *(t.grad for t in leaves))]
    _close(got, want, ["out", "dq", "dk", "dv"])


def test_cu_seqlens_module_keeps_softcap():
    """FlashAttention(softcap=...) on the cu_seqlens path: the port passes
    the softcap on (the known divergence in ROADMAP), so it computes JAX's
    varlen interface WITH the softcap; JAX's module drops it there and
    gives the uncapped result. Window and ALiBi stay refused, with JAX's
    wording."""
    from flash_attn_tpu.models import modules as jmod
    from flash_attn_tpu_torch.models.modules import FlashAttention
    lens = [30, 7, 51]
    cu = cu_seqlens(lens)
    qkv = np.random.default_rng(4).standard_normal(
        (int(cu[-1]), 3, 2, 64)).astype(np.float32)
    cap = 0.5
    got = FlashAttention(softcap=cap)(torch.from_numpy(qkv), causal=True,
                                      cu_seqlens=torch.from_numpy(cu),
                                      max_s=51)
    capped = jif.flash_attn_varlen_qkvpacked_func(
        jnp.asarray(qkv), jnp.asarray(cu), 51, 0.0, causal=True,
        softcap=cap)
    np.testing.assert_allclose(got.numpy(), np.asarray(capped), atol=ATOL,
                               rtol=RTOL)
    jax_module = jmod.FlashAttention(softcap=cap).apply(
        {}, jnp.asarray(qkv), causal=True, cu_seqlens=jnp.asarray(cu),
        max_s=51)
    uncapped = jif.flash_attn_varlen_qkvpacked_func(
        jnp.asarray(qkv), jnp.asarray(cu), 51, 0.0, causal=True)
    np.testing.assert_allclose(np.asarray(jax_module), np.asarray(uncapped),
                               atol=ATOL, rtol=RTOL)
    assert np.abs(got.numpy() - np.asarray(uncapped)).max() > 1e-2
    for kw, word in ((dict(window_size=(4, 0)), "window_size"),
                     (dict(use_alibi=True), "ALiBi")):
        with pytest.raises(ValueError, match=f"{word} is not supported on "
                           "the cu_seqlens path"):
            FlashAttention(**kw)(torch.from_numpy(qkv),
                                 cu_seqlens=torch.from_numpy(cu), max_s=51)


@pytest.mark.parametrize("n", [8, 12, 6, 32])
def test_alibi_slopes_match_jax(n):
    got = alibi_slopes(n)
    assert got.dtype == torch.float32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_alibi_slopes(n)))


def test_reference_and_twin_agree_with_the_oracle():
    """The fp32 oracle (attention_ref with build_mask, alibi_bias and the
    softcap) matches the kernels' twin through the op, and JAX's oracle
    matches it too: the mask, bias and cap orders agree."""
    from flash_attn_tpu.reference import attention_ref as jax_ref
    from flash_attn_tpu.reference import build_mask as jax_build_mask
    b, s, h, d = 1, 96, 2, 64
    q, k, v, _, _ = _inputs(5, b, s, s, h, h, d)
    slopes = np.array(jax_alibi_slopes(h))
    kw = dict(window_size=(20, 0), alibi_slopes=slopes, softcap=8.0)
    out = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                          **{**kw, "alibi_slopes": torch.from_numpy(
                              np.asarray(slopes))})
    tr = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))  # noqa
    mask = build_mask(s, s, causal=True, window_left=20)
    bias = alibi_bias(torch.from_numpy(np.asarray(slopes)), s, s,
                      causal=True)
    ref = attention_ref(*(torch.from_numpy(tr(x)) for x in (q, k, v)),
                        causal=True, mask=mask, bias=bias, softcap=8.0)
    np.testing.assert_allclose(ref.numpy(), tr(out.numpy()), atol=ATOL,
                               rtol=RTOL)
    jmask = jax_build_mask(s, s, causal=True, window_left=20)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    jref = jax_ref(*(jnp.asarray(tr(x)) for x in (q, k, v)), causal=True,
                   mask=jmask, bias=jnp.asarray(bias.numpy()), softcap=8.0)
    np.testing.assert_allclose(ref.numpy(), np.asarray(jref), atol=ATOL,
                               rtol=RTOL)


def test_band_predicates_match_jax():
    """classify_segment_block's window terms, paged_block_live and
    paged_visibility_mask with a band and sinks, and paged_block_softmax
    with the softcap and ALiBi: exactly JAX's."""
    rng = np.random.default_rng(4)
    for _ in range(40):
        qp, kp = (np.sort(rng.integers(0, 300, 16)).astype(np.int32)
                  for _ in range(2))
        qs = np.zeros(16, np.int32)
        causal = bool(rng.integers(2))
        left = int(rng.integers(0, 80)) if rng.integers(2) else None
        right = int(rng.integers(0, 80)) if rng.integers(2) else None
        got = common.classify_segment_block(
            *map(torch.from_numpy, (qp, kp, qs, qs)), causal=causal,
            bounds_possible=False, window_left=left, window_right=right)
        want = jax_common.classify_segment_block(
            *map(jnp.asarray, (qp, kp, qs, qs)), causal=causal,
            bounds_possible=False, window_left=left, window_right=right)
        assert [bool(x) for x in got] == [bool(x) for x in want]
    length = np.asarray([0, 40, 90, 300], np.int32)
    kpos = np.arange(64, 128)
    for window, sinks in ((None, 0), (30, 0), (30, 4), (100, 70)):
        first = length - 1 - (window or 0)
        for j in range(5):
            got = common.paged_block_live(
                j, 64, length=torch.from_numpy(length), window_left=window,
                first_band_pos=torch.from_numpy(first), num_sinks=sinks)
            want = jax_common.paged_block_live(
                j, 64, length=jnp.asarray(length), window_left=window,
                first_band_pos=jnp.asarray(first), num_sinks=sinks)
            assert got.tolist() == np.asarray(want).tolist()
        qpos = (length - 1)[:, None]
        got = common.paged_visibility_mask(
            torch.from_numpy(kpos), torch.from_numpy(qpos),
            length=torch.from_numpy(length[:, None]), window_left=window,
            num_sinks=sinks)
        want = jax_common.paged_visibility_mask(
            jnp.asarray(kpos), jnp.asarray(qpos),
            length=jnp.asarray(length[:, None]), window_left=window,
            num_sinks=sinks)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    s = rng.standard_normal((4, 64)).astype(np.float32) * 20
    mask = rng.random((4, 64)) < 0.7
    m0 = rng.standard_normal((4, 1)).astype(np.float32)
    l0 = rng.random((4, 1)).astype(np.float32)
    col = rng.random((4, 1)).astype(np.float32)
    rel = (np.arange(64)[None] - 70).astype(np.float32)
    got = common.paged_block_softmax(
        *map(torch.from_numpy, (s, mask, m0, l0)), softcap=15.0,
        alibi_col=torch.from_numpy(col), rel=torch.from_numpy(rel))
    want = jax_common.paged_block_softmax(
        *map(jnp.asarray, (s, mask, m0, l0)), softcap=15.0,
        alibi_col=jnp.asarray(col), rel=jnp.asarray(rel))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                   rtol=1e-6)


def test_band_arguments_are_validated_as_jax():
    """Negative windows, a non-positive softcap, sinks without a band or
    with segments, and slopes of the wrong shape raise ValueError, as in
    JAX; window_cell raises naming M4b."""
    q = torch.zeros(1, 16, 2, 64)
    ids = torch.zeros(1, 16, dtype=torch.int32)
    for kw in (dict(window_size=(-2, 0)), dict(softcap=0.0),
               dict(num_sinks=2), dict(window_size=(4, 0), num_sinks=2,
                                       q_segment_ids=ids, kv_segment_ids=ids),
               dict(alibi_slopes=torch.ones(3))):
        with pytest.raises(ValueError):
            flash_attention(q, q, q, **kw)
    with pytest.raises(NotImplementedError, match="M4b"):
        flash_attention(q, q, q, window_size=(4, 0), window_cell=(16, 64))


def _paged(seed, lengths, sq, h, h_kv, d, ps, pmax):
    rng = np.random.default_rng(seed)
    b = len(lengths)
    num_pages = 1 + b * pmax
    kp = rng.standard_normal((h_kv, num_pages, ps, d)).astype(np.float32)
    vp = rng.standard_normal((h_kv, num_pages, ps, d)).astype(np.float32)
    table = (1 + rng.permutation(b * pmax)).reshape(b, pmax).astype(np.int32)
    shape = (b, h, d) if sq is None else (b, sq, h, d)
    q = rng.standard_normal(shape).astype(np.float32)
    return q, kp, vp, np.asarray(lengths, np.int32), table


# (window_left, num_sinks, alibi, softcap)
PAGED_TERMS = [(12, 0, False, None), (12, 3, False, None),
               (None, 0, True, None), (None, 0, False, 20.0),
               (20, 2, True, 5.0), (0, 0, False, None)]


def _paged_kw(terms, h, lib):
    window, sinks, alibi, cap = terms
    kw = dict(window_left=window, num_sinks=sinks, softcap=cap)
    if alibi:
        a = np.asarray(jax_alibi_slopes(h))
        kw["alibi_slopes"] = jnp.asarray(a) if lib == "jax" else \
            torch.from_numpy(a)
    return kw


@pytest.mark.parametrize("terms", PAGED_TERMS, ids=str)
def test_paged_decode_band_terms_match_jax(terms):
    """K5's twin with each term against JAX's decode kernel (and, with a
    window, against the dense oracle under the band)."""
    h, h_kv, d, ps, pmax = 4, 2, 64, 16, 5
    lengths = [1, 16, 37, 80, 0]
    q, kp, vp, lens, table = _paged(0, lengths, None, h, h_kv, d, ps, pmax)
    want = jax_paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, lens, table)),
        **_paged_kw(terms, h, "jax"))
    got = paged_decode_attention(*map(torch.from_numpy, (q, kp, vp, lens,
                                                         table)),
                                 **_paged_kw(terms, h, "torch"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PAGED_ATOL, rtol=PAGED_RTOL)
    one = torch.from_numpy((lens > 0).astype(np.int32))
    dense = paged_chunk_ref(torch.from_numpy(q)[:, None],
                            *map(torch.from_numpy, (kp, vp, lens, table)),
                            one, **_paged_kw(terms, h, "torch"))[:, 0]
    torch.testing.assert_close(got, dense, atol=PAGED_ATOL, rtol=PAGED_RTOL)


@pytest.mark.parametrize("terms", [t for t in PAGED_TERMS if not t[1]],
                         ids=str)
def test_paged_chunk_band_terms_match_jax(terms):
    """K6's twin with each term (from the first row's band floor; JAX's
    chunk kernel has no sinks) against JAX's chunk kernel, padding rows
    0."""
    h, h_kv, d, ps, pmax, sq = 4, 2, 64, 16, 6, 8
    lengths = [8, 40, 93, 20]
    chunk = np.asarray([8, 5, 8, 0], np.int32)
    q, kp, vp, lens, table = _paged(1, lengths, sq, h, h_kv, d, ps, pmax)
    kw_j = _paged_kw(terms, h, "jax")
    kw_t = _paged_kw(terms, h, "torch")
    del kw_j["num_sinks"], kw_t["num_sinks"]
    want = jax_paged_chunk_attention(
        *map(jnp.asarray, (q, kp, vp, lens, table)),
        chunk_lens=jnp.asarray(chunk), **kw_j)
    got = paged_chunk_attention(*map(torch.from_numpy, (q, kp, vp, lens,
                                                        table)),
                                chunk_lens=torch.from_numpy(chunk), **kw_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=PAGED_ATOL, rtol=PAGED_RTOL)
    assert not got[3].any()


def test_paged_chunk_terms_match_the_dense_oracle():
    """K6's twin with a window, softcap and ALiBi together against the
    dense oracle, and at sq = 1 against K5's twin."""
    h, h_kv, d, ps, pmax, sq = 4, 2, 64, 16, 6, 8
    lengths = [8, 40, 93, 20]
    chunk = np.asarray([8, 5, 8, 1], np.int32)
    q, kp, vp, lens, table = _paged(2, lengths, sq, h, h_kv, d, ps, pmax)
    args = [torch.from_numpy(x) for x in (q, kp, vp, lens, table)]
    kw = dict(window_left=10, softcap=9.0, alibi_slopes=alibi_slopes(h))
    got = paged_chunk_attention(*args, chunk_lens=torch.from_numpy(chunk),
                                **kw)
    want = paged_chunk_ref(*args, torch.from_numpy(chunk), **kw)
    torch.testing.assert_close(got, want, atol=PAGED_ATOL, rtol=PAGED_RTOL)
    one = torch.ones(4, dtype=torch.int32)
    got1 = paged_chunk_attention(args[0][:, :1], *args[1:], chunk_lens=one,
                                 **kw)
    dec = paged_decode_attention(args[0][:, 0], *args[1:], **kw)
    torch.testing.assert_close(got1[:, 0], dec, atol=PAGED_ATOL,
                               rtol=PAGED_RTOL)


def test_paged_splits_follow_the_band():
    """With a window the split count comes from the band's span, not the
    table: a long table with a short window splits like a short table."""
    long_table = common.paged_num_splits(1, 8, 512, 16, 132)
    span = common.paged_live_span(512, 16, 100, 4)
    assert span == 64 + 100 + 1 + 64
    banded = common.paged_num_splits(1, 8, 512, 16, 132, span)
    assert banded == common.paged_num_splits(1, 8, -(-span // 16), 16, 132)
    assert banded < long_table
    assert common.paged_live_span(4, 16, 100, 4) == 64  # the table's cap
    assert common.paged_live_span(512, 16, None, 0) == 512 * 16
