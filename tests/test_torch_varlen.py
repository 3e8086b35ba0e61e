"""The port's varlen path against the JAX package's, on the same numpy
inputs: ``flash_attention`` with segment ids and positions (K1/K2's segment
form; the port's plain twins here, JAX's Pallas kernels in interpret
mode), the cu_seqlens interface (``ops/interface.py``) in both input forms,
and the dropout masks of both coordinate systems.

fp32 throughout; out, lse, dq, dk and dv are held to atol = rtol = 1e-4
(the two sum in different orders, as in test_torch_attention_bwd.py);
rows that see no key give out = 0 and lse = -inf exactly; dropout masks
are bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.kernels import prng as jprng
from flash_attn_tpu.ops import interface as jif
from flash_attn_tpu.ops.attention import flash_attention as jax_flash
from flash_attn_tpu_torch import flash_attention
from flash_attn_tpu_torch.kernels import prng
from flash_attn_tpu_torch.kernels.common import (
    Segments,
    TILE_DEAD,
    TILE_FULL,
    classify_segment_block,
    segment_plan_plain,
)
from flash_attn_tpu_torch.kernels.flash_fwd import keep_plain
from flash_attn_tpu_torch.ops import interface as tif
from flash_attn_tpu_torch.ops.packing import cu_seqlens_to_segments
from flash_attn_tpu_torch.utils.testing import cu_seqlens, segment_layout

ATOL = RTOL = 1e-4
SEED = 4321

# (segment layout of utils/testing.py, b, sq, sk, h, h_kv, d, causal)
CASES = [
    ("padding", 2, 96, 96, 2, 2, 64, False),
    ("packed", 1, 128, 128, 2, 2, 64, True),
    ("packed_qk", 1, 96, 128, 2, 1, 64, True),  # per-segment sq != sk (C5)
    ("random", 2, 72, 72, 2, 2, 64, True),      # non-contiguous ids
    ("allpad", 2, 64, 64, 4, 2, 64, True),      # GQA, a row of padding only
]


def _inputs(case, seed=0):
    kind, b, sq, sk, h, h_kv, d, _ = case
    rng = np.random.default_rng(seed)
    seg = segment_layout(rng, kind, b, sq, sk)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (f(b, sq, h, d), f(b, sk, h_kv, d), f(b, sk, h_kv, d),
            f(b, sq, h, d), f(b, h, sq), seg)


def _seg_kw(seg):
    return dict(zip(("q_segment_ids", "kv_segment_ids", "q_positions",
                     "kv_positions"), seg))


def _close(got, want, names):
    for name, g, w in zip(names, got, want):
        g = g.detach().numpy()
        w = np.asarray(w)
        np.testing.assert_array_equal(np.isneginf(g), np.isneginf(w),
                                      err_msg=name)
        fin = np.isfinite(w)
        np.testing.assert_allclose(g[fin], w[fin], atol=ATOL, rtol=RTOL,
                                   err_msg=name)


@pytest.mark.parametrize("case,dropout_p", [(c, 0.0) for c in CASES] + [
    (CASES[0], 0.17), (CASES[2], 0.17)], ids=str)
def test_segments_match_jax(case, dropout_p):
    """out, lse and the gradients of a loss on both (the lse cotangent
    only where the lse is finite) with segment ids and positions."""
    *_, causal = case
    q, k, v, dout, dlse, seg = _inputs(case)
    kw = dict(causal=causal, dropout_p=dropout_p,
              dropout_seed=SEED if dropout_p else None)
    dlse = np.where(seg[0][:, None, :] >= 0, dlse, 0.0).astype(np.float32)

    def fn(q, k, v):
        return jax_flash(q, k, v, return_lse=True, **kw,
                         **_seg_kw(jnp.asarray(x) for x in seg))

    (out, lse), vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    want = [out, lse, *vjp((jnp.asarray(dout), jnp.asarray(dlse)))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got_out, got_lse = flash_attention(*leaves, return_lse=True, **kw,
                                       **_seg_kw(torch.from_numpy(x)
                                                 for x in seg))
    torch.autograd.backward([got_out, got_lse], [torch.from_numpy(dout),
                                                 torch.from_numpy(dlse)])
    _close([got_out, got_lse, *(x.grad for x in leaves)], want,
           ["out", "lse", "dq", "dk", "dv"])
    dead = np.isneginf(np.asarray(lse))
    assert dead.any() == (case[0] in ("padding", "packed", "packed_qk",
                                      "allpad", "random"))
    assert not got_out.detach().numpy().transpose(0, 2, 1, 3)[dead].any()


def test_positions_default_to_arange():
    """Segment ids alone: positions are arange, as in JAX; under causal
    masking that is the dense top-left rule inside one segment."""
    q, k, v, *_ = _inputs(CASES[0])
    seg = np.zeros((2, 96), np.int32)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = flash_attention(tq, tk, tv, causal=True,
                          q_segment_ids=torch.from_numpy(seg),
                          kv_segment_ids=torch.from_numpy(seg))
    torch.testing.assert_close(got, flash_attention(tq, tk, tv, causal=True),
                               atol=1e-6, rtol=1e-6)
    want = jax_flash(*map(jnp.asarray, (q, k, v)), causal=True,
                     q_segment_ids=jnp.asarray(seg),
                     kv_segment_ids=jnp.asarray(seg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_padded_dropout_mask_is_jax_mask():
    """The padded (segment-id) route keeps the padded (b * h + head, row,
    col) coordinates: its keep mask is JAX's dropout_mask_dense bit for
    bit, and so is the packed route's over (1, h, total_q, total_k)."""
    b, h, sq, sk, p = 2, 3, 40, 56, 0.2
    q, k = torch.zeros(b, h, sq, 8), torch.zeros(b, h, sk, 8)
    want = jprng.dropout_mask_dense(jnp.uint32(SEED), b, h, sq, sk, p)
    np.testing.assert_array_equal(keep_plain(q, k, p, SEED).numpy(),
                                  np.asarray(want))
    want = jprng.dropout_mask_dense(jnp.uint32(SEED), 1, h, 77, 91, p)
    np.testing.assert_array_equal(
        prng.dropout_mask_dense(SEED, 1, h, 77, 91, p).numpy(),
        np.asarray(want))


# ------------------------------------------------------------ interface

def _lengths(rng, batch, max_s):
    return rng.integers(max(1, max_s // 3), max_s + 1, size=batch)


def _packed(rng, lq, lk, h, h_kv, d):
    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return f(int(sum(lq)), h, d), f(int(sum(lk)), 2, h_kv, d)


@pytest.mark.parametrize("form,causal,dropout_p,grads", [
    ("unpadded", True, 0.2, True), ("kvpacked", True, 0.0, False),
    ("kvpacked", False, 0.2, False), ("qkvpacked", False, 0.2, True),
    ("flash_attn_func", True, 0.0, False)], ids=str)
def test_interface_matches_jax_in_both_input_forms(form, causal, dropout_p,
                                                   grads):
    """Each cu_seqlens entry point against JAX's (out, lse, S_dmask with
    return_attn_probs; where ``grads``, the gradients of the
    differentiable call), and the same tokens through flash_attention with
    the segment ids and positions of cu_seqlens_to_segments: the same
    function (C4). kvpacked and unpadded run per-sequence sq != sk, with
    an empty sequence."""
    rng = np.random.default_rng(11)
    h, h_kv, d = 2, 2, 64
    lq = _lengths(rng, 3, 40)
    lk = lq if form in ("qkvpacked", "flash_attn_func") else np.append(
        _lengths(rng, 2, 60), 0)
    q, kv = _packed(rng, lq, lk, h, h_kv, d)
    if form in ("qkvpacked", "flash_attn_func"):
        qkv = np.concatenate([q[:, None], kv], axis=1)
    cu_q, cu_k = cu_seqlens(lq), cu_seqlens(lk)
    kw = dict(dropout_seed=SEED if dropout_p else None)

    def call(mod, arrs, cuq, cuk, **extra):
        if form == "unpadded":
            return mod.flash_attn_unpadded_func(
                arrs[0], arrs[1][:, 0], arrs[1][:, 1], cuq, cuk, 40, 60,
                dropout_p, causal=causal, **kw, **extra)
        if form == "kvpacked":
            return mod.flash_attn_unpadded_kvpacked_func(
                arrs[0], arrs[1], cuq, cuk, 40, 60, dropout_p,
                causal=causal, **kw, **extra)
        if form == "qkvpacked":
            return mod.flash_attn_unpadded_qkvpacked_func(
                arrs[2], cuq, 40, dropout_p, causal=causal, **kw, **extra)
        return mod.flash_attn_func(arrs[2], cuq, dropout_p, 40,
                                   causal=causal, **kw, **extra)

    jarrs = [jnp.asarray(x) for x in (q, kv, qkv if "qkv" in form or
                                      form == "flash_attn_func" else q)]
    tarrs = [torch.from_numpy(x) for x in (q, kv, qkv if "qkv" in form or
                                           form == "flash_attn_func" else q)]
    want = call(jif, jarrs, jnp.asarray(cu_q), jnp.asarray(cu_k),
                return_attn_probs=True)
    got = call(tif, tarrs, torch.from_numpy(cu_q), torch.from_numpy(cu_k),
               return_attn_probs=True)
    _close(got[:2], want[:2], ["out", "lse"])
    assert got[1].shape == (1, h, int(lq.sum()))
    if dropout_p:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    else:
        assert got[2] is None and want[2] is None
    # The differentiable call, and the segment-id form of the same tokens.
    leaves = [x.clone().requires_grad_() for x in tarrs]
    out = call(tif, leaves, torch.from_numpy(cu_q), torch.from_numpy(cu_k))
    g = np.random.default_rng(12).standard_normal(out.shape).astype(
        np.float32)
    out.backward(torch.from_numpy(g))
    ji = 2 if form in ("qkvpacked", "flash_attn_func") else None

    def jloss(*arrs):
        return jnp.sum(call(jif, arrs, jnp.asarray(cu_q), jnp.asarray(cu_k))
                       * g)

    if grads:
        jgrads = jax.grad(jloss, argnums=(ji,) if ji else (0, 1))(*jarrs)
        tgrads = [leaves[ji].grad] if ji else [leaves[0].grad,
                                                leaves[1].grad]
        _close(tgrads, jgrads, ["grad"] * len(jgrads))
    qseg, qpos = cu_seqlens_to_segments(torch.from_numpy(cu_q), len(q))
    kseg, kpos = cu_seqlens_to_segments(torch.from_numpy(cu_k), len(kv))
    k_, v_ = torch.from_numpy(kv).unbind(1)
    by_seg = flash_attention(
        torch.from_numpy(q)[None], k_[None], v_[None], causal=causal,
        dropout_p=dropout_p, q_segment_ids=qseg[None],
        kv_segment_ids=kseg[None], q_positions=qpos[None],
        kv_positions=kpos[None], **kw)[0]
    torch.testing.assert_close(by_seg, out.detach(), atol=1e-6, rtol=1e-6)


def test_interface_refuses_unported_arguments():
    """The cu_seqlens functions take window_size, ALiBi and softcap through
    the segment form (per-sequence positions) and match JAX's."""
    from flash_attn_tpu.ops import interface as jif
    rng = np.random.default_rng(9)
    lens = [20, 7, 33]
    cu = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    q, k, v = (rng.standard_normal((int(cu[-1]), 1, 64)).astype(np.float32)
               for _ in range(3))
    for name, value in (("window_size", (8, 0)), ("alibi_slopes", [1.0]),
                        ("softcap", 30.0)):
        want = jif.flash_attn_unpadded_func(
            *(jnp.asarray(x) for x in (q, k, v, cu, cu)), 33, 33, 0.0,
            causal=True, **{name: value})
        got = tif.flash_attn_unpadded_func(
            *(torch.from_numpy(x) for x in (q, k, v, cu, cu)), 33, 33, 0.0,
            causal=True, **{name: value})
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-5, rtol=1e-5, err_msg=name)
    assert tif._get_block_size() == (128, 128)
    assert tif.flash_attn_varlen_func is tif.flash_attn_unpadded_func


# ------------------------------------------------------- classification

@pytest.mark.parametrize("causal", [False, True])
def test_classify_segment_block_matches_jax(causal):
    from flash_attn_tpu.kernels.common import classify_segment_block as jcls
    rng = np.random.default_rng(13)
    for _ in range(20):
        qs, ks = (rng.integers(-1, 3, size=8).astype(np.int32)
                  for _ in range(2))
        if rng.random() < 0.5:
            qs[:], ks[:] = qs[0], qs[0]
        qp, kp = (np.sort(rng.integers(0, 30, size=8)).astype(np.int32)
                  for _ in range(2))
        for bounds in (False, True):
            got = classify_segment_block(*map(torch.from_numpy,
                                              (qp, kp, qs, ks)),
                                         causal=causal,
                                         bounds_possible=bounds)
            want = jcls(*map(jnp.asarray, (qp, kp, qs, ks)), causal=causal,
                        bounds_possible=bounds)
            assert [bool(x) for x in got] == [bool(x) for x in want]


@pytest.mark.parametrize("causal", [False, True])
def test_plan_never_skips_a_visible_pair(causal):
    """The plan's classes (csrc/segments.cu, in plain torch): a dead tile
    pair holds no visible pair, a full one only visible pairs, and the dQ
    ranks of a query tile count its live key tiles in K2's launch order
    (last first). Where a row is in interval form (all but the random
    ids), each query's key interval and each key's query interval give
    exactly the segment mask."""
    for kind, b, sq, sk in (("packed", 1, 700, 700),
                            ("packed_qk", 1, 300, 520),
                            ("random", 2, 200, 330), ("padding", 3, 400, 400)):
        seg = Segments(*(torch.from_numpy(np.ascontiguousarray(x)) for x in
                         segment_layout(np.random.default_rng(0), kind, b,
                                        sq, sk)))
        plan = segment_plan_plain(seg, causal)
        cls = plan["cls"] & 3
        vis = (seg.q_seg[:, :, None] == seg.kv_seg[:, None]) \
            & (seg.q_seg[:, :, None] >= 0)
        if causal:
            vis &= seg.q_pos[:, :, None] >= seg.kv_pos[:, None]
        n_q, n_k = cls.shape[1:]
        vis = torch.nn.functional.pad(vis, (0, n_k * 128 - sk,
                                            0, n_q * 64 - sq))
        tiles = vis.reshape(b, n_q, 64, n_k, 128)
        any_vis, all_vis = tiles.any(4).any(2), tiles.all(4).all(2)
        assert not (any_vis & (cls == TILE_DEAD)).any(), kind
        assert (all_vis | (cls != TILE_FULL)).all(), kind
        order = range(n_k - 1, -1, -1)
        rank = plan["cls"] >> 2
        for bb in range(b):
            for qt in range(n_q):
                seen = 0
                for kt in order:
                    if cls[bb, qt, kt] != TILE_DEAD:
                        assert rank[bb, qt, kt] == seen
                        seen += 1
        assert plan["ivf"].tolist() == [int(kind != "random")] * b
        mask = vis[..., :sq, :sk]
        for bb in range(b):
            if not plan["ivf"][bb]:
                continue
            qiv, kiv = plan["qiv"][bb, :sq], plan["kiv"][bb, :sk]
            cols, rows = torch.arange(sk), torch.arange(sq)
            assert torch.equal((cols >= qiv[:, :1]) & (cols < qiv[:, 1:]),
                               mask[bb]), kind
            assert torch.equal((rows[:, None] >= kiv[:, 0])
                               & (rows[:, None] < kiv[:, 1]), mask[bb]), kind
