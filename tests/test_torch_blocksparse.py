"""The port's blocksparse attention against the JAX package's.

The same numpy inputs, in fp32, go to the JAX op (its Pallas kernels in
interpret mode on the CPU, as tests/test_blocksparse.py runs them) and to
the port's (the plain twins of K8a-c on the CPU). Out and lse are held to
atol 2e-5 and gradients to atol 5e-4 / rtol 1e-3, the tolerances of the
JAX tests. JAX's band routing is switched off here: it sends band-shaped
masks to the dense window kernel, which agrees only within allclose
(ROADMAP C6) and which the port does not route to yet (M4b).

Key padding: the JAX kernels skip the padding mask on FULL tiles (ROADMAP
C9), so the cases compared with JAX use layouts without one (s <= 512 at
JAX's 1024-wide default tiles), and the port is held to the oracle
``attention_ref(mask=...)`` on full tiles with padding. The kernels
themselves are tested on the card in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flash_attn_tpu.ops.blocksparse as jax_ops
from flash_attn_tpu.kernels import blocksparse as jax_kernels
from flash_attn_tpu.kernels import prng as jax_prng
from flash_attn_tpu.models import blocksparse_modules as jax_modules
from flash_attn_tpu.reference import build_mask
from flash_attn_tpu_torch.kernels import blocksparse as bs
from flash_attn_tpu_torch.kernels.prng import dropout_mask_dense
from flash_attn_tpu_torch.models.blocksparse_modules import (
    FlashBlocksparseMHA,
    LocalGlobalSparsityConfig,
)
from flash_attn_tpu_torch.models.convert import mha_from_jax_params
from flash_attn_tpu_torch.ops.blocksparse import (
    blocksparse_attention,
    expand_blockmask,
    flash_blocksparse_attn_func,
)
from flash_attn_tpu_torch.reference import attention_ref

OUT_ATOL = 2e-5
GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3


@pytest.fixture(autouse=True)
def generic_jax_kernels(monkeypatch):
    monkeypatch.setattr(jax_ops, "ENABLE_BAND_ROUTE", False)


def _rand_mask(rng, sq, sk, sparsity=0.35):
    return rng.random(((sq + 15) // 16, (sk + 255) // 256)) < sparsity


def _qkv(rng, b, s, h, d):
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(3)]


def _leaves(*xs):
    return [torch.from_numpy(x).requires_grad_() for x in xs]


def _oracle(q, k, v, mask, **kw):
    """attention_ref on (b, s, h, d) torch tensors with an element mask."""
    def tr(x):
        return x.transpose(1, 2)

    return tr(attention_ref(tr(q), tr(k), tr(v), mask=mask, **kw))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("seqlen", [256, 512, 600])
def test_fwd_matches_jax(causal, seqlen):
    rng = np.random.default_rng(seqlen + causal)
    q, k, v = _qkv(rng, 2, seqlen, 2, 64)
    bm = _rand_mask(rng, seqlen, seqlen)
    out_j, lse_j = jax_ops.blocksparse_attention(
        *map(jnp.asarray, (q, k, v)), bm, causal=causal, return_lse=True)
    out, lse = blocksparse_attention(*map(torch.from_numpy, (q, k, v)), bm,
                                     causal=causal, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                               atol=OUT_ATOL)
    mask = expand_blockmask(bm, seqlen, seqlen)
    if causal:
        mask = mask & torch.ones_like(mask).tril()
    np.testing.assert_allclose(out.numpy(), _oracle(
        *map(torch.from_numpy, (q, k, v)), mask).numpy(), atol=OUT_ATOL)


@pytest.mark.parametrize("causal,seqlen", [(True, 512), (False, 600)])
def test_bwd_matches_jax(causal, seqlen):
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, 2, seqlen, 2, 64)
    g = rng.standard_normal(q.shape).astype(np.float32)
    bm = _rand_mask(rng, seqlen, seqlen)

    def loss(q, k, v):
        return jnp.sum(jax_ops.blocksparse_attention(
            q, k, v, bm, causal=causal) * g)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    leaves = _leaves(q, k, v)
    blocksparse_attention(*leaves, bm, causal=causal).backward(
        torch.from_numpy(g))
    for name, x, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"d{name}")


def test_dropout_and_padding_match_jax():
    """Dropout 0.17 and key padding (300 of 512 keys valid in row 0): out
    and gradients equal JAX's, the mask the port regenerates equals JAX's
    dropout_mask_dense bit for bit, and the oracle with that mask agrees.
    Padded query rows give 0 on both sides."""
    rng = np.random.default_rng(6)
    b, s, h, d, p, seed = 2, 512, 2, 64, 0.17, 3
    kpm = np.ones((b, s), bool)
    kpm[0, 300:] = False
    q, k, v = _qkv(rng, b, s, h, d)
    g = rng.standard_normal(q.shape).astype(np.float32)
    bm = _rand_mask(rng, s, s)
    assert not np.asarray(jax_kernels.build_layout(bm, sq=s, sk=s).kv_full
                          ).any()  # no full tile: C9 cannot show here
    kw = dict(causal=False, dropout_p=p)

    def loss(q, k, v):
        out = jax_ops.blocksparse_attention(
            q, k, v, bm, key_padding_mask=jnp.asarray(kpm),
            dropout_seed=jnp.uint32(seed), **kw)
        return jnp.sum(out * g), out

    (_, out_j), want = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                          has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = _leaves(q, k, v)
    out = blocksparse_attention(*leaves, bm, key_padding_mask=torch.from_numpy(
        kpm), dropout_seed=seed, **kw)
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=OUT_ATOL)
    for name, x, w in zip("qkv", leaves, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL,
                                   err_msg=f"d{name}")
    keep = dropout_mask_dense(seed, b, h, s, s, p)
    assert np.array_equal(keep.numpy(), np.asarray(
        jax_prng.dropout_mask_dense(jnp.uint32(seed), b, h, s, s, p)))
    t_kpm = torch.from_numpy(kpm)
    mask = expand_blockmask(bm, s, s) & (t_kpm[:, None, :, None]
                                         & t_kpm[:, None, None, :])
    ref = _oracle(*map(torch.from_numpy, (q, k, v)), mask, dropout_mask=keep,
                  dropout_p=p)
    np.testing.assert_allclose(out.detach().numpy(), ref.numpy(),
                               atol=5e-5, rtol=1e-4)
    assert not out[0, 300:].any()


def test_zero_row_blocks_match_jax():
    """q rows with no live cell give out 0 and lse -inf (head_dim 32 is
    padded to 64 by the port, to 128 by JAX)."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, 1, 384, 1, 32)
    bm = np.zeros((384 // 16 + 1, 2), bool)
    bm[: 128 // 16, :] = True  # only the first 128 rows attend anywhere
    out_j, lse_j = jax_ops.blocksparse_attention(
        *map(jnp.asarray, (q, k, v)), bm, return_lse=True)
    out, lse = blocksparse_attention(*map(torch.from_numpy, (q, k, v)), bm,
                                     return_lse=True)
    assert torch.equal(out[:, 128:], torch.zeros_like(out[:, 128:]))
    assert torch.isneginf(lse[:, :, 128:]).all()
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_j),
                               atol=OUT_ATOL)
    layout = bs.build_layout(bm, sq=384, sk=384)
    assert (layout.kv_counts[2:] == 0).all()  # q tiles 2..5 walk nothing


def test_packed_cu_seqlens_roundtrip_matches_jax():
    rng = np.random.default_rng(8)
    h, d, max_s = 2, 32, 256
    lengths = [200, 256, 100]
    cu = np.concatenate([[0], np.cumsum(lengths)]).astype(np.int32)
    qkv = rng.standard_normal((sum(lengths), 3, h, d)).astype(np.float32)
    g = rng.standard_normal((sum(lengths), h, d)).astype(np.float32)
    bm = _rand_mask(rng, max_s, max_s, sparsity=0.5)

    def loss(x):
        out = jax_ops.flash_blocksparse_attn_func(x, cu, bm, 0.0, max_s,
                                                  causal=True)
        return jnp.sum(out * g), out

    (_, out_j), grad_j = jax.value_and_grad(loss, has_aux=True)(
        jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    out = flash_blocksparse_attn_func(x, torch.from_numpy(cu), bm, 0.0,
                                      max_s, causal=True)
    out.backward(torch.from_numpy(g))
    assert out.shape == (sum(lengths), h, d)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_j),
                               atol=OUT_ATOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad_j),
                               atol=GRAD_ATOL, rtol=GRAD_RTOL)
    emask = expand_blockmask(bm, max_s, max_s)
    for i, n in enumerate(lengths):  # each sequence in local coordinates
        sl = slice(int(cu[i]), int(cu[i] + n))
        seq = torch.from_numpy(qkv[sl][None])
        ref = _oracle(*seq.unbind(2), emask[:n, :n], causal=True)
        np.testing.assert_allclose(out[sl].detach().numpy(), ref[0].numpy(),
                                   atol=5e-5, rtol=1e-4, err_msg=f"seq {i}")


def test_blocksparse_mha_with_carried_weights_matches_jax():
    rng = np.random.default_rng(9)
    b, s, e, h = 2, 300, 64, 2
    x = rng.standard_normal((b, s, e)).astype(np.float32)
    jmha = jax_modules.FlashBlocksparseMHA(
        embed_dim=e, num_heads=h,
        sparsity_config=jax_modules.LocalGlobalSparsityConfig(window=256),
        causal=True, max_seq_length=512)
    params = jmha.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = jmha.apply(params, jnp.asarray(x))
    mha = FlashBlocksparseMHA(e, h, LocalGlobalSparsityConfig(window=256),
                              causal=True, max_seq_length=512, device="cpu")
    mha_from_jax_params(jax.tree_util.tree_map(np.asarray, params), mha)
    with torch.no_grad():
        got = mha(torch.from_numpy(x))
    assert got.shape == (b, s, e)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=OUT_ATOL)


def test_full_tiles_with_padding_follow_the_oracle():
    """ROADMAP C9. An all-ones mask makes every port tile FULL (and, at
    block_q = block_k = 256, every JAX tile); keys valid up to 300 of 512.
    The port never attends a padded key, as the oracle; out and gradients
    match it."""
    rng = np.random.default_rng(10)
    b, s, h, d = 2, 512, 2, 64
    q, k, v = _qkv(rng, b, s, h, d)
    g = torch.from_numpy(rng.standard_normal(q.shape).astype(np.float32))
    kpm = torch.ones((b, s), dtype=torch.bool)
    kpm[:, 300:] = False
    bm = np.ones((s // 16, s // 256), bool)
    layout = bs.build_layout(bm, sq=s, sk=s, block_q=256, block_k=256)
    assert layout.kv_full.all() and layout.q_full.all()
    leaves = _leaves(q, k, v)
    out = blocksparse_attention(*leaves, layout, key_padding_mask=kpm)
    out.backward(g)
    ref_leaves = _leaves(q, k, v)
    ref = _oracle(*ref_leaves, kpm[:, None, :, None] & kpm[:, None, None, :])
    ref.backward(g)
    np.testing.assert_allclose(out.detach().numpy(), ref.detach().numpy(),
                               atol=OUT_ATOL)
    for a, r in zip(leaves, ref_leaves):
        np.testing.assert_allclose(a.grad.numpy(), r.grad.numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("sq,sk", [(600, 600), (200, 520), (520, 200)])
def test_layout_lists_and_full_flags(causal, sq, sk):
    """Brute force over the element mask: a (q tile, kv tile) pair is
    listed iff it holds a visible element (both lists), and FULL iff every
    element of it (rows < sq) is visible."""
    rng = np.random.default_rng(sq + sk + causal)
    bm = _rand_mask(rng, sq, sk, sparsity=0.6)
    bm[:, 0] = True
    lay = bs.build_layout(bm, sq=sq, sk=sk, causal=causal)
    vis = lay.visible("cpu").numpy()
    nq, nk = lay.sq_pad // bs.TILE_Q, lay.sk_pad // bs.TILE_K
    listed = np.zeros((nq, nk), bool)
    full = np.zeros((nq, nk), bool)
    for i in range(nq):
        ids = lay.kv_indices[i, : lay.kv_counts[i]]
        listed[i, ids] = True
        full[i, ids] = lay.kv_full[i, : lay.kv_counts[i]] == 1
    listed_t = np.zeros((nk, nq), bool)
    for j in range(nk):
        ids = lay.q_indices[j, : lay.q_counts[j]]
        listed_t[j, ids] = True
        assert (lay.q_full[j, : lay.q_counts[j]] == full[ids, j]).all()
    assert np.array_equal(listed, listed_t.T)
    for i in range(nq):
        for j in range(nk):
            tile = vis[i * 64:(i + 1) * 64, j * 64:(j + 1) * 64]
            assert listed[i, j] == tile.any(), (i, j)
            if full[i, j]:
                assert tile.all() and tile.shape[1] == 64, (i, j)
    assert full.any()


@pytest.mark.parametrize("sk", [64, 130, 600])
def test_key_bits_pack_each_kv_tiles_valid_keys(sk):
    """K8a and K8c read key padding as one 64-bit word per (batch row, kv
    tile): bit i of word t is key 64 t + i, set iff it is inside sk and
    k_valid marks it; the words past sk are 0. None without padding."""
    rng = np.random.default_rng(sk)
    k_valid = torch.from_numpy(rng.random((3, sk)) < 0.7).to(torch.uint8)
    k_valid[1] = 0
    k_valid[2] = 1
    sk_pad = bs.build_layout(np.ones((1, -(-sk // 256)), bool), sq=16,
                             sk=sk).sk_pad
    words = bs.key_bits(k_valid, sk_pad)
    assert words.dtype == torch.int64 and words.shape == (3, sk_pad // 64)
    got = (words.numpy()[..., None].view(np.uint64)
           >> np.arange(64, dtype=np.uint64)) & np.uint64(1)
    want = np.zeros((3, sk_pad), bool)
    want[:, :sk] = k_valid.numpy() != 0
    assert np.array_equal(got.reshape(3, sk_pad).astype(bool), want)
    assert bs.key_bits(None, sk_pad) is None


def test_band_mask_runs_the_blocksparse_kernels_and_convert_blockmask():
    """A band-shaped cell mask (which JAX routes to its window kernel) runs
    the port's blocksparse path and agrees with the oracle and with JAX's
    generic kernels. convert_blockmask compiles at 16 rows and 256 keys per
    cell, and a layout refuses inputs of another length."""
    s = 512
    bm = _band_cells(s, s, causal=True, left=300)
    assert bs.detect_band(bm, sq=s, sk=s, causal=True) is not None
    layout = bs.convert_blockmask(bm, True)
    want = bs.build_layout(bm, sq=s, sk=s, causal=True)
    for name in ("kv_indices", "kv_counts", "kv_full", "q_indices",
                 "q_counts", "q_full", "rowmask"):
        assert np.array_equal(getattr(layout, name), getattr(want, name))
    rng = np.random.default_rng(12)
    q, k, v = _qkv(rng, 1, s, 2, 64)
    out = blocksparse_attention(*map(torch.from_numpy, (q, k, v)), layout,
                                causal=True)
    out_j = jax_ops.blocksparse_attention(*map(jnp.asarray, (q, k, v)), bm,
                                          causal=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), atol=OUT_ATOL)
    mask = expand_blockmask(bm, s, s) & torch.ones((s, s), dtype=bool).tril()
    np.testing.assert_allclose(out.numpy(), _oracle(
        *map(torch.from_numpy, (q, k, v)), mask).numpy(), atol=OUT_ATOL)
    x = torch.zeros((1, 256, 1, 64))
    with pytest.raises(ValueError, match=f"sq={s}"):
        blocksparse_attention(x, x, x, layout, causal=True)


def _band_cells(sq, sk, *, causal, left=None, right=None, sinks=0):
    """tests/test_band_route.py's band cell masks."""
    em = np.asarray(build_mask(sq, sk, causal=causal, window_left=left,
                               window_right=right))
    if sinks:
        em = em | (np.arange(sk)[None, :] < sinks)
        if causal:
            em &= np.arange(sq)[:, None] >= np.arange(sk)[None, :]
    nr, nc = -(-sq // 16), -(-sk // 256)
    p = np.zeros((nr * 16, nc * 256), bool)
    p[:sq, :sk] = em
    return p.reshape(nr, 16, nc, 256).any(axis=(1, 3))


def _fuzz_masks():
    """The fuzz of tests/test_band_route.py:114 (same generator and seed),
    its fixed cases, and non-bands."""
    rng = np.random.default_rng(7)
    sq = 2048
    cases = [(True, 700, None, 0), (True, 1024, None, 512),
             (False, 300, 500, 0), (False, None, 900, 0),
             (True, None, None, 0)]
    for _ in range(40):
        causal = bool(rng.integers(0, 2))
        left = int(rng.integers(0, sq)) if rng.random() < 0.8 else None
        right = (None if causal or rng.random() < 0.3
                 else int(rng.integers(0, sq // 2)))
        sinks = int(rng.integers(0, 4)) * 256 if rng.random() < 0.4 else 0
        if left is None and right is None and not causal:
            continue
        cases.append((causal, left, right, sinks))
    masks = [(c, _band_cells(sq, sq, causal=c, left=lft, right=r, sinks=g))
             for c, lft, r, g in cases]
    rand = np.random.default_rng(0).random((sq // 16, sq // 256)) < 0.5
    hole = masks[0][1].copy()
    hole[60, int(np.flatnonzero(hole[60])[0])] = False
    return masks + [(False, rand), (True, rand), (True, hole)]


def test_detect_band_matches_jax():
    """detect_band equals JAX's (and JAX's build_layout().band_route) on
    every fuzz mask, and a detected band reconstructs the cell mask."""
    sq = 2048
    routed = 0
    for causal, bm in _fuzz_masks():
        route = bs.detect_band(bm, sq=sq, sk=sq, causal=causal)
        assert route == jax_kernels.detect_band(bm, sq=sq, sk=sq,
                                                causal=causal)
        assert jax_kernels.build_layout(bm, sq=sq, sk=sq, causal=causal
                                        ).band_route == route
        if route is None:
            continue
        routed += 1
        wl, wr, g = route
        r = np.arange(bm.shape[0])[:, None] * 16
        cc = np.arange(bm.shape[1])[None, :]
        lo = 0 if wl is None else np.maximum((r - wl) // 256, 0)
        hi = bm.shape[1] - 1 if wr is None else np.minimum(
            (r + 15 + wr) // 256, bm.shape[1] - 1)
        if causal:
            hi = np.minimum(hi, (r + 15) // 256)
        pred = ((cc >= lo) & (cc <= hi)) | (cc < g // 256)
        want = bm.copy()
        if causal:
            pred &= cc * 256 <= r + 15
            want &= cc * 256 <= r + 15
        assert np.array_equal(pred, want)
    assert routed >= 40


def test_plain_path_gradcheck():
    """The op's analytic gradients (the twins' backward, with dropout, key
    padding, a padded head dim and the lse output) against finite
    differences in float64."""
    rng = np.random.default_rng(11)
    b, s, h, d = 1, 40, 1, 8
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d)))
               .requires_grad_() for _ in range(3))
    kpm = torch.ones((b, s), dtype=torch.bool)
    kpm[0, 33:] = False
    bm = np.array([[1], [0], [1]], bool)

    def fn(q, k, v):
        out, lse = blocksparse_attention(
            q, k, v, bm, causal=True, key_padding_mask=kpm, dropout_p=0.2,
            dropout_seed=5, return_lse=True)
        return out, torch.where(torch.isinf(lse), 0.0, lse)

    assert torch.autograd.gradcheck(fn, (q, k, v), eps=1e-6, atol=1e-5)


def test_op_operands_are_views_and_module_layouts_are_cached():
    """The kernels take q, k, v of a packed qkv and the op's (b, s, h, d)
    tensors in place (transposed views, no copies); a misaligned or
    non-unit last stride takes a copy. FlashBlocksparseAttention compiles a
    layout once per (length, causal)."""
    qkv = torch.zeros((2, 100, 3, 4, 64), dtype=torch.bfloat16)
    for x in qkv.unbind(2):
        view = x.transpose(1, 2)
        assert bs.rows_ok(view) and bs.kernel_operand(view) is view
    wide = torch.zeros((2, 100, 4, 68), dtype=torch.bfloat16)
    odd = wide[..., :64].transpose(1, 2)  # heads 136 bytes apart
    assert not bs.rows_ok(odd) and bs.rows_ok(bs.kernel_operand(odd))
    assert not bs.rows_ok(torch.zeros((2, 4, 64, 8)).transpose(2, 3))
    attn = FlashBlocksparseMHA(64, 2, LocalGlobalSparsityConfig(window=256),
                               causal=True, max_seq_length=512,
                               device="cpu").inner_attn
    first = attn.layout(300, True)
    assert attn.layout(300, True) is first
    assert attn.layout(300, False) is not first
    with pytest.raises(ValueError, match="max_seq_length"):
        attn.layout(600, True)
