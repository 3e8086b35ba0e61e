"""Gradients of the port's flash_attention against the JAX package's.

The same numpy inputs and cotangents go to both. On the CPU the port's
autograd Function runs the plain twins of the forward and backward
kernels; JAX differentiates its Pallas kernels in interpret mode. fp32
tolerance: atol = rtol = 1e-4 on out, lse, dq, dk and dv (the two sum in
different orders; the observed gap is about 2e-6). Dropout cases use the
same seed on both sides, whose masks are bit-equal (test_torch_prng.py), so
they are held to the same tolerance. ``gradcheck`` holds the plain path's
analytic gradients to finite differences in float64. Gradients through
views of a packed qkv equal those of contiguous inputs within atol = rtol
= 1e-6 (the plain path may sum in another order). The kernels themselves
are tested on the card in test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.ops.attention import flash_attention as jax_flash_attention
from flash_attn_tpu_torch import flash_attention
from flash_attn_tpu_torch.utils.testing import packed_views

ATOL = RTOL = 1e-4
P_DROP, SEED = 0.17, 1234

# (b, sq, sk, h, h_kv, d, causal): the forward's cases in test_torch_attention.py
CASES = [
    (2, 128, 128, 2, 2, 64, True),
    (2, 128, 128, 2, 2, 64, False),
    (1, 96, 160, 2, 2, 64, True),    # sq < sk, top-left causal
    (1, 160, 96, 2, 2, 64, True),    # sq > sk, top-left causal
    (1, 80, 200, 2, 2, 64, False),   # sq != sk, non-causal
    (1, 300, 300, 2, 2, 64, True),   # ragged, not a tile multiple
    (1, 130, 130, 4, 2, 64, True),   # GQA
    (1, 64, 64, 1, 1, 128, True),    # head_dim 128
]


def _inputs(seed, b, sq, sk, h, h_kv, d):
    rng = np.random.default_rng(seed)

    def f(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    return (f(b, sq, h, d), f(b, sk, h_kv, d), f(b, sk, h_kv, d),
            f(b, sq, h, d), f(b, h, sq))


def _jax(q, k, v, dout, dlse, *, causal, dropout_p):
    def fn(q, k, v):
        return jax_flash_attention(
            q, k, v, causal=causal, return_lse=True, dropout_p=dropout_p,
            dropout_seed=SEED if dropout_p else None)

    (out, lse), vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    grads = vjp((jnp.asarray(dout), jnp.asarray(dlse)))
    return [np.asarray(x) for x in (out, lse, *grads)]


def _leaves(*xs):
    return [torch.from_numpy(x).requires_grad_() for x in xs]


def _close(got, want, names):
    for name, g, w in zip(names, got, want):
        np.testing.assert_allclose(g.detach().numpy(), w, atol=ATOL,
                                   rtol=RTOL, err_msg=name)


@pytest.mark.parametrize("dropout_p", [0.0, P_DROP])
@pytest.mark.parametrize("case", CASES, ids=str)
def test_grads_match_jax(case, dropout_p):
    """out, lse, dq, dk, dv; the port's out-only path (lse not returned)."""
    b, sq, sk, h, h_kv, d, causal = case
    q, k, v, dout, _ = _inputs(0, b, sq, sk, h, h_kv, d)
    want = _jax(q, k, v, dout, np.zeros((b, h, sq), np.float32),
                causal=causal, dropout_p=dropout_p)
    tq, tk, tv = _leaves(q, k, v)
    kw = dict(causal=causal, dropout_p=dropout_p,
              dropout_seed=SEED if dropout_p else None)
    out = flash_attention(tq, tk, tv, **kw)
    out.backward(torch.from_numpy(dout))
    with torch.no_grad():
        _, lse = flash_attention(tq, tk, tv, return_lse=True, **kw)
    _close([out, lse, tq.grad, tk.grad, tv.grad], want,
           ["out", "lse", "dq", "dk", "dv"])


@pytest.mark.parametrize("dropout_p", [0.0, P_DROP])
@pytest.mark.parametrize("case", [CASES[0], CASES[4], CASES[6]], ids=str)
def test_lse_cotangent_matches_jax(case, dropout_p):
    """return_lse=True, a loss on both outputs: the dlse fold into di."""
    b, sq, sk, h, h_kv, d, causal = case
    q, k, v, dout, dlse = _inputs(1, b, sq, sk, h, h_kv, d)
    want = _jax(q, k, v, dout, dlse, causal=causal, dropout_p=dropout_p)
    tq, tk, tv = _leaves(q, k, v)
    out, lse = flash_attention(tq, tk, tv, causal=causal, return_lse=True,
                               dropout_p=dropout_p,
                               dropout_seed=SEED if dropout_p else None)
    torch.autograd.backward([out, lse],
                            [torch.from_numpy(dout), torch.from_numpy(dlse)])
    _close([out, lse, tq.grad, tk.grad, tv.grad], want,
           ["out", "lse", "dq", "dk", "dv"])


def test_lse_only_loss_matches_jax():
    """A loss on the lse alone: the out cotangent is absent."""
    b, sq, sk, h, h_kv, d, causal = CASES[6]
    q, k, v, _, dlse = _inputs(2, b, sq, sk, h, h_kv, d)
    want = _jax(q, k, v, np.zeros((b, sq, h, d), np.float32), dlse,
                causal=causal, dropout_p=0.0)
    tq, tk, tv = _leaves(q, k, v)
    _, lse = flash_attention(tq, tk, tv, causal=causal, return_lse=True)
    lse.backward(torch.from_numpy(dlse))
    _close([tq.grad, tk.grad, tv.grad], want[2:], ["dq", "dk", "dv"])


@pytest.mark.parametrize("causal,dropout_p", [(True, 0.0), (True, 0.3),
                                              (False, 0.3)])
def test_gradcheck_plain_path_float64(causal, dropout_p):
    """Finite differences in float64 on a tiny GQA shape with sq != sk,
    through both outputs."""
    rng = np.random.default_rng(3)

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape)).requires_grad_()

    q, k, v = leaf(1, 5, 4, 8), leaf(1, 7, 2, 8), leaf(1, 7, 2, 8)

    def fn(q, k, v):
        return flash_attention(q, k, v, causal=causal, return_lse=True,
                               dropout_p=dropout_p,
                               dropout_seed=torch.tensor(7))

    assert torch.autograd.gradcheck(fn, (q, k, v))


def test_dropout_needs_seed_and_valid_p():
    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(ValueError, match="dropout_seed"):
        flash_attention(q, q, q, dropout_p=0.1)
    with pytest.raises(ValueError, match="dropout_p"):
        flash_attention(q, q, q, dropout_p=1.0, dropout_seed=0)


@pytest.mark.parametrize("dropout_p", [0.0, P_DROP])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_packed_qkv_view_grads_match_contiguous_and_jax(heads, dropout_p):
    """A loss through views of the fused projection (b, s, (h + 2 h_kv) d),
    as the GPT-2 block makes them: the packed gradient equals the
    contiguous inputs' gradients laid side by side, and JAX's."""
    h, h_kv = heads
    b, s, d = 2, 130, 64
    rng = np.random.default_rng(12)
    packed = rng.standard_normal((b, s, (h + 2 * h_kv) * d)).astype(
        np.float32)
    dout = rng.standard_normal((b, s, h, d)).astype(np.float32)
    kw = dict(causal=True, dropout_p=dropout_p,
              dropout_seed=SEED if dropout_p else None)
    qkv = torch.from_numpy(packed).requires_grad_()
    out = flash_attention(*packed_views(qkv, h, h_kv, d), **kw)
    out.backward(torch.from_numpy(dout))
    got = packed_views(qkv.grad, h, h_kv, d)

    leaves = _leaves(*(x.contiguous().detach().numpy()
                       for x in packed_views(torch.from_numpy(packed), h,
                                             h_kv, d)))
    flash_attention(*leaves, **kw).backward(torch.from_numpy(dout))
    for name, g, x in zip("qkv", got, leaves):
        torch.testing.assert_close(g, x.grad, atol=1e-6, rtol=1e-6,
                                   msg=f"d{name}")
    want = _jax(*(x.detach().numpy() for x in leaves), dout,
                np.zeros((b, h, s), np.float32), causal=True,
                dropout_p=dropout_p)
    _close([out, *got], [want[0], *want[2:]], ["out", "dq", "dk", "dv"])
