"""flash_attn_tpu_torch.flash_attention against the JAX package.

The same numpy inputs go to both. On the CPU the port runs the kernel's
plain-torch twin and JAX runs its Pallas kernel in interpret mode. fp32
parity tolerance: atol = rtol = 1e-5 (the two sum in different orders; the
observed gap is ~1e-6). bf16 is held to the repo's 2x rule against the
port's fp32 oracle. Views of a packed qkv, as the GPT-2 block hands them
over, give what contiguous copies give within atol = rtol = 1e-6 (the
plain path's sums may take another order on strided operands). The kernel
itself is tested on the card in test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.ops.attention import flash_attention as jax_flash_attention
from flash_attn_tpu.reference import attention_ref as jax_attention_ref
from flash_attn_tpu_torch import flash_attention
from flash_attn_tpu_torch.kernels.common import (
    check_rows,
    kernel_operand,
    rows_ok,
)
from flash_attn_tpu_torch.reference import attention_ref
from flash_attn_tpu_torch.utils.testing import (
    assert_two_x_bound,
    packed_views,
    random_qkv,
)

ATOL = RTOL = 1e-5

# (b, sq, sk, h, h_kv, d, causal)
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


def _np_qkv(seed, b, sq, sk, h, h_kv, d):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, d)).astype(np.float32)
    k = rng.standard_normal((b, sk, h_kv, d)).astype(np.float32)
    v = rng.standard_normal((b, sk, h_kv, d)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("case", CASES, ids=str)
def test_matches_jax_fp32(case):
    b, sq, sk, h, h_kv, d, causal = case
    q, k, v = _np_qkv(0, b, sq, sk, h, h_kv, d)
    out_j, lse_j = jax_flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        return_lse=True,
    )
    out_t, lse_t = flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, return_lse=True,
    )
    assert out_t.shape == (b, sq, h, d) and lse_t.shape == (b, h, sq)
    assert out_t.dtype == torch.float32 and lse_t.dtype == torch.float32
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j),
                               atol=ATOL, rtol=RTOL)


def test_bhsd_layout_and_scale_match_jax():
    q, k, v = _np_qkv(1, 1, 100, 100, 2, 2, 64)
    q, k, v = (np.ascontiguousarray(x.transpose(0, 2, 1, 3)) for x in (q, k, v))
    out_j = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, layout="bhsd",
                                softmax_scale=0.3)
    out_t = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), causal=True, layout="bhsd",
                            softmax_scale=0.3)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_oracle_matches_jax_reference(causal):
    q, k, v = _np_qkv(2, 2, 64, 96, 2, 2, 64)
    tr = lambda x: np.ascontiguousarray(x.transpose(0, 2, 1, 3))  # noqa: E731
    q, k, v = tr(q), tr(k), tr(v)
    ref_j = jax_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal=causal)
    ref_t = attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(ref_t.numpy(), np.asarray(ref_j),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_two_x_rule(causal):
    q, k, v = random_qkv(np.random.default_rng(3), 2, 200, 200, 4, 64,
                         torch.bfloat16, h_kv=2)
    out = flash_attention(q, k, v, causal=causal)
    assert out.dtype == torch.bfloat16
    tr = lambda x: x.transpose(1, 2)  # noqa: E731
    ref32 = attention_ref(tr(q), tr(k), tr(v), causal=causal)
    ref16 = attention_ref(tr(q), tr(k), tr(v), causal=causal, upcast=False)
    assert_two_x_bound(tr(out), ref32, ref16, label=f"bf16 causal={causal}")


@pytest.mark.parametrize("name,value", [
    ("window_size", (16, 0)), ("alibi_slopes", [1.0]), ("softcap", 30.0),
    ("qk_quant", "int8"), ("num_sinks", 4), ("window_cell", (16, 256)),
])
def test_unported_arguments_raise(name, value):
    """qk_quant (M8) and window_cell (M4b) still raise, naming their ROADMAP
    items; the M4 terms run and match JAX (num_sinks with a causal band)."""
    if name in ("qk_quant", "window_cell"):
        q = torch.zeros(1, 8, 1, 64)
        item = "M8" if name == "qk_quant" else "M4b"
        with pytest.raises(NotImplementedError,
                           match=f"ROADMAP port item {item}"):
            flash_attention(q, q, q, **{name: value})
        return
    q, k, v = _np_qkv(4, 1, 48, 48, 1, 1, 64)
    kw = {name: value, "causal": name != "softcap", "return_lse": True}
    if name == "num_sinks":
        kw["window_size"] = (8, 0)
    out_j, lse_j = jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), **kw)
    out_t, lse_t = flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v), **kw)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=ATOL,
                               rtol=RTOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), atol=ATOL,
                               rtol=RTOL)


# (h, h_kv): MHA and GQA; dropout 0 and 0.1
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_packed_qkv_views_match_contiguous_and_jax(heads, dropout_p):
    """The op hands the kernels transposed views of the packed projection
    (no copies): out and lse equal the contiguous inputs' and JAX's."""
    h, h_kv = heads
    b, s, d = 2, 130, 64
    rng = np.random.default_rng(11)
    qkv = torch.from_numpy(
        rng.standard_normal((b, s, (h + 2 * h_kv) * d)).astype(np.float32))
    views = packed_views(qkv, h, h_kv, d)
    assert not any(x.is_contiguous() for x in views)
    assert all(rows_ok(x.transpose(1, 2)) for x in views)
    kw = dict(causal=True, return_lse=True, dropout_p=dropout_p,
              dropout_seed=7 if dropout_p else None)
    out_v, lse_v = flash_attention(*views, **kw)
    out_c, lse_c = flash_attention(*(x.contiguous() for x in views), **kw)
    torch.testing.assert_close(out_v, out_c, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse_v, lse_c, atol=1e-6, rtol=1e-6)
    out_j, lse_j = jax_flash_attention(
        *(jnp.asarray(x.contiguous().numpy()) for x in views), **kw)
    np.testing.assert_allclose(out_v.numpy(), np.asarray(out_j),
                               atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(lse_v.numpy(), np.asarray(lse_j),
                               atol=ATOL, rtol=RTOL)


def test_stride_check_rejects_misaligned_rows():
    """The kernels take a (b, h, s, d) operand in place only when its last
    dimension is contiguous and every row starts on a 16-byte boundary;
    anything else is refused by the check and copied by kernel_operand."""
    qkv = torch.zeros((2, 100, 3, 4, 64), dtype=torch.bfloat16)
    views = [x.transpose(1, 2) for x in qkv.unbind(2)]
    check_rows("views", *views)
    assert all(kernel_operand(x) is x for x in views)
    wide = torch.zeros((2, 100, 4, 65), dtype=torch.bfloat16)
    odd = wide[..., :64].transpose(1, 2)  # rows 130 bytes apart
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        check_rows("odd", odd)
    fixed = kernel_operand(odd)
    assert fixed is not odd and rows_ok(fixed) and torch.equal(fixed, odd)
    with pytest.raises(ValueError, match="contiguous"):
        check_rows("transposed", torch.zeros((2, 4, 64, 8)).transpose(2, 3))
