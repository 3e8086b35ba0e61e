"""flash_attn_tpu_torch.flash_attention against the JAX package.

The same numpy inputs go to both. On the CPU the port runs the kernel's
plain-torch twin and JAX runs its Pallas kernel in interpret mode. fp32
parity tolerance: atol = rtol = 1e-5 (the two sum in different orders; the
observed gap is ~1e-6). bf16 is held to the repo's 2x rule against the
port's fp32 oracle. The kernel itself is tested on the card in
test_torch_kernels.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flash_attn_tpu.ops.attention import flash_attention as jax_flash_attention
from flash_attn_tpu.reference import attention_ref as jax_attention_ref
from flash_attn_tpu_torch import flash_attention
from flash_attn_tpu_torch.reference import attention_ref
from flash_attn_tpu_torch.utils.testing import assert_two_x_bound, random_qkv

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
    ("dropout_p", 0.1), ("window_size", (16, 0)), ("alibi_slopes", [1.0]),
    ("softcap", 30.0), ("q_segment_ids", np.zeros((1, 8))),
    ("qk_quant", "int8"), ("num_sinks", 4), ("window_cell", (16, 256)),
])
def test_unported_arguments_raise(name, value):
    q = torch.zeros(1, 8, 1, 64)
    with pytest.raises(NotImplementedError, match="ROADMAP port item"):
        flash_attention(q, q, q, **{name: value})
