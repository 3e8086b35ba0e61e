"""The reference's cu_seqlens entry points (port of
``flash_attn_tpu/ops/interface.py``):

  - ``flash_attn_unpadded_qkvpacked_func`` (reference :151-176)
  - ``flash_attn_unpadded_kvpacked_func``  (reference :179-210)
  - ``flash_attn_unpadded_func``           (reference :213-243)
  - ``flash_attn_func``, the legacy alias  (reference :246-252)
  - the ``flash_attn_varlen_*`` names of later upstream versions.

Inputs are packed token-major tensors and int32 ``cu_seqlens`` (batch +
1,). The packed batch runs as one super-sequence (b = 1) whose segment ids
and per-sequence positions come from cu_seqlens, through K1/K2's segment
form: no gather or scatter, and on the card no tile across two sequences
is loaded unless it holds a visible pair. Dropout hashes the super-
sequence's coordinates (b = 1, head, packed row, packed col), as the JAX
interface does, and takes an explicit ``dropout_seed``.
``return_attn_probs=True`` returns (out, lse (1, h, total_q), S_dmask),
S_dmask the boolean keep mask (1, h, total_q, total_k) of
``kernels/prng.py`` ``dropout_mask_dense`` (None at dropout 0).
"""

from __future__ import annotations

from flash_attn_tpu_torch.kernels import prng
from flash_attn_tpu_torch.kernels.flash_fwd import BLOCK_M, BLOCK_N
from flash_attn_tpu_torch.ops.attention import flash_attention
from flash_attn_tpu_torch.ops.packing import cu_seqlens_to_segments


def _packed_attention(q, k, v, cu_seqlens_q, cu_seqlens_k, dropout_p,
                      softmax_scale, causal, return_attn_probs, dropout_seed,
                      block_sizes, window_size, alibi_slopes, softcap):
    if block_sizes is not None:
        raise ValueError("block_sizes are the TPU kernels' tiles; the port's "
                         "kernels fix their own (_get_block_size)")
    total_q, h, _ = q.shape
    total_k = k.shape[0]
    qseg, qpos = cu_seqlens_to_segments(cu_seqlens_q.to(q.device), total_q)
    kseg, kpos = cu_seqlens_to_segments(cu_seqlens_k.to(q.device), total_k)
    kw = dict(causal=causal, softmax_scale=softmax_scale,
              q_segment_ids=qseg[None], kv_segment_ids=kseg[None],
              q_positions=qpos[None], kv_positions=kpos[None],
              dropout_p=dropout_p, dropout_seed=dropout_seed,
              # The segment form compares per-sequence positions, so bands
              # and ALiBi distances are exact per packed sequence.
              window_size=window_size, alibi_slopes=alibi_slopes,
              softcap=softcap)
    if not return_attn_probs:
        return flash_attention(q[None], k[None], v[None], **kw)[0]
    out, lse = flash_attention(q[None], k[None], v[None], return_lse=True,
                               **kw)
    s_dmask = None
    if dropout_p > 0.0:
        s_dmask = prng.dropout_mask_dense(dropout_seed, 1, h, total_q,
                                          total_k, dropout_p,
                                          device=q.device)
    return out[0], lse, s_dmask


def flash_attn_unpadded_func(q, k, v, cu_seqlens_q, cu_seqlens_k,
                             max_seqlen_q, max_seqlen_k, dropout_p,
                             softmax_scale=None, causal=False,
                             return_attn_probs=False, *, dropout_seed=None,
                             block_sizes=None, window_size=None,
                             alibi_slopes=None, softcap=None):
    """Packed varlen attention: q (total_q, h, d), k and v (total_k, h_kv,
    d), cu_seqlens_* (batch + 1,). ``max_seqlen_*`` are taken for API
    parity (the plan is built from the data). Causal is top-left inside
    each sequence, also where its query and key lengths differ."""
    del max_seqlen_q, max_seqlen_k
    return _packed_attention(q, k, v, cu_seqlens_q, cu_seqlens_k, dropout_p,
                             softmax_scale, causal, return_attn_probs,
                             dropout_seed, block_sizes, window_size,
                             alibi_slopes, softcap)


def flash_attn_unpadded_kvpacked_func(q, kv, cu_seqlens_q, cu_seqlens_k,
                                      max_seqlen_q, max_seqlen_k, dropout_p,
                                      softmax_scale=None, causal=False,
                                      return_attn_probs=False, **kwargs):
    """q and packed kv (total_k, 2, h_kv, d); k and v are views of it."""
    return flash_attn_unpadded_func(
        q, kv[:, 0], kv[:, 1], cu_seqlens_q, cu_seqlens_k, max_seqlen_q,
        max_seqlen_k, dropout_p, softmax_scale, causal, return_attn_probs,
        **kwargs)


def flash_attn_unpadded_qkvpacked_func(qkv, cu_seqlens, max_seqlen,
                                       dropout_p, softmax_scale=None,
                                       causal=False, return_attn_probs=False,
                                       **kwargs):
    """Packed qkv (total, 3, h, d) self-attention; q, k and v are views of
    it."""
    return flash_attn_unpadded_func(
        qkv[:, 0], qkv[:, 1], qkv[:, 2], cu_seqlens, cu_seqlens, max_seqlen,
        max_seqlen, dropout_p, softmax_scale, causal, return_attn_probs,
        **kwargs)


def flash_attn_func(qkv, cu_seqlens, dropout_p, max_s, softmax_scale=None,
                    causal=False, return_attn_probs=False, **kwargs):
    """Legacy alias with the pre-rename argument order."""
    return flash_attn_unpadded_qkvpacked_func(
        qkv, cu_seqlens, max_s, dropout_p, softmax_scale, causal,
        return_attn_probs, **kwargs)


flash_attn_varlen_func = flash_attn_unpadded_func
flash_attn_varlen_kvpacked_func = flash_attn_unpadded_kvpacked_func
flash_attn_varlen_qkvpacked_func = flash_attn_unpadded_qkvpacked_func


def _get_block_size(device=None, head_dim: int = 64, is_dropout: bool = False,
                    seq_len: int = 4096):
    """(query rows, keys) of K1's tile (``kernels/flash_fwd.py`` BLOCK_M,
    BLOCK_N), the counterpart of the reference's block-size mirror; the
    arguments are taken for signature parity."""
    del device, head_dim, is_dropout, seq_len
    return BLOCK_M, BLOCK_N
