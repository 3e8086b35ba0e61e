"""Varlen packing: cu_seqlens <-> segment ids, pad / unpad (port of
``flash_attn_tpu/ops/packing.py``).

The reference's ``flash_attn/bert_padding.py`` API (``unpad_input``,
``pad_input``, ``index_first_axis``, ...) plus the segment encoding the
kernels take: per-token ``segment_ids`` (-1 = padding) and per-segment
``positions``. Plain torch: gathers and scatters, no kernel. A gather's
gradient is a scatter-add (autograd's ``index_select`` backward), so no
custom backward is needed.

``unpad_input`` without ``total`` returns as many rows as there are valid
tokens (the output shape depends on the data: one host sync on the card);
with a static ``total`` it pads or truncates to that length, the padding
rows zero and their ``indices`` pointing at row 0.
"""

from __future__ import annotations

import torch


def index_first_axis(x: torch.Tensor, indices: torch.Tensor) -> torch.Tensor:
    """Rows ``indices`` of the first axis (bert_padding.py:11-38 there)."""
    return x.index_select(0, indices.long())


def index_put_first_axis(values: torch.Tensor, indices: torch.Tensor,
                         first_axis_dim: int) -> torch.Tensor:
    """``values`` scattered into rows ``indices`` of a zero tensor of
    ``first_axis_dim`` rows (bert_padding.py:41-64 there)."""
    out = values.new_zeros((first_axis_dim, *values.shape[1:]))
    return out.index_copy(0, indices.long(), values)


def index_first_axis_residual(x: torch.Tensor, indices: torch.Tensor):
    """The gather and ``x`` itself (bert_padding.py:67-96 there)."""
    return index_first_axis(x, indices), x


def unpad_input(hidden_states: torch.Tensor, attention_mask: torch.Tensor,
                total: int | None = None):
    """(b, s, ...) and a (b, s) mask (True or 1 at valid tokens) -> packed
    (total, ...), ``indices`` into the flattened (b * s) rows,
    ``cu_seqlens`` (b + 1,) int32 and ``max_seqlen_in_batch``
    (bert_padding.py:99-119 there). With a static ``total`` the output has
    that many rows, padding rows zero with index 0, and
    ``max_seqlen_in_batch`` is s."""
    mask = attention_mask.bool()
    b, s = mask.shape
    seqlens = mask.sum(-1, dtype=torch.int32)
    cu_seqlens = torch.nn.functional.pad(seqlens.cumsum(0, dtype=torch.int32),
                                         (1, 0))
    flat = mask.reshape(-1)
    if total is None:
        indices = torch.nonzero(flat).flatten().to(torch.int32)
        max_seqlen = int(seqlens.max())
    else:
        # The valid rows in order, then index 0 to fill (jnp.nonzero(size=,
        # fill_value=0)).
        order = torch.argsort((~flat).to(torch.int8), stable=True)
        n = min(total, b * s)
        indices = torch.zeros(total, dtype=torch.int32, device=flat.device)
        indices[:n] = order[:n].to(torch.int32)
        valid = torch.arange(total, device=flat.device) < cu_seqlens[-1]
        indices = torch.where(valid, indices, 0)
        max_seqlen = s
    packed = index_first_axis(
        hidden_states.reshape(b * s, *hidden_states.shape[2:]), indices)
    if total is not None:
        packed = torch.where(
            valid.reshape((-1,) + (1,) * (packed.dim() - 1)), packed, 0)
    return packed, indices, cu_seqlens, max_seqlen


def pad_input(packed: torch.Tensor, indices: torch.Tensor, batch: int,
              seqlen: int) -> torch.Tensor:
    """Inverse of ``unpad_input`` (bert_padding.py:122-134 there)."""
    out = index_put_first_axis(packed, indices, batch * seqlen)
    return out.reshape(batch, seqlen, *packed.shape[1:])


def cu_seqlens_to_segments(cu_seqlens: torch.Tensor, total: int):
    """cu_seqlens (batch + 1,) -> (segment_ids, positions), each (total,)
    int32: which sequence token t belongs to (-1 past the last one) and
    its offset inside it. Empty sequences own no token."""
    cu = cu_seqlens.to(torch.int32)
    t = torch.arange(total, dtype=torch.int32, device=cu.device)
    n_seq = cu.shape[0] - 1
    seg = torch.searchsorted(cu[1:], t, right=True).to(torch.int32)
    valid = t < cu[-1]
    seg = torch.where(valid, seg.clamp(max=n_seq - 1), -1)
    starts = cu[seg.clamp(0, n_seq - 1).long()]
    positions = torch.where(valid, t - starts, 0)
    return seg, positions


def segments_to_padding_mask(segment_ids: torch.Tensor) -> torch.Tensor:
    """True at valid (non-padding) tokens."""
    return segment_ids >= 0


def make_segment_ids_from_mask(attention_mask: torch.Tensor):
    """(b, s) key-padding mask -> (segment_ids, positions), (b, s) int32,
    for the padded layout: each row is segment 0, padding -1, positions
    the in-row indices. This is how ``FlashAttention`` masks padding
    without a gather or scatter."""
    mask = attention_mask.bool()
    b, s = mask.shape
    seg = torch.where(mask, 0, -1).to(torch.int32)
    pos = torch.arange(s, dtype=torch.int32, device=mask.device).expand(b, s)
    return seg, pos
