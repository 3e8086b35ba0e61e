"""Blocksparse attention: the layout compiler, the CUDA kernels K8a
(``csrc/blocksparse_fwd.cu``), K8b and K8c (``csrc/blocksparse_bwd.cu``)
and their plain-torch twins.

Port of ``flash_attn_tpu/kernels/blocksparse.py``. A 0/1 cell mask of
16-row x 256-column cells (``ROW_CELL`` x ``COL_CELL``) gates which scores
are computed; causal masking (top-left), key padding and dropout compose on
top. The layout compiler turns the cell mask into the PORT's tiles, 64 query
rows x 64 keys (a kv tile lies inside one 256-column cell), not the TPU's
1024-wide ones: per q tile the list of its live kv tiles, per kv tile the
list of its live q tiles, a FULL flag per pair (every cell live, wholly below
the diagonal when causal, inside ``sk``) and the per-row cell mask. Only the
per-cell "rowmask" mask source is ported; the TPU's mask bank and interval
sources (there :55-66, :222-246) covered TPU costs.

Visibility of (row i, key j): the cell of (i, j) is live, j <= i when causal,
j < sk, and, with key padding, row i and key j are valid. A FULL tile skips
the cell and causal tests, never the padding (the JAX kernels skip that too
on full tiles, so they attend padded keys there: ROADMAP C9; the port
follows the oracle ``attention_ref(mask=...)``). Rows with no visible key
give out = 0 and lse = -inf.

Kernel layout: q, k, v (b, h, s, d) with d 64 or 128 (the op pads other
head dims), MHA, each with a contiguous last dimension and any other strides
of 16 bytes' multiples (``rows_ok``), so the op passes transposed views of
its (b, s, h, d) tensors; outputs are (b, h, s, d) views of (b, s, h, d)
memory. ``q_valid`` (b, sq) and ``k_valid`` (b, sk) uint8 or None. Tensors
on the CPU take the plain twins; CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.common import (  # noqa: F401
    check_rows,
    empty_rows,
    kernel_operand,  # the op's copy rule, re-exported with rows_ok
    rows_ok,
    strides_arg,
)
from flash_attn_tpu_torch.kernels.flash_fwd import (
    compute_dtype,
    dropout_args,
    keep_plain,
)

ROW_CELL = 16  # mask granularity along q
COL_CELL = 256  # mask granularity along k
# The JAX package's default tiles; accepted for API parity, they change no
# result here.
DEFAULT_BLOCK_Q = 1024
DEFAULT_BLOCK_K = 1024
TILE_Q = 64  # the port's tiles (csrc/blocksparse.cuh kTileQ, kTileK)
TILE_K = 64
HEAD_DIMS = (64, 128)


def _cdiv(a, b):
    return -(-a // b)


def detect_band(blockmask, *, sq: int, sk: int, causal: bool):
    """Band-shape detector (copy of the JAX package's,
    ``kernels/blocksparse.py:73``, where it routes band masks to the dense
    window kernel). Nothing calls it yet: that route needs ROADMAP P2.

    Returns ``(window_left, window_right, num_sinks)`` element-level
    parameters (left/right possibly None = unbounded, num_sinks in key
    columns) when the cell mask is EXACTLY the cell-ification of

        visible(i, j) = (j < num_sinks) or (i - L <= j <= i + R)

    intersected with element causality, else None. The solver derives
    (L, R, g) intervals from each cell row's run decomposition; an
    exhaustive reconstruction check is the authority, so a solver miss can
    only fail to route, never route wrongly.
    """
    CQ, CK = ROW_CELL, COL_CELL
    bm = np.asarray(blockmask).astype(bool)
    nr = (sq + CQ - 1) // CQ
    nc = (sk + CK - 1) // CK
    if bm.shape[0] < nr or bm.shape[1] < nc:
        return None
    bm = bm[:nr, :nc].copy()
    cc = np.arange(nc)[None, :]
    if causal:
        # Causal-unreachable cells are dead whatever the mask says.
        bm &= (np.arange(nr)[:, None] + 1) * CQ - 1 >= cc * CK
    if not bm.any():
        return None

    # --- per-row run decomposition ---
    g_fixed = None  # prefix width revealed by a 2-run row (must agree)
    rows = []
    for r in range(nr):
        act = np.flatnonzero(bm[r])
        if act.size == 0:
            return None
        runs = np.split(act, np.flatnonzero(np.diff(act) > 1) + 1)
        if len(runs) > 2:
            return None
        if len(runs) == 2:
            if runs[0][0] != 0:
                return None
            g_row = int(runs[0][-1]) + 1
            if g_fixed is None:
                g_fixed = g_row
            elif g_fixed != g_row:
                return None
            rows.append((r, int(runs[1][0]), int(runs[1][-1])))
        else:
            rows.append((r, int(runs[0][0]), int(runs[0][-1])))

    def solve(g):
        """Solve (L, R) given a global-prefix width of g cells."""
        L_lo = R_lo = -np.inf
        L_hi = R_hi = np.inf
        for r, s0, e0 in rows:
            a = r * CQ  # first element row of this cell row
            b_ = a + CQ - 1  # last
            if g and s0 == 0 and e0 <= g - 1:
                # Row shows exactly (part of) the prefix: the band is
                # hidden inside it or empty here; its hi must not poke out:
                # floor((b_ + R)/CK) <= g - 1. No L info.
                R_hi = min(R_hi, g * CK - b_ - 1)
                continue
            if s0 <= g:
                # Clamped at column 0 / merged into the prefix:
                # floor((a - L)/CK) <= max(g, 0-clamp).
                L_lo = max(L_lo,
                           a - (g + 1) * CK + 1 if g else a - CK + 1)
            else:
                # Unclamped left edge: floor((a - L)/CK) == s0.
                L_lo = max(L_lo, a - (s0 + 1) * CK + 1)
                L_hi = min(L_hi, a - s0 * CK)
            c_causal = b_ // CK if causal else np.inf
            if e0 == nc - 1 or e0 == c_causal:
                # Clamped at the grid edge / causal staircase: the band hi
                # merely has to reach it: floor((b_ + R)/CK) >= e0.
                R_lo = max(R_lo, e0 * CK - b_)
            else:
                # Unclamped right edge: floor((b_ + R)/CK) == e0.
                R_lo = max(R_lo, e0 * CK - b_)
                R_hi = min(R_hi, (e0 + 1) * CK - b_ - 1)
        if L_lo > L_hi or R_lo > R_hi:
            return None
        L = None if L_hi == np.inf else int(L_hi)
        R = None if R_hi == np.inf else int(R_hi)
        if (L is not None and L < 0) or (R is not None and R < 0):
            return None
        if L is None and R is None and g > 0:
            return None  # pure-prefix masks are not a band
        return (L, R)

    def verify(L, R, g):
        """Authoritative reconstruction check."""
        pred = np.zeros_like(bm)
        for r in range(nr):
            a = r * CQ
            b_ = a + CQ - 1
            lo = 0 if L is None else max((a - L) // CK, 0)
            hi = nc - 1 if R is None else min((b_ + R) // CK, nc - 1)
            if causal:
                hi = min(hi, b_ // CK)
            if lo <= hi:
                pred[r, lo:hi + 1] = True
            if g:
                pred[r, :g] = True
                if causal:
                    pred[r] &= cc[0] * CK <= b_
        return np.array_equal(pred, bm)

    # Prefix-width candidates: fixed by a 2-run row if one exists; else
    # ambiguous (the prefix may merge with the band in EVERY row): try no
    # prefix, then the narrowest row's extent.
    if g_fixed is not None:
        candidates = [g_fixed]
    else:
        candidates = [0]
        g_min = min(e0 for _, s0, e0 in rows if s0 == 0) + 1 \
            if all(s0 == 0 for _, s0, _ in rows) else None
        if g_min and g_min not in candidates:
            candidates.append(g_min)
    for g in candidates:
        lr = solve(g)
        if lr is not None and verify(lr[0], lr[1], g):
            return (lr[0], lr[1], g * CK)
    return None


@dataclasses.dataclass(frozen=True, eq=False)
class BlockSparseLayout:
    """Compiled sparsity layout of one (cell mask, sq, sk, causal), in the
    port's 64 x 64 tiles. Host arrays are numpy; ``on(device)`` copies them
    to a device once and keeps them."""

    sq: int
    sk: int
    sq_pad: int  # multiples of TILE_Q / TILE_K
    sk_pad: int
    block_q: int  # accepted for API parity
    block_k: int
    causal: bool
    kv_indices: np.ndarray  # (nq, max_kv) int32 live kv tiles per q tile
    kv_counts: np.ndarray  # (nq,) int32
    kv_full: np.ndarray  # (nq, max_kv) int32: 1 = tile needs no cell/causal mask
    q_indices: np.ndarray  # (nk, max_q) int32 live q tiles per kv tile
    q_counts: np.ndarray  # (nk,) int32
    q_full: np.ndarray  # (nk, max_q) int32
    rowmask: np.ndarray  # (sq_pad, ncells) uint8: 1 = the row's cell is live
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def max_kv(self):
        return self.kv_indices.shape[1]

    @property
    def max_q(self):
        return self.q_indices.shape[1]

    @property
    def ncells(self):
        return self.rowmask.shape[1]

    def on(self, device) -> dict:
        """The index arrays and the rowmask as tensors on ``device``, copied
        at the first call for that device."""
        device = torch.device(device)
        if device not in self._on_device:
            self._on_device[device] = {
                name: torch.from_numpy(getattr(self, name)).to(device)
                for name in ("kv_indices", "kv_counts", "kv_full",
                             "q_indices", "q_counts", "q_full", "rowmask")}
        return self._on_device[device]

    def visible(self, device) -> torch.Tensor:
        """The (sq, sk) bool element mask: live cell, causal and bounds (the
        twins' and the oracle's mask; key padding is not in it)."""
        cols = torch.arange(self.sk, device=device) // COL_CELL
        rows = self.on(device)["rowmask"][: self.sq].bool()
        mask = rows[:, cols]
        if self.causal:
            mask &= torch.ones_like(mask).tril()
        return mask


def build_layout(blockmask, *, sq: int, sk: int,
                 block_q: int = DEFAULT_BLOCK_Q,
                 block_k: int = DEFAULT_BLOCK_K,
                 causal: bool = False) -> BlockSparseLayout:
    """Compile a (ceil(sq/16), ceil(sk/256)) 0/1 cell mask (a larger one is
    cut) into the kernels' layout, in numpy on the host: built once per
    configuration (JAX ``build_layout`` :266). ``block_q`` and ``block_k``
    are accepted for API parity and change no result."""
    bm = np.asarray(blockmask).astype(bool)
    n_rc, n_cc = _cdiv(sq, ROW_CELL), _cdiv(sk, COL_CELL)
    if bm.ndim != 2 or bm.shape[0] < n_rc or bm.shape[1] < n_cc:
        raise ValueError(f"blockmask {bm.shape} too small for sq={sq}, "
                         f"sk={sk}: need ({n_rc}, {n_cc})")
    nq, nk = _cdiv(sq, TILE_Q), _cdiv(sk, TILE_K)
    sq_pad, sk_pad = nq * TILE_Q, nk * TILE_K
    ncells = _cdiv(sk_pad, COL_CELL)
    # Cells of the real rows and columns; padding cells are dead.
    cells = np.zeros((sq_pad // ROW_CELL, ncells), bool)
    cells[:n_rc, :n_cc] = bm[:n_rc, :n_cc]

    rows_per_tile = TILE_Q // ROW_CELL
    tile_cells = cells.reshape(nq, rows_per_tile, ncells)[
        :, :, np.arange(nk) * TILE_K // COL_CELL]  # (nq, rows, nk)
    q0 = np.arange(nq)[:, None] * TILE_Q  # first row of each q tile
    k0 = np.arange(nk)[None, :] * TILE_K  # first key of each kv tile
    reach = tile_cells
    if causal:
        # A cell row reaches the tile if its last row sees the first key.
        last = (np.arange(nq * rows_per_tile).reshape(nq, rows_per_tile, 1)
                * ROW_CELL + ROW_CELL - 1)
        reach = tile_cells & (last >= k0[:, None, :])
    live = reach.any(axis=1)
    full = tile_cells.all(axis=1) & (k0 + TILE_K <= sk)
    if causal:
        full &= q0 >= k0 + TILE_K - 1  # wholly below the diagonal
    full &= live

    def lists(mat, flags):
        counts = mat.sum(axis=1).astype(np.int32)
        width = max(int(counts.max()), 1)
        idx = np.zeros((mat.shape[0], width), np.int32)
        flg = np.zeros((mat.shape[0], width), np.int32)
        for i in range(mat.shape[0]):
            ids = np.flatnonzero(mat[i])
            idx[i, : len(ids)] = ids
            flg[i, : len(ids)] = flags[i, ids]
        return idx, counts, flg

    kv_indices, kv_counts, kv_full = lists(live, full)
    q_indices, q_counts, q_full = lists(live.T, full.T)
    return BlockSparseLayout(
        sq=sq, sk=sk, sq_pad=sq_pad, sk_pad=sk_pad, block_q=block_q,
        block_k=block_k, causal=causal, kv_indices=kv_indices,
        kv_counts=kv_counts, kv_full=kv_full, q_indices=q_indices,
        q_counts=q_counts, q_full=q_full,
        rowmask=np.repeat(cells, ROW_CELL, axis=0).astype(np.uint8),
    )


def convert_blockmask(blockmask, causal, *, sq=None, sk=None,
                      block_q=DEFAULT_BLOCK_Q, block_k=DEFAULT_BLOCK_K):
    """Reference-named entry point (JAX :455): compiles the cell mask into
    the layout, at sq = 16 x its rows and sk = 256 x its columns unless
    given."""
    bm = np.asarray(blockmask)
    sq = bm.shape[0] * ROW_CELL if sq is None else sq
    sk = bm.shape[1] * COL_CELL if sk is None else sk
    return build_layout(bm, sq=sq, sk=sk, block_q=block_q, block_k=block_k,
                        causal=causal)


# ---------------------------------------------------------------- wrappers

def _check(name, layout, q, k, v, tensors, valid, stats=()):
    """Dtype, head_dim, shape, layout, device, contiguity and alignment
    checks the three kernels share; ``tensors`` are further (b, h, sq, d)
    operands (dout), ``stats`` fp32 (b, h, sq) rows (lse, di)."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if q.dtype not in _build.DTYPE_CODES or any(
            x.dtype != q.dtype for x in (k, v)):
        raise ValueError(f"{name}: dtypes {q.dtype}, {k.dtype}, {v.dtype}; "
                         "need one of fp32, fp16, bf16")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {d} not in {HEAD_DIMS}")
    if k.shape != (b, h, sk, d) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} (MHA only)")
    if (layout.sq, layout.sk) != (sq, sk):
        raise ValueError(f"{name}: layout built for sq={layout.sq}, "
                         f"sk={layout.sk}, inputs have {sq}, {sk}")
    q_valid, k_valid = valid
    if (q_valid is None) != (k_valid is None):
        raise ValueError(f"{name}: pass both q_valid and k_valid or neither")
    if q_valid is not None and (
            q_valid.shape != (b, sq) or k_valid.shape != (b, sk)
            or q_valid.dtype != torch.uint8 or k_valid.dtype != torch.uint8):
        raise ValueError(f"{name}: q_valid {q_valid.dtype} "
                         f"{tuple(q_valid.shape)}, k_valid {k_valid.dtype} "
                         f"{tuple(k_valid.shape)}; need uint8 {(b, sq)}, "
                         f"{(b, sk)}")
    for x in stats:
        if x.shape != (b, h, sq) or x.dtype != torch.float32:
            raise ValueError(f"{name}: lse/di {x.dtype} {tuple(x.shape)}, "
                             f"need fp32 {(b, h, sq)}")
    rows = (q, k, v, *tensors)
    for x in rows:
        if x.device != q.device or x.device.type != "cuda":
            raise ValueError(f"{name}: q/k/v/dout on {x.device} and "
                             f"{q.device}, need one CUDA device")
    check_rows(name, *rows)
    flat = [*stats, *(x for x in valid if x is not None)]
    if flat:
        _build.require_cuda(name, *flat)
        if flat[0].device != q.device:
            raise ValueError(f"{name}: tensors on {flat[0].device} and "
                             f"{q.device}")


def _ptr(x):
    return None if x is None else x.data_ptr()


def blocksparse_attention_fwd(q, k, v, layout: BlockSparseLayout,
                              q_valid=None, k_valid=None, *,
                              softmax_scale: float, dropout_p: float = 0.0,
                              seed=None):
    """K8a. Returns ``(out, lse)``: out (b, h, sq, d) in the q dtype (in
    (b, sq, h, d) memory on the card), lse (b, h, sq) fp32. A CPU tensor
    takes the plain twin; a CUDA tensor launches the kernel or raises."""
    seed_u32, threshold, rp = dropout_args(dropout_p, seed)
    if q.device.type == "cpu":
        return blocksparse_attention_fwd_plain(
            q, k, v, layout, q_valid, k_valid, softmax_scale=softmax_scale,
            dropout_p=dropout_p, seed=seed)
    _check("blocksparse_attention_fwd", layout, q, k, v, (),
           (q_valid, k_valid))
    b, h, sq, d = q.shape
    lay = layout.on(q.device)
    out = empty_rows(b, h, sq, q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    code = _build.lib().fattn_blocksparse_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), strides_arg(q=q, k=k, v=v, o=out),
        lay["kv_indices"].data_ptr(),
        lay["kv_counts"].data_ptr(), lay["kv_full"].data_ptr(),
        lay["rowmask"].data_ptr(), _ptr(q_valid), _ptr(k_valid),
        b, h, sq, layout.sk, d, layout.max_kv, layout.ncells,
        float(softmax_scale), int(layout.causal), seed_u32, threshold, rp,
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    blocksparse_attention_fwd.launches += 1
    _build.check(code, "fattn_blocksparse_fwd")
    return out, lse


blocksparse_attention_fwd.launches = 0


def blocksparse_attention_dkv(q, k, v, dout, lse, di,
                              layout: BlockSparseLayout, q_valid=None,
                              k_valid=None, *, softmax_scale: float,
                              dropout_p: float = 0.0, seed=None):
    """K8b: ``(dk, dv)`` from the forward's lse and ``di = rowsum(dout *
    out) - dlse`` (b, h, sq) fp32. A CPU tensor takes the plain twin; a
    CUDA tensor launches the kernel or raises."""
    seed_u32, threshold, rp = dropout_args(dropout_p, seed)
    if q.device.type == "cpu":
        _, dk, dv = blocksparse_attention_bwd_plain(
            q, k, v, dout, lse, di, layout, q_valid, k_valid,
            softmax_scale=softmax_scale, dropout_p=dropout_p, seed=seed)
        return dk, dv
    _check("blocksparse_attention_dkv", layout, q, k, v, (dout,),
           (q_valid, k_valid), (lse, di))
    b, h, sq, d = q.shape
    lay = layout.on(q.device)
    dk, dv = empty_rows(b, h, layout.sk, k), empty_rows(b, h, layout.sk, v)
    code = _build.lib().fattn_blocksparse_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        strides_arg(q=q, k=k, v=v, dout=dout, dk=dk, dv=dv),
        lay["q_indices"].data_ptr(), lay["q_counts"].data_ptr(),
        lay["q_full"].data_ptr(), lay["rowmask"].data_ptr(), _ptr(q_valid),
        _ptr(k_valid), b, h, sq, layout.sk, d, layout.max_q, layout.ncells,
        float(softmax_scale), int(layout.causal), seed_u32, threshold, rp,
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    blocksparse_attention_dkv.launches += 1
    _build.check(code, "fattn_blocksparse_dkv")
    return dk, dv


blocksparse_attention_dkv.launches = 0


def blocksparse_attention_dq(q, k, v, dout, lse, di,
                             layout: BlockSparseLayout, q_valid=None,
                             k_valid=None, *, softmax_scale: float,
                             dropout_p: float = 0.0, seed=None):
    """K8c: ``dq``, with the arguments of ``blocksparse_attention_dkv``. A
    CPU tensor takes the plain twin; a CUDA tensor launches the kernel or
    raises."""
    seed_u32, threshold, rp = dropout_args(dropout_p, seed)
    if q.device.type == "cpu":
        return blocksparse_attention_bwd_plain(
            q, k, v, dout, lse, di, layout, q_valid, k_valid,
            softmax_scale=softmax_scale, dropout_p=dropout_p, seed=seed)[0]
    _check("blocksparse_attention_dq", layout, q, k, v, (dout,),
           (q_valid, k_valid), (lse, di))
    b, h, sq, d = q.shape
    lay = layout.on(q.device)
    dq = empty_rows(b, h, sq, q)
    code = _build.lib().fattn_blocksparse_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
        strides_arg(q=q, k=k, v=v, o=dq, dout=dout),
        lay["kv_indices"].data_ptr(), lay["kv_counts"].data_ptr(),
        lay["kv_full"].data_ptr(), lay["rowmask"].data_ptr(), _ptr(q_valid),
        _ptr(k_valid), b, h, sq, layout.sk, d, layout.max_kv, layout.ncells,
        float(softmax_scale), int(layout.causal), seed_u32, threshold, rp,
        _build.DTYPE_CODES[q.dtype], _build.stream_ptr(q.device))
    blocksparse_attention_dq.launches += 1
    _build.check(code, "fattn_blocksparse_dq")
    return dq


blocksparse_attention_dq.launches = 0


def blocksparse_attention_bwd(q, k, v, out, dout, lse,
                              layout: BlockSparseLayout, q_valid=None,
                              k_valid=None, *, softmax_scale: float,
                              dropout_p: float = 0.0, seed=None, dlse=None):
    """``(dq, dk, dv)``: ``di = rowsum(dout * out) - dlse`` in torch (JAX
    computes it in XLA, :1138-1141), then K8b and K8c."""
    ct = compute_dtype(q)  # fp32 on the card, as the kernels take di
    di = (out.to(ct) * dout.to(ct)).sum(-1)
    if dlse is not None:
        di = di - dlse
    di = di.contiguous()  # the sum keeps out's (b, s, h) memory order
    kw = dict(softmax_scale=softmax_scale, dropout_p=dropout_p, seed=seed)
    dk, dv = blocksparse_attention_dkv(q, k, v, dout, lse, di, layout,
                                       q_valid, k_valid, **kw)
    dq = blocksparse_attention_dq(q, k, v, dout, lse, di, layout, q_valid,
                                  k_valid, **kw)
    return dq, dk, dv


# ------------------------------------------------------------ plain twins

def visible_plain(layout: BlockSparseLayout, q_valid, k_valid, device):
    """The (b or 1, 1, sq, sk) element visibility the kernels compute: the
    layout's cell, causal and bound mask, and the key padding."""
    mask = layout.visible(device)[None, None]
    if q_valid is not None:
        mask = mask & (q_valid.bool()[:, None, :, None]
                       & k_valid.bool()[:, None, None, :])
    return mask


def _scores(q, k, visible, softmax_scale):
    ct = compute_dtype(q)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(ct), k.to(ct)) * softmax_scale
    return s.masked_fill(~visible, -math.inf)


def blocksparse_attention_fwd_plain(q, k, v, layout, q_valid=None,
                                    k_valid=None, *, softmax_scale: float,
                                    dropout_p: float = 0.0, seed=None):
    """Plain-torch twin of K8a: fp32 (fp64 for fp64 inputs) scores, the
    kernels' visibility, out = 0 and lse = -inf on rows that see nothing,
    dropout after the softmax rescaled by 1 / (1 - p)."""
    _, _, rp = dropout_args(dropout_p, seed)
    s = _scores(q, k, visible_plain(layout, q_valid, k_valid, q.device),
                softmax_scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None]).nan_to_num(0.0)  # empty rows: 0
    if dropout_p > 0.0:
        p = torch.where(keep_plain(q, k, dropout_p, seed), p, 0.0) * rp
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.to(p.dtype)).to(q.dtype)
    return out, lse


def blocksparse_attention_bwd_plain(q, k, v, dout, lse, di, layout,
                                    q_valid=None, k_valid=None, *,
                                    softmax_scale: float,
                                    dropout_p: float = 0.0, seed=None):
    """Plain-torch twin of K8b and K8c: p = exp(s - lse) (0 where not
    visible or lse = -inf), dV from the dropped p, dS = p * (dP - di) from
    the pre-dropout p. Returns ``(dq, dk, dv)``."""
    _, _, rp = dropout_args(dropout_p, seed)
    ct = compute_dtype(q)
    s = _scores(q, k, visible_plain(layout, q_valid, k_valid, q.device),
                softmax_scale)
    lse = lse.to(ct)
    p = torch.exp(s - lse[..., None])
    p = torch.where(torch.isneginf(s) | torch.isneginf(lse)[..., None], 0.0,
                    p)
    do, qf, kf = dout.to(ct), q.to(ct), k.to(ct)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, v.to(ct))
    pd = p
    if dropout_p > 0.0:
        keep = keep_plain(q, k, dropout_p, seed)
        pd = torch.where(keep, p, 0.0) * rp
        dp = torch.where(keep, dp, 0.0) * rp
    ds = p * (dp - di.to(ct)[..., None])
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * softmax_scale
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * softmax_scale
    dv = torch.einsum("bhqk,bhqd->bhkd", pd, do)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
