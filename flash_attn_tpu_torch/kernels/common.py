"""What the kernels' wrappers share.

- Plain-torch twins of the shared paged-kernel algebra of
  ``flash_attn_tpu/kernels/common.py`` (block liveness, mask and
  online-softmax update). The CUDA kernels K5 and K6 share the same
  predicates in ``csrc/paged.cuh``; these functions are the plain path the
  CPU tests run and the kernels are compared with.
- Split-KV, shared by K5 and K6 (``csrc/paged_split.cuh``): the host's
  choice of the split count from shapes alone (``paged_num_splits``,
  ``paged_split_keys``), the merge of partials (``merge_partials``, the
  counterpart of ``flash_attn_tpu/parallel/ring.py`` ``_merge_partials``)
  and the split algorithm in plain torch (``paged_split_plain``).
- The strided operands of the attention kernels K1, K2 and K8a-c
  (``csrc/common.cuh`` ``Strides``): a (b, h, s, d) operand is taken in
  place when its last dimension is contiguous and every row starts on a
  16-byte boundary (``rows_ok``), so the ops hand over transposed views of
  their (b, s, h, d) tensors and of a packed qkv; outputs are (b, h, s, d)
  views of (b, s, h, d) memory (``empty_rows``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from flash_attn_tpu_torch.kernels import _build

DEFAULT_MASK_VALUE = -0.7 * float(torch.finfo(torch.float32).max)

_UNPORTED = {
    "k_scales": "M5 (quantized KV)", "v_scales": "M5 (quantized KV)",
    "qk_quant": "M8 (int8 QK, K9)",
}


def check_ported(**given):
    """Raise for an argument of the paged kernels' JAX signatures that the
    port does not run yet (any value but None), naming the ROADMAP port
    item that brings it."""
    for name, value in given.items():
        if value is not None:
            raise NotImplementedError(
                f"{name}: ROADMAP port item {_UNPORTED[name]}")


def paged_block_live(j, bk, *, length, window_left=None,
                     first_band_pos=None, num_sinks: int = 0):
    """Liveness of key block ``j`` (width ``bk``) for the paged kernels
    (common.py:245): some key of it is in-sequence and, with a window,
    inside the band or a sink. ``first_band_pos`` is the LOOSEST band floor
    over the rows a launch serves: ``length - 1 - window_left`` for decode,
    the first chunk row's ``qpos - window_left`` for a chunk (a tighter
    row's floor drops keys that earlier rows need). ``length`` and
    ``first_band_pos`` may be tensors."""
    live = j * bk < length
    if window_left is not None:
        band_or_sink = (j + 1) * bk > first_band_pos
        if num_sinks > 0:
            band_or_sink = band_or_sink | (j * bk < num_sinks)
        live = live & band_or_sink
    return live


def paged_visibility_mask(kpos, qpos, *, length, window_left=None,
                          num_sinks: int = 0):
    """(rows, bk) True = key visible: in-sequence, causal against the row's
    query position and, with a window, inside the band or a sink
    (common.py:266). ``qpos`` and ``length`` may be scalars or tensors that
    broadcast against ``kpos``."""
    mask = (kpos < length) & (kpos <= qpos)
    if window_left is not None:
        visible = kpos >= qpos - window_left
        if num_sinks > 0:
            visible = visible | (kpos < num_sinks)
        mask = mask & visible
    return mask


def paged_block_softmax(s, mask, m_prev, l_prev, *, softcap=None,
                        alibi_col=None, rel=None):
    """Masked online-softmax update of one key block (common.py:281).

    ``s``: (..., bk) fp32 scaled scores; ``m_prev``/``l_prev``: (..., 1)
    running max and sum. The softcap goes on the scaled scores, then the
    ALiBi bias ``alibi_col * rel`` (rel = kpos - qpos; slopes NOT divided
    by the scale), then the mask. Returns ``(p, alpha, m_next, l_next)``;
    the caller rescales its accumulator by ``alpha`` and adds ``p @ v``.
    """
    if softcap is not None:
        s = softcap * torch.tanh(s / softcap)
    if alibi_col is not None:
        s = s + alibi_col * rel
    s = torch.where(mask, s, DEFAULT_MASK_VALUE)
    m_next = torch.maximum(m_prev, s.amax(dim=-1, keepdim=True))
    alpha = torch.exp(m_prev - m_next)
    p = torch.where(mask, torch.exp(s - m_next), 0.0)
    l_next = alpha * l_prev + p.sum(dim=-1, keepdim=True)
    return p, alpha, m_next, l_next


def paged_terms(name, n_q_heads, *, window_left, num_sinks, alibi_slopes,
                softcap, device):
    """Validates the paged kernels' M4 arguments as the JAX launchers do
    (decode.py:521-536): returns (window_left, num_sinks, slopes (n_q_heads,)
    fp32 on ``device`` or None, softcap or None). Sinks count only with a
    window."""
    if window_left is not None and window_left < 0:
        raise ValueError(f"{name}: window_left must be >= 0, got "
                         f"{window_left}")
    if num_sinks < 0:
        raise ValueError(f"{name}: num_sinks must be >= 0, got {num_sinks}")
    num_sinks = int(num_sinks) if window_left is not None else 0
    slopes = None
    if alibi_slopes is not None:
        slopes = torch.as_tensor(alibi_slopes, dtype=torch.float32,
                                 device=device).contiguous()
        if tuple(slopes.shape) != (n_q_heads,):
            raise ValueError(f"{name}: alibi_slopes must have shape "
                             f"({n_q_heads},); got {tuple(slopes.shape)}")
    if softcap is not None and softcap <= 0.0:
        raise ValueError(f"{name}: softcap must be > 0, got {softcap}")
    softcap = None if softcap is None else float(softcap)
    return (None if window_left is None else int(window_left), num_sinks,
            slopes, softcap)


def paged_live_span(pages_max: int, page_size: int, window_left, num_sinks,
                    rows: int = 1) -> int:
    """The most keys a launch walks per sequence (K5/K6's split range):
    the table's capacity, or with a window the band of ``rows`` query rows
    plus the sink tiles and a tile of alignment (csrc/paged.cuh
    paged_walk). A function of shapes only."""
    cap = pages_max * page_size
    if window_left is None:
        return cap
    sinks = -(-num_sinks // SPLIT_TILE) * SPLIT_TILE
    return min(cap, sinks + window_left + rows + SPLIT_TILE)


# A split holds whole 64-key tiles (K6's tile) of whole pages.
SPLIT_TILE = 64


def paged_split_keys(pages_max: int, page_size: int, n_splits: int) -> int:
    """Keys per split when ``n_splits`` ranges share a table of
    ``pages_max`` pages: whole pages, a multiple of SPLIT_TILE keys."""
    unit = math.lcm(page_size, SPLIT_TILE)
    return -(-(-(-pages_max // n_splits) * page_size) // unit) * unit


def paged_num_splits(batch: int, h_kv: int, pages_max: int, page_size: int,
                     n_sm: int, live_keys: int | None = None) -> int:
    """How many key ranges the paged kernels cut each sequence's walk
    into: the most that keep ``batch * h_kv`` blocks per range within two
    waves of ``n_sm`` SMs, at least 1 and never a range without a page. A
    function of shapes only: the lengths live on the card, and reading
    them would synchronise every layer of every step. (``batch`` counts
    every block row of a sequence: K6 passes batch x row tiles.) With a
    window the walk covers ``live_keys`` (``paged_live_span``: the band and
    the sink tiles), not the table."""
    pages = paged_live_pages(pages_max, page_size, live_keys)
    n = max(1, min(pages, 2 * n_sm // max(1, batch * h_kv)))
    return -(-pages * page_size // paged_split_keys(pages, page_size, n))


def paged_live_pages(pages_max: int, page_size: int,
                     live_keys: int | None) -> int:
    """Pages' worth of keys the splits cover: the table, or ``live_keys``
    rounded up to whole pages."""
    if live_keys is None:
        return pages_max
    return max(1, min(pages_max, -(-live_keys // page_size)))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (cached: asked once)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def _weighted(o, lse, lse_new):
    """o * exp(lse - lse_new), exactly 0 where lse = -inf whatever o
    holds (exp(-inf - -inf) would be NaN)."""
    return torch.where(torch.isneginf(lse)[..., None], 0.0,
                       o * torch.exp(lse - lse_new)[..., None])


def merge_partials(o, lse):
    """Merge attention partials in order: ``o`` (n, ..., d) each normalised
    by its own sum, ``lse`` (n, ...) their log-sum-exps (natural log). A
    fully masked partial (lse = -inf) contributes exactly 0. Returns the
    merged (o fp32, lse); o is 0 where every lse is -inf. Pairwise from the
    first partial on, as ``flash_attn_tpu/parallel/ring.py``
    ``_merge_partials``."""
    lse = lse.float()
    acc, acc_lse = _weighted(o[0].float(), lse[0], lse[0]), lse[0]
    for o_b, lse_b in zip(o[1:], lse[1:]):
        lse_new = torch.logaddexp(acc_lse, lse_b)
        acc = _weighted(acc, acc_lse, lse_new) + _weighted(
            o_b.float(), lse_b, lse_new)
        acc_lse = lse_new
    return acc, acc_lse


def paged_split_plain(q, k_pages, v_pages, lengths, page_table, *,
                      chunk_lens, softmax_scale: float, n_splits: int):
    """The kernels' split-KV algorithm in plain torch, fp32: each of
    ``n_splits`` key ranges (``paged_split_keys`` keys, whole pages) gives
    every row a partial (o normalised by its own sum, lse), and
    ``merge_partials`` combines them in split order. q (b, sq, h, d) with
    tail-aligned rows as ``paged_chunk_attention``; padding rows and rows
    that see no key give 0. Returns (b, sq, h, d) fp32."""
    batch, sq, n_q_heads, d = q.shape
    n_kv_heads, _, page_size, _ = k_pages.shape
    pages_max = page_table.shape[1]
    group = n_q_heads // n_kv_heads
    dev = q.device
    qf = (q.float() * softmax_scale).reshape(
        batch, sq, n_kv_heads, group, d).permute(0, 2, 3, 1, 4)
    length = lengths.long().clamp(0, pages_max * page_size).reshape(
        batch, 1, 1, 1, 1)
    chunk = chunk_lens.long().reshape(batch, 1, 1, 1, 1)
    t = torch.arange(sq, device=dev).reshape(1, 1, 1, sq, 1)
    qpos = torch.where(t < chunk, lengths.long().reshape(
        batch, 1, 1, 1, 1) - chunk + t, -1)
    keys = paged_split_keys(pages_max, page_size, n_splits)
    # Every key position of the table, gathered once: (b, h_kv, keys, d).
    ids = page_table.long()
    k_all = k_pages[:, ids].float().permute(1, 0, 2, 3, 4).reshape(
        batch, n_kv_heads, pages_max * page_size, d)
    v_all = v_pages[:, ids].float().permute(1, 0, 2, 3, 4).reshape(
        batch, n_kv_heads, pages_max * page_size, d)
    outs, lses = [], []
    for s in range(n_splits):
        lo, hi = s * keys, min((s + 1) * keys, pages_max * page_size)
        kpos = torch.arange(lo, max(lo, hi), device=dev)
        sc = qf @ k_all[:, :, None, lo:hi].transpose(-1, -2)
        mask = paged_visibility_mask(kpos, qpos, length=length)
        sc = torch.where(mask, sc, float("-inf"))
        lse = torch.logsumexp(sc, dim=-1)  # -inf where nothing is visible
        p = torch.where(mask, torch.exp(sc - torch.where(
            torch.isneginf(lse), 0.0, lse)[..., None]), 0.0)
        outs.append(p @ v_all[:, :, None, lo:hi])
        lses.append(lse)
    out, _ = merge_partials(torch.stack(outs), torch.stack(lses))
    return out.permute(0, 3, 1, 2, 4).reshape(batch, sq, n_q_heads, d)


# ---------------------------------------------------------------- the band
#
# K1 and K2's M4 terms (csrc/mask.cuh Band): the window band, sinks, logit
# softcap and ALiBi, with their plain-torch forms.


@dataclasses.dataclass(frozen=True)
class Band:
    """The window band (``left``/``right``, None = unbounded), ``sinks``
    leading key columns visible from every row (dense form, with a band),
    the logit ``softcap`` and ALiBi ``alibi`` ((b, h) fp32 slopes divided
    by the softmax scale, as ``flash_attn_tpu/ops/attention.py:133``
    ``_norm_alibi`` makes them) of one K1/K2 call."""

    left: int | None = None
    right: int | None = None
    sinks: int = 0
    softcap: float | None = None
    alibi: torch.Tensor | None = None

    @property
    def windowed(self) -> bool:
        return self.left is not None or self.right is not None

    def args(self) -> tuple:
        """(left, right, sinks, softcap, alibi pointer) as the C entry
        points take them: -1 for an unbounded side, 0.0 for no softcap."""
        return (-1 if self.left is None else self.left,
                -1 if self.right is None else self.right, self.sinks,
                0.0 if self.softcap is None else float(self.softcap),
                None if self.alibi is None else self.alibi.data_ptr())


NO_BAND = Band()


def band_mask(band: Band, sq: int, sk: int, device, seg=None):
    """(sq, sk) (dense) or (b, 1, sq, sk) (segment form, by positions) bool,
    True = inside the band or a sink column; None without a band
    (``flash_attn_tpu/kernels/common.py`` ``window_band_mask`` without
    ``window_cell``)."""
    if not band.windowed:
        return None
    if seg is not None:
        rows, cols = seg.q_pos[:, None, :, None], seg.kv_pos[:, None, None, :]
    else:
        rows = torch.arange(sq, device=device)[:, None]
        cols = torch.arange(sk, device=device)[None, :]
    inside = torch.ones((), dtype=torch.bool, device=device)
    if band.left is not None:
        inside = inside & (cols >= rows - band.left)
    if band.right is not None:
        inside = inside & (cols <= rows + band.right)
    if band.sinks > 0:
        inside = inside | (cols < band.sinks)
    return inside


def band_distance(causal: bool, sq: int, sk: int, device, seg=None):
    """ALiBi's distance per (row, key): k - q under causal masking, -|q - k|
    otherwise, by global indices (sq, sk) or by positions (b, 1, sq, sk)."""
    if seg is not None:
        rows, cols = seg.q_pos[:, None, :, None], seg.kv_pos[:, None, None, :]
    else:
        rows = torch.arange(sq, device=device)[:, None]
        cols = torch.arange(sk, device=device)[None, :]
    return (cols - rows) if causal else -(rows - cols).abs()


# The attention kernels' operands, in the order of csrc/common.cuh Operand.
OPERANDS = ("q", "k", "v", "o", "dout", "dk", "dv", "dq")


def rows_ok(x: torch.Tensor) -> bool:
    """The kernels read or write a (b, h, s, d) operand in place: its last
    dimension is contiguous and every row starts on a 16-byte boundary."""
    size = x.element_size()
    return x.stride(-1) == 1 and x.data_ptr() % 16 == 0 and all(
        n == 1 or st * size % 16 == 0
        for n, st in zip(x.shape[:-1], x.stride()[:-1]))


def kernel_operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself when the kernels take it in place, else a copy."""
    return x if rows_ok(x) else x.contiguous()


def check_rows(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless the kernels can take every tensor in place."""
    for x in tensors:
        if not rows_ok(x):
            raise ValueError(
                f"{name}: a tensor of strides {x.stride()} needs a contiguous "
                "last dimension and 16-byte aligned rows (the kernels load "
                "16-byte vectors and TMA boxes); pass kernel_operand(x)")


def empty_rows(b, h, s, like):
    """A (b, h, s, d) output in (b, s, h, d) memory: the ops transpose it
    back to their own layout without a copy."""
    return torch.empty((b, s, h, like.shape[-1]), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def strides_arg(**operands):
    """The (batch, head, row) element strides of each of ``OPERANDS`` as
    the C entry points take them; 0 for an operand the kernel does not
    use."""
    flat = []
    for name in OPERANDS:
        x = operands.get(name)
        flat += [0, 0, 0] if x is None else list(x.stride()[:3])
    return (ctypes.c_longlong * len(flat))(*flat)


# ------------------------------------------------------------- segments
#
# The segment (varlen) form of K1 and K2 (csrc/segments.cuh). Visibility:
# query row i sees key j iff both carry the same non-negative segment id
# and, under causal masking, i's position is at or after j's
# (flash_attn_tpu/kernels/flash_fwd.py:326-333). On the card a pre-pass
# (csrc/segments.cu) turns the ids and positions into a tile plan: a class
# per (64-row query tile, 128-key tile) pair, K2's dQ ranks over the live
# pairs, the lists of live tiles the kernels walk, and, for layouts in
# interval form (padded batches, packed sequences), each token's interval
# of visible tokens on the other side.

SEG_Q_TILE, SEG_K_TILE = 64, 128  # the plan's query and key tiles
TILE_DEAD, TILE_PARTIAL, TILE_FULL = 0, 1, 2


@dataclasses.dataclass
class Segments:
    """Segment ids and per-segment positions of one attention call, each
    (b, s) int32 contiguous on the tensors' device; ``plan`` is the card's
    tile plan (``segment_plan``), made once per call and shared by the
    forward and the backward."""

    q_seg: torch.Tensor
    kv_seg: torch.Tensor
    q_pos: torch.Tensor
    kv_pos: torch.Tensor
    plan: torch.Tensor | None = None


def segment_mask(seg: Segments, causal: bool) -> torch.Tensor:
    """(b, 1, sq, sk) bool, True = visible: the plain form of the kernels'
    ``seg_visible``."""
    qs, ks = seg.q_seg[:, :, None], seg.kv_seg[:, None, :]
    mask = (qs == ks) & (qs >= 0)
    if causal:
        mask = mask & (seg.q_pos[:, :, None] >= seg.kv_pos[:, None, :])
    return mask[:, None]


def classify_segment_block(qp, kp, qs, ks, *, causal: bool,
                           bounds_possible: bool, window_left=None,
                           window_right=None):
    """(live, uniform) of one block from its position and segment-id
    vectors, as ``flash_attn_tpu/kernels/common.py:205``
    ``classify_segment_block``. ``live`` False: every pair is causally
    masked or outside the window band; ``uniform`` True: the block is
    provably mask-free. The card's plan (``segment_plan``) makes the same
    decision per tile pair over valid rows only, and also calls dead the
    pairs whose segment ranges do not meet."""
    live = torch.tensor(True)
    if causal:
        live = qp.max() >= kp.min()
    seg_lo = torch.minimum(qs.min(), ks.min())
    seg_hi = torch.maximum(qs.max(), ks.max())
    uniform = (seg_lo == seg_hi) & (seg_lo >= 0)
    if bounds_possible:
        uniform = torch.tensor(False)
    if causal:
        uniform = uniform & (qp.min() >= kp.max())
    if window_left is not None:
        live = live & (kp.max() >= qp.min() - window_left)
        uniform = uniform & (kp.min() >= qp.max() - window_left)
    if window_right is not None:
        live = live & (kp.min() <= qp.max() + window_right)
        uniform = uniform & (kp.max() <= qp.min() + window_right)
    return live, uniform


def _round4(n: int) -> int:
    return -(-n // 4) * 4


def plan_layout(b: int, sq: int, sk: int) -> dict:
    """{section: (offset, shape)} of the plan's int32 words
    (csrc/segments.cuh SegPlanT::at), and "words": the total."""
    n_q64, n_q128 = -(-sq // 64), -(-sq // 128)
    n_k128 = -(-sk // 128)
    shapes = {"qsp": (b, n_q128 * 128, 2), "ksp": (b, n_k128 * 128, 2),
              "qsum": (b, n_q64, 8), "ksum": (b, n_k128, 8),
              "cls": (b, n_q64, n_k128), "fwd_n": (b, n_q128),
              "fwd": (b, n_q128, n_k128), "bwd_n": (b, n_k128),
              "bwd": (b, n_k128, n_q64, 2), "ivf": (b,),
              "qiv": (b, n_q128 * 128, 2), "kiv": (b, n_k128 * 128, 2)}
    out, off = {}, 0
    for name, shape in shapes.items():
        out[name] = (off, shape)
        off += _round4(math.prod(shape))
    out["words"] = off
    return out


def plan_sections(plan: torch.Tensor, b: int, sq: int, sk: int) -> dict:
    """Views of each section of a plan buffer."""
    layout = plan_layout(b, sq, sk)
    del layout["words"]
    return {name: plan[off:off + math.prod(shape)].view(shape)
            for name, (off, shape) in layout.items()}


def _int32(x: torch.Tensor) -> torch.Tensor:
    """int64 words as the int32 bit patterns the card writes."""
    return (((x & 0xFFFFFFFF) + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _tile_sums(rows: torch.Tensor, tile: int) -> torch.Tensor:
    """Per-tile (seg min, seg max, pos min, pos max, pure, 0, 0, 0) over
    the valid rows of (b, n * tile, 2) (id, position) pairs."""
    b = rows.shape[0]
    r = rows.reshape(b, -1, tile, 2).long()
    valid = r[..., 0] >= 0
    big, small = 2 ** 31 - 1, -2 ** 31
    seg_min = torch.where(valid, r[..., 0], big).amin(-1)
    seg_max = torch.where(valid, r[..., 0], small).amax(-1)
    pos_min = torch.where(valid, r[..., 1], big).amin(-1)
    pos_max = torch.where(valid, r[..., 1], small).amax(-1)
    pure = valid.all(-1) & (seg_min == seg_max)
    zero = torch.zeros_like(seg_min)
    return torch.stack([seg_min, seg_max, pos_min, pos_max, pure.long(),
                        zero, zero, zero], dim=-1)


def _compact(live: torch.Tensor, entries: torch.Tensor):
    """Entries where ``live``, in order, to the front of the last axis (the
    rest: zeros), and the count per list."""
    order = torch.argsort((~live).to(torch.int8), dim=-1, stable=True)
    idx = order.view(*order.shape, *([1] * (entries.dim() - live.dim())))
    picked = torch.gather(entries, live.dim() - 1,
                          idx.expand(*order.shape, *entries.shape[
                              live.dim():]))
    n = live.sum(-1)
    keep = torch.arange(live.shape[-1], device=live.device) < n[..., None]
    keep = keep.view(*keep.shape, *([1] * (entries.dim() - live.dim())))
    return torch.where(keep, picked, 0), n


def _interval_form(rows: torch.Tensor, n: int) -> torch.Tensor:
    """(b,) True where rows (b, >= n, 2) of (id, position) are in the
    interval form of csrc/segments.cuh: padding only after the valid
    tokens, runs of increasing id, positions 0, 1, ... inside each run."""
    seg, pos = rows[:, :n, 0], rows[:, :n, 1]
    valid = seg >= 0
    first = ~valid[:, :1] | (pos[:, :1] == 0)
    prev_seg, prev_pos, cur_seg, cur_pos = (seg[:, :-1], pos[:, :-1],
                                            seg[:, 1:], pos[:, 1:])
    step = torch.where(prev_seg == cur_seg, cur_pos == prev_pos + 1,
                       (cur_seg > prev_seg) & (cur_pos == 0))
    rest = ~valid[:, 1:] | ((prev_seg >= 0) & step)
    return first.all(1) & rest.all(1)


def _intervals(mine, other, n_other, causal: bool, is_query: bool,
               band: Band = NO_BAND):
    """Per token of ``mine`` (b, m, 2) its interval on the other side: the
    run of its id among the other side's first ``n_other`` (b,) tokens,
    cut by causality (a query's keys up to the run's start + its position;
    a key's queries from there) and by the band; (0, 0) where empty."""
    out = torch.zeros_like(mine)
    below, above = ((band.left, band.right) if is_query
                    else (band.right, band.left))
    for bb in range(mine.shape[0]):
        ids = other[bb, :int(n_other[bb]), 0].contiguous()
        s = mine[bb, :, 0].contiguous()
        lo = torch.searchsorted(ids, s, right=False)
        hi = torch.searchsorted(ids, s, right=True)
        start, pos = lo.clone(), mine[bb, :, 1]
        if causal and is_query:
            hi = torch.minimum(hi, lo + pos + 1)
        elif causal:
            lo = lo + pos
        if below is not None:
            lo = torch.maximum(lo, start + pos - below)
        if above is not None:
            hi = torch.minimum(hi, start + pos + above + 1)
        keep = (s >= 0) & (hi > lo)
        out[bb, :, 0] = torch.where(keep, lo, 0)
        out[bb, :, 1] = torch.where(keep, hi, 0)
    return out


def segment_plan_plain(seg: Segments, causal: bool,
                       band: Band = NO_BAND) -> dict:
    """The plan's sections (``plan_sections``) in plain torch, as the
    pre-pass of csrc/segments.cu writes them; list tails past their counts
    are zeros here (the card leaves them unwritten)."""
    b, sq = seg.q_seg.shape
    sk = seg.kv_seg.shape[1]
    lay = plan_layout(b, sq, sk)
    dev = seg.q_seg.device

    def rows(ids, pos, n):
        out = torch.zeros((b, n, 2), dtype=torch.int64, device=dev)
        out[..., 0] = -1
        out[:, :ids.shape[1], 0] = ids
        out[:, :ids.shape[1], 1] = pos
        return out

    qsp = rows(seg.q_seg, seg.q_pos, lay["qsp"][1][1])
    ksp = rows(seg.kv_seg, seg.kv_pos, lay["ksp"][1][1])
    n_q64 = lay["qsum"][1][1]
    qsum = _tile_sums(qsp[:, :n_q64 * 64], SEG_Q_TILE)
    ksum = _tile_sums(ksp, SEG_K_TILE)
    q, k = qsum[:, :, None], ksum[:, None, :]
    empty = (q[..., 0] > q[..., 1]) | (k[..., 0] > k[..., 1])
    apart = (q[..., 1] < k[..., 0]) | (k[..., 1] < q[..., 0])
    dead = empty | apart
    if causal:
        dead = dead | (q[..., 3] < k[..., 2])
    full = (q[..., 4] == 1) & (k[..., 4] == 1) & (q[..., 0] == k[..., 0])
    if causal:
        full = full & (q[..., 2] >= k[..., 3])
    if band.left is not None:  # key positions against the band's floor
        dead = dead | (k[..., 3] < q[..., 2] - band.left)
        full = full & (k[..., 2] >= q[..., 3] - band.left)
    if band.right is not None:
        dead = dead | (k[..., 2] > q[..., 3] + band.right)
        full = full & (k[..., 3] <= q[..., 2] + band.right)
    cls = torch.where(dead, TILE_DEAD, torch.where(full, TILE_FULL,
                                                   TILE_PARTIAL))
    # dQ ranks over the live pairs, in K2's launch order of key tiles (the
    # last first).
    n_k = cls.shape[2]
    order = torch.arange(n_k, device=dev).flip(0)
    live_o = (cls[:, :, order] != TILE_DEAD).long()
    rank = torch.empty_like(live_o)
    rank[:, :, order] = live_o.cumsum(-1) - live_o
    words = cls | (rank << 2)
    # K1: per 128-row query tile, its live key tiles.
    n_q128 = lay["fwd_n"][1][1]
    c = torch.zeros((b, 2 * n_q128, n_k), dtype=torch.int64, device=dev)
    c[:, :n_q64] = cls
    c0, c1 = c[:, 0::2], c[:, 1::2]
    kt = torch.arange(n_k, device=dev).expand_as(c0)
    fwd, fwd_n = _compact((c0 | c1) != TILE_DEAD, kt | (c0 << 28) | (c1 << 30))
    # K2: per key tile, its live query tiles and their ranks.
    cls_t, rank_t = cls.transpose(1, 2), rank.transpose(1, 2)
    qt = torch.arange(n_q64, device=dev).expand_as(cls_t)
    bwd, bwd_n = _compact(cls_t != TILE_DEAD, torch.stack(
        [qt | (cls_t << 30), rank_t], dim=-1))
    # The interval form and its bounds.
    form = _interval_form(qsp, sq) & _interval_form(ksp, sk)
    n_q, n_kv = (qsp[..., 0] >= 0).sum(1), (ksp[..., 0] >= 0).sum(1)
    keep = form[:, None, None]
    qiv = torch.where(keep, _intervals(qsp, ksp, n_kv, causal, True, band),
                      0)
    kiv = torch.where(keep, _intervals(ksp, qsp, n_q, causal, False, band),
                      0)
    return {"qsp": _int32(qsp), "ksp": _int32(ksp), "qsum": _int32(qsum),
            "ksum": _int32(ksum), "cls": _int32(words),
            "fwd_n": _int32(fwd_n), "fwd": _int32(fwd),
            "bwd_n": _int32(bwd_n), "bwd": _int32(bwd),
            "ivf": _int32(form.long()), "qiv": _int32(qiv),
            "kiv": _int32(kiv)}


def segment_plan(seg: Segments, causal: bool,
                 band: Band = NO_BAND) -> torch.Tensor:
    """The card's tile plan for ``seg`` under ``band``'s window (one launch
    of csrc/segments.cu), stored in ``seg.plan`` and returned. CUDA tensors
    only."""
    b, sq = seg.q_seg.shape
    sk = seg.kv_seg.shape[1]
    _build.require_cuda("segment_plan", seg.q_seg, seg.kv_seg, seg.q_pos,
                        seg.kv_pos)
    lib = _build.lib()
    plan = torch.empty(lib.fattn_seg_plan_words(b, sq, sk),
                       dtype=torch.int32, device=seg.q_seg.device)
    code = lib.fattn_seg_plan(
        seg.q_seg.data_ptr(), seg.kv_seg.data_ptr(), seg.q_pos.data_ptr(),
        seg.kv_pos.data_ptr(), plan.data_ptr(), b, sq, sk, int(causal),
        *band.args()[:2], _build.stream_ptr(plan.device))
    segment_plan.launches += 1
    _build.check(code, "fattn_seg_plan")
    seg.plan = plan
    return plan


_build.counter(segment_plan)
