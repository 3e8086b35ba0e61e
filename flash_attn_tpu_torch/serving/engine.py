"""Continuous-batching serving engine for GPT-2 and Llama (port of
``flash_attn_tpu/serving/engine.py``).

Host-side scheduler with numpy tables; device-side steps in PyTorch over
the port's kernels:

  - requests queue; admission whenever a batch slot AND enough cache pages
    are free (paged allocator, serving/cache.py)
  - prefill: every admissible pending request in one bucketed call
    (prompts padded to a shared 128-multiple bucket, batch padded to a
    power of two, as in the JAX engine), K/V then written into each
    request's pages by the page-copy kernel (one launch per layer); or, with
    ``prefill_chunk``, in page-aligned chunks of that many tokens, each
    written to its pages and attended against the cache by the
    multi-token paged kernel (``chunk_prefill_step``)
  - decode: all active slots advance one token per engine step through
    the cache-append and paged decode kernels (inactive slots are masked
    and write to the reserved scratch page 0)
  - preemption: when decode-time growth finds the pool empty, the youngest
    sequence goes back to the queue and is recomputed on re-admission
  - sampling: greedy (temperature=0), or temperature softmax sampling with
    optional top-k from a ``torch.Generator`` seeded with ``sample_seed``
    (it does not reproduce the JAX engine's random bits)
  - sequences retire on EOS / max tokens

The model's phases come from ``model_fns`` (default ``gpt2_decode``; pass
``llama_decode`` with a ``LlamaForCausalLM``). With ``cfg.window`` the
phases attend through the band, and ``stream_free_pages`` (the default)
returns each sequence's pages that fell below its decode band to the pool
before every growth pass (``pages_freed``; ``peak_pages`` is the most in
use). Quantized KV (``kv_quantization``) is ROADMAP port item M5.

Spans (``tracing``): ``serve.step`` around each step, ``serve.chunk``
around each prefill chunk, ``serve.to_device`` around each host-to-device
copy and ``serve.readback`` around each read of sampled tokens.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from flash_attn_tpu_torch import tracing
from flash_attn_tpu_torch.models import gpt2_decode
from flash_attn_tpu_torch.serving.cache import (
    PageAllocator,
    _write_prompts,
    init_cache,
)


@dataclasses.dataclass
class Request:
    seq_id: int
    prompt: list[int]
    max_new_tokens: int
    generated: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def _next_pow2(x):
    n = 1
    while n < x:
        n *= 2
    return n


class ServingEngine:
    def __init__(
        self,
        model: torch.nn.Module,
        cfg,
        *,
        max_batch: int = 8,
        num_pages: int = 128,
        page_size: int = 128,
        pages_per_seq: int = 16,
        kv_quantization: str | None = None,
        eos_token: int | None = None,
        temperature: float = 0.0,  # 0 = greedy argmax
        top_k: int | None = None,  # with temperature > 0
        sample_seed: int = 0,
        stream_free_pages: bool = True,
        prefill_chunk: int | None = None,
        model_fns=gpt2_decode,
    ):
        """``model_fns``: a module with ``prefill``, ``decode_step`` and
        ``chunk_prefill_step`` of ``gpt2_decode``'s signatures, for
        ``model`` and ``cfg``. ``prefill_chunk``: admit prompts in chunks
        of this many tokens (a positive multiple of ``page_size``) instead
        of one bucketed call. ``stream_free_pages`` (with ``cfg.window``):
        return a sequence's pages that fell below its decode band (and
        hold no sink) to the pool mid-flight, so its live pages follow the
        window, not the context."""
        if prefill_chunk is not None and (
                prefill_chunk <= 0 or prefill_chunk % page_size):
            raise ValueError(
                f"prefill_chunk must be a positive multiple of "
                f"page_size={page_size}, got {prefill_chunk}")
        if kv_quantization is not None:
            raise NotImplementedError(
                "kv_quantization: quantized KV is ROADMAP port item M5")
        first = next(model.parameters())
        if first.dtype != cfg.dtype:
            # Serve a copy stored in the compute dtype, cast once here, so
            # that no decode step casts the weights.
            model = copy.deepcopy(model).to(cfg.dtype)
        self.model = model
        self.cfg = cfg
        self.model_fns = model_fns
        self.prefill_chunk = prefill_chunk
        self.device = first.device
        self.max_batch = max_batch
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.eos_token = eos_token
        self.temperature = float(temperature)
        self.top_k = top_k
        # Streaming sliding-window serving (JAX engine.py:95-101).
        self._stream_free = bool(stream_free_pages) and cfg.window is not None
        self.pages_freed = 0  # pages returned mid-flight by the stream
        self.peak_pages = 0  # most pages in use after a growth pass
        self.caches = [
            init_cache(cfg.n_kv_heads, num_pages, page_size, cfg.head_dim,
                       dtype=cfg.dtype, device=self.device)
            for _ in range(cfg.n_layer)
        ]
        self.alloc = PageAllocator(
            num_pages, page_size, pages_per_seq, reserved=1
        )
        # With the pool at least one full sequence deep, decode-time
        # growth always succeeds after preempting every other sequence —
        # the invariant the preemption path (step()) relies on.
        if self.alloc.capacity < min(
            pages_per_seq,
            -(-cfg.max_position_embeddings // page_size),
        ):
            raise ValueError(
                f"num_pages={num_pages} (capacity {self.alloc.capacity} "
                "after the reserved scratch page) cannot hold even one "
                f"full sequence (min(pages_per_seq={pages_per_seq}, "
                "ceil(max_position_embeddings/page_size)="
                f"{-(-cfg.max_position_embeddings // page_size)}) pages)"
            )
        self.page_table = np.zeros((max_batch, pages_per_seq), np.int32)
        self.lengths = np.full((max_batch,), -1, np.int32)  # -1 = free slot
        self.next_token = np.zeros((max_batch,), np.int32)
        self.slot_req: dict[int, Request] = {}
        self.pending: list[Request] = []
        self.finished: list[Request] = []
        self._next_id = 0
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(sample_seed)

    # -- public API ---------------------------------------------------------

    def submit(self, prompt: list[int], max_new_tokens: int = 32) -> int:
        # Validate capacity HERE, before any allocator state changes: a
        # reject mid-_admit would leak peers' already-allocated pages.
        limit = min(
            self.cfg.max_position_embeddings,
            self.pages_per_seq * self.page_size,
        )
        if not prompt:
            raise ValueError("empty prompt")
        # +1: room for at least the first generated token's KV slot.
        if len(prompt) + 1 > limit:
            raise ValueError(
                f"prompt of {len(prompt)} tokens exceeds engine capacity "
                f"{limit - 1} (min of max_position_embeddings="
                f"{self.cfg.max_position_embeddings} and pages_per_seq*"
                f"page_size={self.pages_per_seq * self.page_size}, less "
                "one generated-token slot)"
            )
        req = Request(self._next_id, list(prompt), max_new_tokens)
        self._next_id += 1
        self.pending.append(req)
        return req.seq_id

    def has_work(self) -> bool:
        return bool(self.pending or self.slot_req)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        steps = 0
        while self.has_work() and steps < max_steps:
            self.step()
            steps += 1
        return self.finished

    # -- internals ----------------------------------------------------------

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        with tracing.span("serve.to_device"):
            return torch.from_numpy(a).to(self.device)

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        if self.temperature <= 0.0:
            tok = torch.argmax(logits, dim=-1)
        else:
            scaled = logits.float() / self.temperature
            if self.top_k is not None:
                kth = torch.topk(scaled, self.top_k, dim=-1).values[..., -1:]
                scaled = scaled.masked_fill(scaled < kth, float("-inf"))
            tok = torch.multinomial(torch.softmax(scaled, dim=-1), 1,
                                    generator=self._generator)[:, 0]
        tok = tok.to(torch.int32)
        with tracing.span("serve.readback"):
            return tok.cpu().numpy()

    def _free_slots(self) -> list[int]:
        return [i for i in range(self.max_batch) if self.lengths[i] < 0]

    def _admit(self) -> None:
        """Admit every pending request that fits (slot + pages) in ONE
        batched, bucketed prefill call.

        The effective prompt is ``req.prompt + req.generated``: for fresh
        requests that is just the prompt; for requests preempted mid-decode
        it recomputes the whole context so generation continues where it
        left off."""
        slots = self._free_slots()
        batch: list[tuple[int, Request, list[int]]] = []
        while self.pending and slots:
            req = self.pending[0]
            eff_len = len(req.prompt) + len(req.generated)
            if not self.alloc.can_admit(eff_len + 1):
                break
            self.pending.pop(0)
            pages = self.alloc.alloc(req.seq_id, eff_len + 1)
            batch.append((slots.pop(0), req, pages))
        if not batch:
            return

        if self.prefill_chunk is not None:
            first = self._prefill_chunked(batch)
        else:
            first = self._prefill_single_shot(batch)
        for i, (slot, req, pages) in enumerate(batch):
            self.lengths[slot] = len(req.prompt) + len(req.generated)
            self.page_table[slot] = self.alloc.table_row(req.seq_id)
            self.next_token[slot] = int(first[i])
            self.slot_req[slot] = req
            req.generated.append(int(first[i]))
            # The prefill token may already complete the request
            # (max_new_tokens=1 or immediate EOS).
            self._maybe_retire(slot, req, int(first[i]))

    def _prefill_single_shot(self, batch) -> np.ndarray:
        """Whole prompts in one bucketed call; K/V written to pages
        afterwards. Returns the first sampled tokens."""
        prompts = [req.prompt + req.generated for _, req, _ in batch]
        max_len = max(len(p) for p in prompts)
        # Clamp to the position-embedding table: a 128-rounded bucket may
        # exceed it; prefill handles any bucket length.
        bucket = min(_round_up(max_len, 128),
                     self.cfg.max_position_embeddings)
        rows = _next_pow2(len(batch))
        ids = np.zeros((rows, bucket), np.int64)
        lens = np.zeros((rows,), np.int32)
        for i, p in enumerate(prompts):
            ids[i, : len(p)] = p
            lens[i] = len(p)
        logits, ks, vs = self.model_fns.prefill(
            self.model, self.cfg, self._to_device(ids), self._to_device(lens)
        )
        first = self._sample(logits)
        # Every admitted row's pages for every layer; page-list entries
        # beyond a prompt's pages (and padding rows) name the reserved
        # scratch page 0. Ceil: the clamped bucket need not be a page_size
        # multiple (the page write zero-pads the tail page).
        pages_per_bucket = -(-bucket // self.page_size)
        tbl = np.zeros((rows, pages_per_bucket), np.int32)
        for i, (_, req, pages) in enumerate(batch):
            tbl[i, : len(pages[:pages_per_bucket])] = pages[:pages_per_bucket]
        tbl_d = self._to_device(tbl)
        for cache, k, v in zip(self.caches, ks, vs):
            _write_prompts(cache, k, v, tbl_d)  # one K7c launch per layer
        return first

    def _prefill_chunked(self, batch) -> np.ndarray:
        """Walk the admitted prompts in page-aligned chunks of
        ``prefill_chunk`` tokens: each chunk's K/V go to its pages and the
        chunk attends to the cache, earlier chunks included. Each chunk's
        tables are built on the host and copied to the device once. Returns
        each row's first token, sampled from the chunk where its prompt
        ends."""
        C, ps = self.prefill_chunk, self.page_size
        rows = _next_pow2(len(batch))
        prompts = [req.prompt + req.generated for _, req, _ in batch]
        lens = [len(p) for p in prompts]
        pages_per_chunk = C // ps
        tbl = np.zeros((rows, self.pages_per_seq), np.int32)
        for i, (_, _, pages) in enumerate(batch):
            tbl[i, : len(pages)] = pages
        tbl_d = self._to_device(tbl)
        first = np.zeros((len(batch),), np.int32)
        for off in range(0, max(lens), C):
            with tracing.span("serve.chunk"):
                ids = np.zeros((rows, C), np.int64)
                pos0 = np.zeros((rows,), np.int32)
                cl = np.zeros((rows,), np.int32)
                wtbl = np.zeros((rows, pages_per_chunk), np.int32)
                for i, (_, _, pages) in enumerate(batch):
                    pos0[i] = min(lens[i], off)
                    cl[i] = max(0, min(lens[i] - off, C))
                    if cl[i] > 0:
                        ids[i, : cl[i]] = prompts[i][off : off + cl[i]]
                        span = pages[off // ps : off // ps + pages_per_chunk]
                        wtbl[i, : len(span)] = span
                logits, self.caches = self.model_fns.chunk_prefill_step(
                    self.model, self.cfg, self.caches, self._to_device(ids),
                    self._to_device(pos0), self._to_device(cl),
                    self._to_device(wtbl), tbl_d)
                ending = [i for i in range(len(batch))
                          if off < lens[i] <= off + C]
                if ending:
                    sampled = self._sample(logits)
                    first[ending] = sampled[ending]
        return first

    def _preempt_youngest(self, exclude_slot: int) -> bool:
        """Evict the most recently submitted active sequence back to the
        pending queue (recompute preemption): its pages go to the pool now;
        on re-admission the whole context is re-prefilled."""
        cands = [
            (r.seq_id, s)
            for s, r in self.slot_req.items()
            if s != exclude_slot
        ]
        if not cands:
            return False
        _, victim = max(cands)
        vreq = self.slot_req.pop(victim)
        self.alloc.release(vreq.seq_id)
        self.lengths[victim] = -1
        self.page_table[victim] = 0
        self.pending.insert(0, vreq)
        return True

    def _reclaim_dead_pages(self, slot: int, req: Request) -> int:
        """Free this sequence's pages that are for good below the decode
        band (JAX engine.py:270-284): page p is dead once (p + 1) *
        page_size <= length - 1 - window (the band floor only moves on)
        and p holds no sink position."""
        if not self._stream_free:
            return 0
        win_lo = int(self.lengths[slot]) - 1 - self.cfg.window
        end = max(0, win_lo) // self.page_size
        sinks = getattr(self.cfg, "window_sinks", 0) or 0
        start = -(-sinks // self.page_size)
        if end <= start:
            return 0
        return self.alloc.release_range(req.seq_id, start, end)

    def step(self) -> None:
        """Admit what fits, then advance every active slot by one token."""
        with tracing.span("serve.step"):
            self._step()

    def _step(self) -> None:
        self._admit()
        if not self.slot_req:
            return
        # Reclaim out-of-band pages FIRST (all slots), so the growth pass
        # below sees every reclaimable page in the pool.
        for slot, req in list(self.slot_req.items()):
            freed = self._reclaim_dead_pages(slot, req)
            if freed:
                self.pages_freed += freed
                self.page_table[slot] = self.alloc.table_row(req.seq_id)
        # Grow page tables where the next token crosses a page boundary.
        # On pool exhaustion, preempt the youngest peer and retry — the
        # __init__ capacity invariant guarantees a lone sequence can
        # always grow to its retire cap.
        for slot, req in list(self.slot_req.items()):
            if slot not in self.slot_req:  # preempted by an earlier grow
                continue
            new_len = int(self.lengths[slot]) + 1
            while True:
                try:
                    page = self.alloc.extend(req.seq_id, new_len + 1)
                    break
                except RuntimeError as e:
                    if "out of KV-cache pages" not in str(e):
                        raise
                    if not self._preempt_youngest(slot):
                        raise
            if page is not None:
                self.page_table[slot] = self.alloc.table_row(req.seq_id)
        self.peak_pages = max(self.peak_pages,
                              self.alloc.capacity - self.alloc.free_pages)
        active = np.asarray(
            [s in self.slot_req for s in range(self.max_batch)]
        )
        lengths = np.where(active, self.lengths, -1).astype(np.int32)
        logits, self.caches = self.model_fns.decode_step(
            self.model, self.cfg, self.caches,
            self._to_device(self.page_table), self._to_device(lengths),
            self._to_device(self.next_token.astype(np.int64)),
        )
        next_tok = self._sample(logits)
        for slot, req in list(self.slot_req.items()):
            self.lengths[slot] += 1
            tok = int(next_tok[slot])
            req.generated.append(tok)
            self.next_token[slot] = tok
            self._maybe_retire(slot, req, tok)

    def _maybe_retire(self, slot: int, req: Request, tok: int) -> None:
        if (
            len(req.generated) >= req.max_new_tokens
            or (self.eos_token is not None and tok == self.eos_token)
            or self.lengths[slot] + 1
            >= min(
                self.cfg.max_position_embeddings,
                self.pages_per_seq * self.page_size,
            )
        ):
            req.done = True
            self.finished.append(req)
            self.alloc.release(req.seq_id)
            self.lengths[slot] = -1
            self.page_table[slot] = 0
            del self.slot_req[slot]
