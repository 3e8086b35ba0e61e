"""Continuous-batching serving engine for GPT-2 (port of
``flash_attn_tpu/serving/engine.py``).

Host-side scheduler with numpy tables; device-side steps in PyTorch over
the port's kernels:

  - requests queue; admission whenever a batch slot AND enough cache pages
    are free (paged allocator, serving/cache.py)
  - prefill: every admissible pending request in one bucketed call
    (prompts padded to a shared 128-multiple bucket, batch padded to a
    power of two, as in the JAX engine), K/V then written into each
    request's pages by the page-copy kernel (``write_prompt``)
  - decode: all active slots advance one token per engine step through
    the cache-append and paged decode kernels (inactive slots are masked
    and write to the reserved scratch page 0)
  - preemption: when decode-time growth finds the pool empty, the youngest
    sequence goes back to the queue and is recomputed on re-admission
  - sampling: greedy (temperature=0), or temperature softmax sampling with
    optional top-k from a ``torch.Generator`` seeded with ``sample_seed``
    (it does not reproduce the JAX engine's random bits)
  - sequences retire on EOS / max tokens

Chunked prefill (``prefill_chunk``), quantized KV (``kv_quantization``) and
sliding windows (``cfg.window``) are ROADMAP port items P4, P3 and P2.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from flash_attn_tpu_torch.models import gpt2_decode
from flash_attn_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from flash_attn_tpu_torch.serving.cache import (
    PageAllocator,
    init_cache,
    write_prompt,
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
        model: GPT2LMHeadModel,
        cfg: GPT2Config,
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
        prefill_chunk: int | None = None,
    ):
        if prefill_chunk is not None:
            raise NotImplementedError(
                "prefill_chunk: chunked prefill is ROADMAP port item P4")
        if kv_quantization is not None:
            raise NotImplementedError(
                "kv_quantization: quantized KV is ROADMAP port item P3")
        if cfg.window is not None:
            raise NotImplementedError(
                "cfg.window: sliding-window serving is ROADMAP port item P2")
        if model.wte.weight.dtype != cfg.dtype:
            # Serve a copy stored in the compute dtype, cast once here, so
            # that no decode step casts the weights.
            model = copy.deepcopy(model).to(cfg.dtype)
        self.model = model
        self.cfg = cfg
        self.device = model.wte.weight.device
        self.max_batch = max_batch
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self.eos_token = eos_token
        self.temperature = float(temperature)
        self.top_k = top_k
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
        return tok.to(torch.int32).cpu().numpy()

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
        logits, ks, vs = gpt2_decode.prefill(
            self.model, self.cfg, self._to_device(ids), self._to_device(lens)
        )
        first = self._sample(logits)
        # Every admitted row's pages for every layer; page-list entries
        # beyond a prompt's pages (and padding rows) name the reserved
        # scratch page 0. Ceil: the clamped bucket need not be a page_size
        # multiple (write_prompt zero-pads the tail page).
        pages_per_bucket = -(-bucket // self.page_size)
        tbl = np.zeros((rows, pages_per_bucket), np.int32)
        for i, (_, req, pages) in enumerate(batch):
            tbl[i, : len(pages[:pages_per_bucket])] = pages[:pages_per_bucket]
        tbl_d = self._to_device(tbl)
        for cache, k, v in zip(self.caches, ks, vs):
            for i in range(rows):
                write_prompt(cache, k[i], v[i], tbl_d[i])
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

    def step(self) -> None:
        """Admit what fits, then advance every active slot by one token."""
        self._admit()
        if not self.slot_req:
            return
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
        active = np.asarray(
            [s in self.slot_req for s in range(self.max_batch)]
        )
        lengths = np.where(active, self.lengths, -1).astype(np.int32)
        logits, self.caches = gpt2_decode.decode_step(
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
