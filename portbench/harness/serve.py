"""Serving cells: the port's ``ServingEngine`` driven by a closed loop of
clients, then its served tokens judged by the plain reference.

The loop is opened in set-up and run until every client's first request
has finished, so the window opens on a loop in its steady state: the
clients' requests are staggered, none waits on the first lockstep
admission. Requests submitted inside the window are the window's.

The engine gets the family's ``model_fns`` wrapped so that each call into
the model is a span (in the traced run it ends in a synchronize and keeps
its arguments' sizes). Token times are taken at step boundaries: a
request's first token, sampled during admission, is on the host when the
step's decode call starts; the others when ``step()`` returns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.harness.common import (
    Profiled,
    Spans,
    clock,
    log,
    make_weights,
    weight_seed,
)
from portbench.harness.traffic import Mix

DRAIN_S = 120.0  # after the window: longest wait for its requests


class WrappedFns:
    """The family's serving phases, each call a span."""

    def __init__(self, fns, spans: Spans, device, traced: bool):
        self.fns, self.spans, self.device = fns, spans, device
        self.traced = traced
        self.last_decode_t0 = None

    def chunk_prefill_step(self, model, cfg, caches, input_ids, pos0,
                           chunk_lens, write_tbl, page_table):
        with self.spans.span("chunk_prefill_step") as sp:
            out = self.fns.chunk_prefill_step(model, cfg, caches, input_ids,
                                              pos0, chunk_lens, write_tbl,
                                              page_table)
            if self.traced:
                self.device.sync()
        if self.traced:
            sp.info.update(rows=input_ids.shape[0], width=input_ids.shape[1],
                           pos0=pos0.cpu().tolist(),
                           chunk_lens=chunk_lens.cpu().tolist())
        return out

    def decode_step(self, model, cfg, caches, page_table, lengths,
                    token_ids):
        self.last_decode_t0 = clock()
        with self.spans.span("decode_step") as sp:
            out = self.fns.decode_step(model, cfg, caches, page_table,
                                       lengths, token_ids)
            if self.traced:
                self.device.sync()
        if self.traced:
            sp.info["lengths"] = lengths.cpu().tolist()
        return out


@dataclasses.dataclass
class Served:
    """One request as the benchmark saw it."""
    req: object  # the engine's Request
    prompt: list
    want: int
    submitted: float
    times: list = dataclasses.field(default_factory=list)

    @property
    def first(self):
        return self.times[0] if self.times else None


class Loop:
    """Steps the engine and stamps every new token."""

    def __init__(self, engine, fns: WrappedFns, spans: Spans):
        self.engine, self.fns, self.spans = engine, fns, spans
        self.open: list[Served] = []
        self.steps = 0
        self.k = 0  # requests submitted

    def submit(self, mix: Mix) -> Served:
        d = mix.draw(self.k)
        self.k += 1
        prompt = mix.ids(d.prompt_len)
        self.engine.submit(prompt, max_new_tokens=d.output_len)
        s = Served(self.engine.pending[-1], prompt, d.output_len, clock())
        self.open.append(s)
        return s

    def step(self) -> list[Served]:
        """One engine step; returns the requests it finished."""
        before = [len(s.req.generated) for s in self.open]
        self.fns.last_decode_t0 = None
        t_a = clock()
        with self.spans.span("engine.step"):
            self.engine.step()
        t_b = clock()
        self.steps += 1
        t_first = self.fns.last_decode_t0 or t_b
        done, still = [], []
        for s, n0 in zip(self.open, before):
            n1 = len(s.req.generated)
            if n1 > n0:
                if n0 == 0:
                    s.times.append(max(t_first, t_a))
                    n0 = 1
                s.times.extend([t_b] * (n1 - n0))
            (done if s.req.done else still).append(s)
        self.open = still
        return done


def warm(engine, t: dict, vocab: int):
    """Every shape the mix can give the engine: one admission at each
    power-of-two row count up to ``max_batch`` (one chunk per prompt),
    then decode steps at the engine's fixed batch."""
    rng = np.random.default_rng(0)
    chunk = t["engine"]["prefill_chunk"]
    rows = 1
    while rows <= t["engine"]["max_batch"]:
        for _ in range(rows):
            engine.submit(rng.integers(0, vocab, chunk).tolist(),
                          max_new_tokens=2)
        engine.run()
        rows *= 2
    engine.finished.clear()
    engine.pages_freed = engine.peak_pages = 0


def setup(r):
    """Weights from the seed, the port's model holding them, and an engine
    over the wrapped phases, warmed on every shape of the mix."""
    from flash_attn_tpu_torch.serving import ServingEngine

    c, t, dev = r.config, r.traffic, r.device
    pcfg = r.family.port_config(c, train=False)
    weights = make_weights(r.family.param_spec(c), weight_seed(r.seed),
                           pcfg.dtype, dev.torch_device)
    model = r.family.build(pcfg, weights, dev.torch_device, train=False)
    spans = Spans(annotate=r.trace)
    fns = WrappedFns(r.family.model_fns, spans, dev, r.trace)
    engine = ServingEngine(model, pcfg, model_fns=fns, eos_token=None,
                           **t["engine"])
    warm(engine, t, c["vocab_size"])
    return weights, engine, fns, spans


def ramp(r, engine, fns, spans, mix: Mix) -> Loop:
    """The closed loop opened: every client submits, and each finished
    request is followed by the client's next one, until every client's
    first request has finished. Part of set-up."""
    loop = Loop(engine, fns, spans)
    first = [loop.submit(mix) for _ in range(r.traffic["clients"])]
    while not all(s.req.done for s in first):
        for _ in loop.step():
            loop.submit(mix)
    log(f"serve: loop opened in {loop.steps} engine steps, "
        f"{loop.k - len(first)} requests after the first {len(first)}; "
        f"peak pages {engine.peak_pages} of {engine.alloc.capacity}")
    engine.pages_freed = engine.peak_pages = 0
    return loop


def window(r, loop: Loop, mix: Mix, prof=None) -> dict:
    """The measured window, then the drain of the requests submitted in
    it (and of those in flight when it opened)."""
    engine, spans = loop.engine, loop.spans
    # The profiled sub-window is the window's last trace_seconds: stopping
    # the profiler takes seconds, which then fall after the close.
    p_at = r.seconds - r.traffic["trace_seconds"]
    served: list[Served] = []
    in_flight = list(loop.open)
    steps0 = loop.steps
    t0 = clock()
    t_end = t0 + r.seconds
    while True:
        now = clock()
        if now >= t_end:
            break
        if prof is not None and prof.state == "idle" and now - t0 >= p_at:
            prof.start()
        for _ in loop.step():
            served.append(loop.submit(mix))
    t_close = clock()
    if prof is not None and prof.state == "on":
        prof.stop()
    window_spans = list(spans.items)
    drain_to = clock() + DRAIN_S
    while loop.open and clock() < drain_to:
        loop.step()
    t_drained = clock()
    log(f"serve: {len(served)} requests submitted in {t_close - t0:.3f} s, "
        f"{loop.steps - steps0} engine steps; pages freed mid-flight "
        f"{engine.pages_freed}, peak pages {engine.peak_pages} of "
        f"{engine.alloc.capacity}; drained in {t_drained - t_close:.3f} s")
    return dict(window=(t0, t_close), t_drained=t_drained, served=served,
                in_flight=in_flight, spans=window_spans,
                attempted=len(served),
                failed=sum(1 for s in served if not s.req.done))


def run(r) -> dict:
    """The serving cell ``r`` (a harness.cell.Run): set-up, the window,
    the drain, then the check. Returns the run's records."""
    dev = r.device
    weights, engine, fns, spans = setup(r)
    prof = Profiled(dev) if r.trace else None
    mix = Mix(r.traffic, r.seed, r.config["vocab_size"])
    loop = ramp(r, engine, fns, spans, mix)
    dev.sync()
    spans.items.clear()
    setup_s = clock() - r.t_start
    rec = window(r, loop, mix, prof)
    dev.sync()
    rec.update(setup_s=setup_s, peak=dev.peak_bytes())
    rec["trace"] = prof.reduce() if prof is not None and \
        prof.state == "done" else None
    rec["profiled"] = (prof.t0, prof.t1) if rec["trace"] else None
    del engine, fns, loop
    if dev.cuda:
        torch.cuda.empty_cache()
    rec["checks"] = check(r, weights, rec["in_flight"] + rec["served"])
    return rec


def sample(r, served: list[Served]) -> list[Served]:
    """Finished requests drawn from the seed for the check: the one with
    the most served tokens, then others in a seeded order until
    ``check.tokens`` served tokens."""
    done = [s for s in served if s.req.done]
    if not done:
        return []
    longest = max(done, key=lambda s: (len(s.req.generated), -s.req.seq_id))
    rest = [s for s in done if s is not longest]
    order = np.random.default_rng([r.seed, 3]).permutation(len(rest))
    picked, n = [longest], len(longest.req.generated)
    for i in order:
        if n >= r.traffic["check"]["tokens"]:
            break
        picked.append(rest[i])
        n += len(rest[i].req.generated)
    return picked


def teacher_forced(picked, device):
    """[(ids, first)] for the reference: each prompt with its served
    tokens but the last; logits from position len(prompt) - 1 on score
    them."""
    return [(torch.tensor(s.prompt + s.req.generated[:-1],
                          device=device), len(s.prompt) - 1)
            for s in picked]


def widest_gap(ref_logits, tokens) -> float:
    """The widest gap by which a chosen token's reference logit lies below
    the reference's best, over every position."""
    worst = 0.0
    for lg, tok in zip(ref_logits, tokens):
        tok = torch.as_tensor(tok, device=lg.device)
        gap = lg.max(-1).values - lg.gather(-1, tok[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def check(r, weights, served) -> dict:
    """Compared numbers and their limits: every request that ran in the
    window (in flight as it opened or submitted in it) served in full, and
    the served tokens' widest logit gap under the plain float32
    reference."""
    picked = sample(r, served)
    short = sum(1 for s in served
                if s.req.done and len(s.req.generated) != s.want)
    missing = sum(1 for s in served if not s.req.done)
    if picked:
        r.reference.no_tf32()
        ref = r.reference.served_logits(
            weights, r.config, teacher_forced(picked, r.device.torch_device))
        gap = widest_gap(ref, [s.req.generated for s in picked])
    else:  # nothing finished: fails the limit, and the run fails anyway
        gap = 1e9
    n_tok = sum(len(s.req.generated) for s in picked)
    log(f"check: {len(picked)} requests, {n_tok} served tokens compared "
        f"with the float32 reference")
    return {
        "logit_gap": {"value": gap,
                      "limit": r.traffic["check"]["logit_gap_limit"]},
        "unserved": {"value": missing, "limit": 0},
        "wrong_length": {"value": short, "limit": 0},
    }
