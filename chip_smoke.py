"""End-to-end smoke run of flash_attn_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from flash_attn_tpu_torch/csrc with nvcc (sm_90a,
one process per source), checks each kernel against its plain-torch twin
and the repo's 2x rule at the shapes of the two main paths, then drives
both paths at GPT-2's full width with random weights from torch.Generator
seed 0:
  - serving: 12 requests through ServingEngine (bf16 weights), prefill +
    decode held to teacher forcing against the full-sequence model;
  - training: 6 AdamW steps of GPT2Config(dropout=0.1) (fp32 weights,
    bf16 compute) on one b=8, s=1024 batch, with falling finite loss, K1
    and K2 launched 12 times per step and no SDPA op in a traced step; one
    step at dropout 0 held to the 2x rule against fp32 compute.
It times both paths and every kernel against its twin and, where one
exists, a single PyTorch call computing the same function. Any failed
check raises and the exit code is nonzero. Without CUDA it exits nonzero
and prints no result. Output, in order: the card and toolchain, per-phase
lines, the kernels' JSON line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.decode import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from flash_attn_tpu_torch.kernels.flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from flash_attn_tpu_torch.kernels.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from flash_attn_tpu_torch.kernels.prng import dropout_mask_dense
from flash_attn_tpu_torch.models import gpt2_decode, modules
from flash_attn_tpu_torch.models.gpt2 import (
    GPT2Config,
    GPT2LMHeadModel,
    cross_entropy_loss,
    make_train_step,
)
from flash_attn_tpu_torch.reference import attention_ref
from flash_attn_tpu_torch.serving import cache
from flash_attn_tpu_torch.serving.engine import ServingEngine
from flash_attn_tpu_torch.utils.testing import assert_two_x_bound, max_err

DEV = torch.device("cuda")
BF16 = torch.bfloat16
KERNELS = {
    # name: (wrapper, source, TPU kernel it replaces)
    "flash_fwd": (flash_attention_fwd, "flash_attn_tpu_torch/csrc/flash_fwd.cu",
                  "flash_attn_tpu/kernels/flash_fwd.py:104"),
    "flash_bwd": (flash_attention_bwd, "flash_attn_tpu_torch/csrc/flash_bwd.cu",
                  "flash_attn_tpu/kernels/flash_bwd.py:106"),
    "paged_decode": (paged_decode_attention,
                     "flash_attn_tpu_torch/csrc/paged_decode.cu",
                     "flash_attn_tpu/kernels/decode.py:50"),
    "append_token": (cache.append_token,
                     "flash_attn_tpu_torch/csrc/cache_write.cu",
                     "flash_attn_tpu/serving/cache.py:94"),
    "write_pages": (cache.write_prompt,
                    "flash_attn_tpu_torch/csrc/cache_write.cu",
                    "flash_attn_tpu/serving/cache.py:460"),
}
SERVE_KERNELS = ("flash_fwd", "paged_decode", "append_token", "write_pages")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd")
# H100 SXM at 700 W (NVIDIA's data sheet): dense bf16 tensor-core rate and
# HBM bandwidth, for each kernel's bound.
PEAK_FLOPS = 989e12
PEAK_BYTES = 3.35e12
SEED = 1234  # the attention dropout seed of the kernel checks


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"check failed: {msg}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    back-to-back calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def randn(gen, shape, dtype=BF16):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, flops: float) -> tuple[float, str]:
    """The least time the card could take, in ms, and what sets it: each
    input read once and each output written once at the HBM rate, or the
    tensor-core products at the bf16 peak."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES * 1e3, flops / PEAK_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def reset_launches():
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0


def read_launches(names):
    return {name: KERNELS[name][0].launches for name in names}


# ---------------------------------------------------------------- phase 0-1

def phase_device():
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 references stay fp32
    torch.backends.cudnn.allow_tf32 = False
    nvcc = _build._find_nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], check=True, capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[-1]
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}; nvcc: {nvcc_version}")
    t0 = time.perf_counter()
    _build.lib()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path().name})")


# ---------------------------------------------------------------- phase 2

def phase_kernels(gen):
    """Each kernel against its twin at main-path shapes, bf16. Returns
    {name: max_abs_err vs twin}."""
    errs = {}
    # K1: causal prefill at GPT-2 widths, ragged, GQA, head_dim 128.
    for b, h, h_kv, s, d in [(4, 12, 12, 512, 64), (4, 12, 12, 300, 64),
                             (4, 12, 4, 512, 64), (4, 6, 6, 512, 128)]:
        q = randn(gen, (b, h, s, d))
        k, v = randn(gen, (b, h_kv, s, d)), randn(gen, (b, h_kv, s, d))
        out, _ = flash_attention_fwd(q, k, v, causal=True,
                                     softmax_scale=d ** -0.5, save_lse=False)
        torch.cuda.synchronize()
        twin, _ = flash_attention_fwd_plain(q, k, v, causal=True,
                                            softmax_scale=d ** -0.5,
                                            save_lse=False)
        ref32 = attention_ref(q, k, v, causal=True)
        ref16 = attention_ref(q, k, v, causal=True, upcast=False)
        err, base = assert_two_x_bound(out, ref32, ref16,
                                       label=f"flash_fwd b{b} h{h}/{h_kv} "
                                       f"s{s} d{d}")
        errs["flash_fwd"] = max(errs.get("flash_fwd", 0.0), max_err(out, twin))
        print(f"flash_fwd b={b} h={h} h_kv={h_kv} s={s} d={d}: err vs fp32 "
              f"{err:.3e} (bf16 baseline {base:.3e}), vs twin "
              f"{max_err(out, twin):.3e}")

    # K5: batch 8, lengths across 1..1000, one inactive slot (length 0).
    q, kp, vp, lens, table = decode_inputs(gen)
    out = paged_decode_attention(q, kp, vp, lens, table)
    torch.cuda.synchronize()
    twin = paged_decode_attention_plain(q, kp, vp, lens, table,
                                        softmax_scale=64 ** -0.5)
    ref32, ref16 = dense_decode_refs(q, kp, vp, lens, table)
    err, base = assert_two_x_bound(out, ref32, ref16, label="paged_decode")
    errs["paged_decode"] = max_err(out, twin)
    print(f"paged_decode lengths={lens.tolist()}: err vs fp32 {err:.3e} "
          f"(bf16 baseline {base:.3e}), vs twin {errs['paged_decode']:.3e}")

    # K7c / K7a: bitwise equal to the twins outside the scratch page 0.
    h, d, ps, num_pages = 12, 64, 128, 65
    pages = (randn(gen, (h, num_pages, ps, d)), randn(gen, (h, num_pages, ps, d)))
    on_card = cache.PagedKVCache(pages[0].clone(), pages[1].clone())
    plain = cache.PagedKVCache(pages[0].clone(), pages[1].clone())
    # A 700-token prompt: 6 pages (tail zero-filled) plus a scratch entry.
    k, v = randn(gen, (700, h, d)), randn(gen, (700, h, d))
    ids = torch.tensor([7, 3, 9, 11, 5, 13, 0], dtype=torch.int32, device=DEV)
    cache.write_prompt(on_card, k, v, ids)
    cache.write_prompt_plain(plain, k, v, ids)
    # Batch 8: page edges, an inactive slot (-1), the last slot of a table.
    lens8 = torch.tensor([5, 127, 128, 300, -1, 640, 1023, 0],
                         dtype=torch.int32, device=DEV)
    tbl8 = torch.arange(1, 65, dtype=torch.int32, device=DEV).reshape(8, 8)
    nk, nv = randn(gen, (8, h, d)), randn(gen, (8, h, d))
    cache.append_token(on_card, nk, nv, tbl8, lens8)
    cache.append_token_plain(plain, nk, nv, tbl8, lens8)
    torch.cuda.synchronize()
    for name, a, b in (("k", on_card.k_pages, plain.k_pages),
                       ("v", on_card.v_pages, plain.v_pages)):
        check(torch.equal(a[:, 1:], b[:, 1:]),
              f"cache writes differ from the twins in {name} pages")
    errs["write_pages"] = errs["append_token"] = 0.0
    print("write_pages + append_token: bitwise equal to the twins outside "
          "page 0")
    return errs


# (b, h, h_kv, s, d, dropout_p): the train step's attention, then ragged,
# GQA 12/4 and head_dim 128.
TRAIN_KERNEL_CASES = [
    (8, 12, 12, 1024, 64, 0.0), (8, 12, 12, 1024, 64, 0.1),
    (8, 12, 12, 1000, 64, 0.1), (8, 12, 4, 1024, 64, 0.1),
    (8, 6, 6, 1024, 128, 0.1),
]


def ref_grads(q, k, v, dout, keep, p, upcast):
    """dq, dk, dv of attention_ref by autograd (causal, dropout mask
    ``keep``)."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = attention_ref(*leaves, causal=True, upcast=upcast,
                        dropout_mask=keep, dropout_p=p)
    out.backward(dout.to(out.dtype))
    return [x.grad for x in leaves]


def phase_train_kernels(gen, errs):
    """K1 with dropout and K2 against their twins and the 2x rule (oracle:
    fp32 attention_ref, by autograd for the gradients; baseline: the
    same-dtype attention_ref, atol 1e-4 for the gradients' fp32 sums),
    causal bf16. Adds the max errors vs the twins to ``errs``."""
    errs["flash_bwd"] = 0.0
    for b, h, h_kv, s, d, p in TRAIN_KERNEL_CASES:
        q, dout = randn(gen, (b, h, s, d)), randn(gen, (b, h, s, d))
        k, v = randn(gen, (b, h_kv, s, d)), randn(gen, (b, h_kv, s, d))
        kw = dict(causal=True, softmax_scale=d ** -0.5, dropout_p=p,
                  seed=SEED if p else None)
        out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
        grads = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        torch.cuda.synchronize()
        twin, _ = flash_attention_fwd_plain(q, k, v, save_lse=False, **kw)
        twin_grads = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
        keep = dropout_mask_dense(SEED, b, h, s, s, p, device=DEV) if p \
            else None
        label = f"b={b} h={h} h_kv={h_kv} s={s} d={d} p={p}"
        err, base = assert_two_x_bound(
            out, attention_ref(q, k, v, causal=True, dropout_mask=keep,
                               dropout_p=p),
            attention_ref(q, k, v, causal=True, upcast=False,
                          dropout_mask=keep, dropout_p=p),
            label=f"flash_fwd {label}")
        fwd_twin = max_err(out, twin)
        errs["flash_fwd"] = max(errs["flash_fwd"], fwd_twin)
        oracle = ref_grads(q.float(), k.float(), v.float(), dout.float(),
                           keep, p, True)
        native = ref_grads(q, k, v, dout, keep, p, False)
        parts, bwd_twin = [], 0.0
        for name, g, tw, o, n in zip("qkv", grads, twin_grads, oracle,
                                     native):
            e, be = assert_two_x_bound(g, o, n, atol=1e-4,
                                       label=f"flash_bwd d{name} {label}")
            bwd_twin = max(bwd_twin, max_err(g, tw))
            parts.append(f"d{name} {e:.3e} ({be:.3e})")
        errs["flash_bwd"] = max(errs["flash_bwd"], bwd_twin)
        print(f"flash_fwd+bwd {label}: out err vs fp32 {err:.3e} (bf16 "
              f"baseline {base:.3e}); grads vs fp32 autograd (bf16 "
              f"baseline) {', '.join(parts)}; vs twins fwd {fwd_twin:.3e} "
              f"bwd {bwd_twin:.3e}")
        del q, k, v, dout, out, lse, grads, twin, twin_grads, oracle, native
        torch.cuda.empty_cache()


def decode_inputs(gen, b=8, h=12, d=64, ps=128, pages_per_seq=8):
    lengths = [1, 127, 128, 129, 400, 777, 1000, 0]  # 0: an inactive slot
    num_pages = 1 + sum(-(-n // ps) for n in lengths)
    kp = randn(gen, (h, num_pages, ps, d))
    vp = randn(gen, (h, num_pages, ps, d))
    perm = torch.randperm(num_pages - 1, generator=gen, device=DEV) + 1
    table = torch.zeros((b, pages_per_seq), dtype=torch.int32, device=DEV)
    used = 0
    for i, n in enumerate(lengths):
        need = -(-n // ps)
        table[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    lens = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    return randn(gen, (b, h, d)), kp, vp, lens, table


def dense_decode_refs(q, kp, vp, lens, table):
    """fp32 and same-dtype dense attention over each sequence's keys."""
    ps = kp.shape[2]
    outs = ([], [])
    for i, n in enumerate(lens.tolist()):
        if n <= 0:
            for o in outs:
                o.append(torch.zeros_like(q[i]))
            continue
        idx = table[i, : -(-n // ps)].long()
        k = kp[:, idx].flatten(1, 2)[:, :n]
        v = vp[:, idx].flatten(1, 2)[:, :n]
        for o, up in zip(outs, (True, False)):
            o.append(attention_ref(q[i][:, None], k, v, upcast=up)[:, 0])
    return torch.stack(outs[0]), torch.stack(outs[1])


# ---------------------------------------------------------------- phase 3

def phase_serve(model, cfg, rng):
    """12 requests through the engine; returns the launch counts of the run."""
    engine = ServingEngine(model, cfg, max_batch=8, page_size=128,
                           num_pages=128, pages_per_seq=8)
    lens = np.linspace(9, 700, 12).astype(int)
    for n in lens:
        engine.submit(rng.integers(0, cfg.vocab_size, n).tolist(),
                      max_new_tokens=32)
    reset_launches()
    t0 = time.perf_counter()
    finished = engine.run(max_steps=1000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(KERNELS)
    check(len(finished) == 12, f"{len(finished)} of 12 requests finished")
    for r in finished:
        check(len(r.generated) == 32, f"request {r.seq_id}: "
              f"{len(r.generated)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"request {r.seq_id}: token out of range")
    for name in SERVE_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} was not launched on the serving path")
    check(launches["flash_bwd"] == 0, "serving launched the backward")
    print(f"serve: 12 requests (prompts {lens.min()}..{lens.max()}) x 32 "
          f"tokens in {dt:.2f} s; launches {launches}")
    return launches


def phase_teacher_forcing(model, cfg, rng, prompt_len=300, n_decode=16):
    """prefill + n_decode decode steps against the full-sequence model.

    Tolerance: the repo's 2x rule applied to the whole serving path. The
    oracle is the same model with its (bf16) weights upcast to fp32; the
    baseline is the full-sequence bf16 forward. The serving path's logits
    may be at most twice as far from the oracle as the baseline's, plus
    1e-3 (fp32 noise of the oracle's own kernels)."""
    ids = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, prompt_len + n_decode))).to(DEV)
    with torch.no_grad():
        full16 = model(ids)[0, prompt_len - 1:]
        cfg32 = GPT2Config(dtype=torch.float32)
        model32 = GPT2LMHeadModel(
            cfg32, device=DEV,
            generator=torch.Generator(device=DEV).manual_seed(0))
        model32.load_state_dict(model.state_dict())
        full32 = model32(ids)[0, prompt_len - 1:]
        del model32
    ps = 128
    n_pages = -(-(prompt_len + n_decode) // ps)
    caches = [cache.init_cache(cfg.n_head, 1 + n_pages, ps, cfg.head_dim,
                               dtype=cfg.dtype, device=DEV)
              for _ in range(cfg.n_layer)]
    table = torch.arange(1, 1 + n_pages, dtype=torch.int32,
                         device=DEV)[None]
    logits, ks, vs = gpt2_decode.prefill(model, cfg, ids[:, :prompt_len])
    steps = [logits[0]]
    for c, k, v in zip(caches, ks, vs):
        cache.write_prompt(c, k[0], v[0], table[0, : -(-prompt_len // ps)])
    for t in range(n_decode):
        lens = torch.tensor([prompt_len + t], dtype=torch.int32, device=DEV)
        logits, caches = gpt2_decode.decode_step(
            model, cfg, caches, table, lens, ids[:, prompt_len + t])
        steps.append(logits[0])
    served = torch.stack(steps)
    check(bool(torch.isfinite(served).all()), "non-finite served logits")
    err, base = assert_two_x_bound(served, full32, full16, atol=1e-3,
                                   label="teacher forcing")
    agree = float((served.argmax(-1) == full32.argmax(-1)).float().mean())
    print(f"teacher forcing: prefill + {n_decode} decode steps, max |logit "
          f"err| vs fp32 model {err:.3e} (bf16 full forward {base:.3e}); "
          f"argmax agreement with fp32 {agree:.3f}")


# ---------------------------------------------------------------- phase 4

def phase_timing(model, cfg, rng, gen):
    lens = np.linspace(9, 700, 8).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]

    def admitted_engine():
        eng = ServingEngine(model, cfg, max_batch=8, page_size=128,
                            num_pages=128, pages_per_seq=8)
        for p in prompts:
            eng.submit(p, max_new_tokens=1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._admit()  # one batched prefill of all 8: time to first token
        torch.cuda.synchronize()
        return eng, (time.perf_counter() - t0) * 1e3

    admitted_engine()  # warm-up: cuBLAS handles, allocator
    ttft = sorted(admitted_engine()[1] for _ in range(3))
    eng, _ = admitted_engine()
    for _ in range(3):
        eng.step()
    n_steps = 32
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    tok_s = 8 * n_steps / decode_s
    card = card_line()
    print(f"prefill TTFT, one batch of 8 admissions (prompts {lens.min()}.."
          f"{lens.max()}, bucket 768): median {ttft[1]:.2f} ms "
          f"(min {ttft[0]:.2f}, max {ttft[2]:.2f}) [{card}]")
    print(f"decode at batch 8 (contexts {lens.min()}..{lens.max() + 35}): "
          f"{tok_s:.1f} tokens/s, {decode_s / n_steps * 1e3:.2f} ms/step "
          f"[{card}]")


def kernel_timing(gen):
    """Each kernel against its twin and, where one exists, a single PyTorch
    call computing the same function, at the main paths' shapes, in turns
    (plain, kernel, kernel, plain; the library call last). Returns {name:
    (ms, plain_ms, library_ms, bound_ms, bound_by)}."""
    card = card_line()
    # K1 at the serving bucket (b=8, s=768, no lse) and at the train step
    # (s=1024, dropout 0.1, lse saved); K2 at the train step.
    q = randn(gen, (8, 12, 768, 64))
    k, v = randn(gen, (8, 12, 768, 64)), randn(gen, (8, 12, 768, 64))
    fwd = dict(causal=True, softmax_scale=0.125, save_lse=False)
    qt, kt, vt, dt = (randn(gen, (8, 12, 1024, 64)) for _ in range(4))
    train = dict(causal=True, softmax_scale=0.125, dropout_p=0.1, seed=SEED)
    ot, lt = flash_attention_fwd(qt, kt, vt, save_lse=True, **train)
    qg, kg, vg = (x.detach().requires_grad_() for x in (qt, kt, vt))
    og = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                        dropout_p=0.1)
    qd, kp, vp, dl, tbl = decode_inputs(gen)
    pages = cache.init_cache(12, 65, 128, 64, dtype=BF16, device=DEV)
    kw, vw = randn(gen, (768, 12, 64)), randn(gen, (768, 12, 64))
    ids = torch.tensor([7, 3, 9, 11, 5, 13], dtype=torch.int32, device=DEV)
    nk, nv = randn(gen, (8, 12, 64)), randn(gen, (8, 12, 64))
    tbl8 = torch.arange(1, 65, dtype=torch.int32, device=DEV).reshape(8, 8)
    l8 = torch.tensor([5, 127, 128, 300, -1, 640, 999, 0], dtype=torch.int32,
                      device=DEV)
    live = int(dl.clamp(min=0).sum())  # keys the decode kernel must read

    specs = {
        # name: (kernel, plain twin, library call or None, bytes, flops)
        "flash_fwd": (
            lambda: flash_attention_fwd(q, k, v, **fwd),
            lambda: flash_attention_fwd_plain(q, k, v, **fwd),
            lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True),
            nbytes(q, k, v, q), 4 * 8 * 12 * causal_pairs(768) * 64),
        "flash_fwd (train step, dropout 0.1, lse)": (
            lambda: flash_attention_fwd(qt, kt, vt, save_lse=True, **train),
            lambda: flash_attention_fwd_plain(qt, kt, vt, save_lse=True,
                                              **train),
            lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, dropout_p=0.1),
            nbytes(qt, kt, vt, qt, lt),
            4 * 8 * 12 * causal_pairs(1024) * 64),
        "flash_bwd": (
            lambda: flash_attention_bwd(qt, kt, vt, ot, dt, lt, **train),
            lambda: flash_attention_bwd_plain(qt, kt, vt, ot, dt, lt, **train),
            lambda: torch.autograd.grad(og, (qg, kg, vg), dt,
                                        retain_graph=True),
            nbytes(qt, kt, vt, ot, dt, lt) + nbytes(qt, kt, vt),
            10 * 8 * 12 * causal_pairs(1024) * 64),
        "paged_decode": (
            lambda: paged_decode_attention(qd, kp, vp, dl, tbl),
            lambda: paged_decode_attention_plain(qd, kp, vp, dl, tbl,
                                                 softmax_scale=0.125),
            None,
            2 * live * 12 * 64 * kp.element_size() + 2 * nbytes(qd)
            + nbytes(dl, tbl),
            4 * live * 12 * 64),
        "append_token": (
            lambda: cache.append_token(pages, nk, nv, tbl8, l8),
            lambda: cache.append_token_plain(pages, nk, nv, tbl8, l8),
            None, 2 * nbytes(nk, nv) + nbytes(tbl8, l8), 0),
        "write_pages": (
            lambda: cache.write_prompt(pages, kw, vw, ids),
            lambda: cache.write_prompt_plain(pages, kw, vw, ids),
            None, 2 * nbytes(kw, vw) + nbytes(ids), 0),
    }
    times = {}
    for name, (kern, plain, library, n_bytes, flops) in specs.items():
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        lib_ms = cuda_ms(library) if library is not None else None
        b_ms, b_by = bound(n_bytes, flops)
        times[name] = (min(k1, k2), min(p1, p2), lib_ms, b_ms, b_by)
        lib = f"{lib_ms:.4f} ms" if lib_ms is not None else "none"
        print(f"{name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms, library {lib}, bound {b_ms:.4f} ms "
              f"({b_by}: {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
              f"[{card}]")
    print("shapes: flash_fwd b=8 h=12 s=768 d=64 causal (the serving "
          "bucket), library = SDPA forward; flash_fwd (train step) and "
          "flash_bwd b=8 h=12 s=1024 d=64 causal dropout 0.1, library = "
          "SDPA forward / backward with dropout 0.1; paged_decode b=8 h=12 "
          "d=64 page 128, lengths 0..1000; append_token b=8 h=12; "
          "write_pages 768 tokens into 6 pages; all bf16")
    return times


# ---------------------------------------------------------------- phase 5

def train_model(cfg):
    return GPT2LMHeadModel(
        cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0))


def phase_train(n_steps=6):
    """The training main path: GPT2Config(dropout=0.1) at full width, fp32
    weights and AdamW state, bf16 compute, n_steps on one b=8, s=1024 batch
    (the JAX package's benchmark run_config(8, 1024)). Returns (launches,
    step, batch, generator, model, optimizer)."""
    cfg = GPT2Config(dropout=0.1)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 1024))).to(DEV)
    batch = {"input_ids": ids, "labels": ids}
    model = train_model(cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    step = make_train_step(model, opt)
    gen = torch.Generator().manual_seed(0)  # dropout seeds
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = [step(batch, gen) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(KERNELS)
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    for name in TRAIN_KERNELS:
        check(launches[name] == cfg.n_layer * n_steps,
              f"{name}: {launches[name]} launches in {n_steps} steps, want "
              f"{cfg.n_layer} per step")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "non-fp32 parameters")
    check(all(v.dtype == torch.float32 for st in opt.state.values()
              for v in st.values() if v.dim() > 0),
          "non-fp32 AdamW state")
    print(f"train: GPT-2 full width, b=8 s=1024, dropout 0.1, {n_steps} "
          f"AdamW steps in {dt:.2f} s; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}")
    return launches, step, batch, gen, model, opt


KERNEL_CLASSES = [  # (class, substrings of the kernel name), first match
    ("flash_bwd (K2)", ("flash_bwd", "bwd_di", "bwd_dq")),
    ("flash_fwd (K1)", ("flash_fwd",)),
    ("GEMM", ("gemm", "cutlass", "nvjet", "xmma", "sm90_")),
    ("optimizer", ("multi_tensor", "adam")),
    ("loss", ("cross_entropy", "softmax", "nll")),
    ("layer_norm", ("layer_norm",)),
    ("dropout RNG", ("philox", "distribution", "uniform")),
    ("copies", ("memcpy", "memset", "copy")),
]


def trace_step(step, batch, gen, record_shapes):
    """One profiled train step: (host wall ms, the operator names, the
    chrome-trace events)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=record_shapes) as prof:
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    names = {e.key for e in prof.key_averages()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return wall, names, events


def device_events(events):
    dev = [e for e in events
           if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    check(dev, "the trace holds no device events")
    return dev


def phase_trace(step, batch, gen):
    """Two traced train steps. The first: no SDPA op may appear, and the
    device time is broken down by kernel class (the union of the trace's
    kernel, memcpy and memset intervals is the busy time). The second
    records input shapes (which slows the host, so it is not used for the
    idle share) to name the op behind each of the largest kernels."""
    step(batch, gen)
    torch.cuda.synchronize()
    wall, names, events = trace_step(step, batch, gen, record_shapes=False)
    sdpa = sorted(n for n in names if n.startswith(
        ("aten::_scaled_dot_product", "aten::_efficient_attention")))
    check(not sdpa, f"SDPA ops in the train step: {sdpa}")
    dev = device_events(events)
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, end = 0.0, -math.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    span = spans[-1][1] - spans[0][0]
    by_class = {}
    for e in dev:
        name = (e.get("cat", "") + " " + e.get("name", "")).lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in name for k in keys)), "elementwise/other")
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"]
    total = sum(by_class.values())
    shares = ", ".join(f"{c} {t / total * 100:.1f}%" for c, t in sorted(
        by_class.items(), key=lambda kv: -kv[1]))
    print(f"train step trace: wall {wall:.2f} ms (traced), GPU span "
          f"{span / 1e3:.2f} ms, device busy {busy / 1e3:.2f} ms, idle "
          f"{(1 - busy / span) * 100:.1f}% of the span; {len(dev)} device "
          f"events; device time by class: {shares}; no SDPA op "
          f"[{card_line()}]")

    _, _, events = trace_step(step, batch, gen, record_shapes=True)
    ops = {e["args"]["External id"]: (e["name"], e["args"].get("Input Dims"))
           for e in events if e.get("cat") == "cpu_op"
           and "External id" in e.get("args", {})}
    by_kernel = {}
    for e in device_events(events):
        op = ops.get(e.get("args", {}).get("External id"), ("?", None))
        key = (e["name"][:60], op[0], str(op[1]))
        by_kernel[key] = by_kernel.get(key, 0.0) + e["dur"]
    top = "; ".join(f"{n} from {op} {dims}: {t / 1e3:.3f} ms"
                    for (n, op, dims), t in sorted(
                        by_kernel.items(), key=lambda kv: -kv[1])[:8])
    print(f"train step trace, largest device time by kernel and the op "
          f"that launched it: {top}")


def phase_train_timing(step, batch, gen, warmup=2, n=5):
    for _ in range(warmup):
        step(batch, gen)
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(batch, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    print(f"train step b=8 s=1024 dropout 0.1: median {med:.2f} ms (min "
          f"{min(times):.2f}, max {max(times):.2f}, {n} steps after "
          f"{warmup} warm-ups), {8 * 1024 / med * 1e3:.0f} tokens/s "
          f"[{card_line()}]")


def reference_attention(q, k, v, *, causal, softmax_scale=None,
                        dropout_p=0.0, dropout_seed=None):
    """flash_attention's signature over the same-dtype attention_ref
    (bshd), differentiable by autograd: the train check's baseline."""
    def tr(x):
        return x.transpose(1, 2)

    return tr(attention_ref(tr(q), tr(k), tr(v), causal=causal,
                            softmax_scale=softmax_scale, upcast=False))


def loss_and_grad_norm(model, batch):
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(model(batch["input_ids"]), batch["labels"])
    loss.backward()
    norm = torch.sqrt(sum(p.grad.float().pow(2).sum()
                          for p in model.parameters()))
    return torch.stack([loss.detach(), norm])


def phase_train_check(batch):
    """One step at dropout 0, its loss and global gradient norm: the bf16
    model through K1/K2 against the same step in fp32 compute, by the 2x
    rule. Baseline: the bf16 model with attention through the same-dtype
    attention_ref in autograd. Tolerance floor 1e-4 of the fp32 value."""
    model16 = train_model(GPT2Config())
    got = loss_and_grad_norm(model16, batch)
    original = modules.flash_attention
    modules.flash_attention = reference_attention
    try:
        base = loss_and_grad_norm(model16, batch)
    finally:
        modules.flash_attention = original
    del model16
    torch.cuda.empty_cache()
    want = loss_and_grad_norm(train_model(GPT2Config(dtype=torch.float32)),
                              batch)
    for i, what in enumerate(("loss", "grad norm")):
        err, b = assert_two_x_bound(got[i], want[i], base[i],
                                    atol=1e-4 * float(want[i].abs()),
                                    label=f"train step {what}")
        print(f"train step at dropout 0, {what}: bf16 + kernels "
              f"{float(got[i]):.6f}, fp32 compute {float(want[i]):.6f}, bf16 "
              f"+ attention_ref {float(base[i]):.6f}: err {err:.3e} (bf16 "
              f"baseline {b:.3e})")


def main():
    phase_device()
    gen = torch.Generator(device=DEV).manual_seed(0)
    rng = np.random.default_rng(0)
    errs = phase_kernels(gen)
    phase_train_kernels(gen, errs)

    # Serving: full width, weights stored in bf16 (the serving dtype).
    cfg = GPT2Config(param_dtype=BF16)
    model = GPT2LMHeadModel(cfg, device=DEV,
                            generator=torch.Generator(device=DEV).manual_seed(0))
    serve_launches = phase_serve(model, cfg, rng)
    phase_teacher_forcing(model, cfg, rng)
    phase_timing(model, cfg, rng, gen)
    del model
    torch.cuda.empty_cache()

    train_launches, step, batch, dgen, *held = phase_train()
    phase_trace(step, batch, dgen)
    phase_train_timing(step, batch, dgen)
    del step, held
    torch.cuda.empty_cache()
    phase_train_check(batch)
    times = kernel_timing(gen)

    kernels = []
    for name, (_, src, tpu) in KERNELS.items():
        ms, plain_ms, lib_ms, b_ms, b_by = times[name]
        by_path = {"serve": serve_launches[name], "train": train_launches[name]}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
