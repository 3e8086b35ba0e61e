"""End-to-end smoke run of flash_attn_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from flash_attn_tpu_torch/csrc with nvcc (sm_90a,
one process per source), checks each kernel against its plain-torch twin
and the repo's 2x rule at the shapes of the main paths, then drives the
paths with random weights from torch.Generator seed 0:
  - serving, GPT-2 at full width (bf16 weights): 12 requests through
    ServingEngine, prefill + decode held to teacher forcing against the
    full-sequence model;
  - chunked serving, GPT-2: 12 requests (prompts 9..1000) with
    prefill_chunk=256, and a 700-token prompt in three chunks + 16 decode
    steps held to teacher forcing;
  - speculative verification, GPT-2: a 6-layer draft proposes 4 tokens,
    the 12-layer model scores them through flash_attn_with_kvcache; every
    round's logits held to the 2x rule;
  - chunked serving, Llama-3-8B's published widths (32 layers, GQA 32/8,
    head_dim 128, bf16): 8 requests (prompts 300..4000) with
    prefill_chunk=512, and a 1500-token prompt in three chunks + 16 decode
    steps held to the 2x rule against the same weights in fp32;
  - training: 6 AdamW steps of GPT2Config(dropout=0.1) (fp32 weights,
    bf16 compute) on one b=8, s=1024 batch, with falling finite loss, K1
    and K2 launched 12 times per step and no SDPA op in a traced step; one
    step at dropout 0 held to the 2x rule against fp32 compute.
A determinism phase requires 10 seeded reruns to agree bit for bit: K1 + K2
at the train shape with dropout 0.1, K8a-c at BS_SHAPES (i), K5 and K6 at
Llama-3-8B's decode and chunk shapes; each paged shape prints the split
count the host chose for it.
It prints ptxas's registers and spills, the dynamic shared memory and the
HGMMA (wgmma) instructions of the Hopper kernels K1, K2, K5 and K6, and
times both
paths and every kernel against its twin and, where one exists, a single
PyTorch call computing the same function (SDPA under each of its flash,
cuDNN and efficient backends pinned in turn, the fastest reported), all by
device busy time in a profiler trace (dense_timing.busy_ms), since this
host issues a call more slowly than the card runs the shortest ones; the
host's time to issue a kernel call is printed beside. Any failed check raises and
the exit code is nonzero. Without CUDA it exits nonzero
and prints no result. Output, in order: the card and toolchain, per-phase
lines, the kernels' JSON line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dense_timing import busy_ms, device_events, host_ms, trace_call, union_us
from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.blocksparse import (
    blocksparse_attention_bwd,
    blocksparse_attention_bwd_plain,
    blocksparse_attention_dkv,
    blocksparse_attention_dq,
    blocksparse_attention_fwd,
    blocksparse_attention_fwd_plain,
    build_layout,
    visible_plain,
)
from flash_attn_tpu_torch.kernels.chunk import (
    BLOCK_ROWS,
    paged_chunk_attention,
    paged_chunk_attention_plain,
)
from flash_attn_tpu_torch.kernels.common import paged_num_splits, sm_count
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
from flash_attn_tpu_torch.models import gpt2_decode, llama_decode, modules
from flash_attn_tpu_torch.models.blocksparse_modules import (
    LocalGlobalSparsityConfig,
)
from flash_attn_tpu_torch.models.gpt2 import (
    GPT2Config,
    GPT2LMHeadModel,
    cross_entropy_loss,
    make_train_step,
)
from flash_attn_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from flash_attn_tpu_torch.ops.blocksparse import blocksparse_attention
from flash_attn_tpu_torch.reference import attention_ref, paged_chunk_ref
from flash_attn_tpu_torch.serving import cache
from flash_attn_tpu_torch.serving.engine import ServingEngine
from flash_attn_tpu_torch.serving.speculative import speculative_decode
from flash_attn_tpu_torch.utils.testing import (
    assert_two_x_bound,
    max_err,
    packed_views,
)

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
    "paged_chunk": (paged_chunk_attention,
                    "flash_attn_tpu_torch/csrc/paged_chunk.cu",
                    "flash_attn_tpu/kernels/chunk.py:61"),
    "append_span": (cache.append_span,
                    "flash_attn_tpu_torch/csrc/cache_write.cu",
                    "flash_attn_tpu/serving/cache.py:250"),
    "blocksparse_fwd": (blocksparse_attention_fwd,
                        "flash_attn_tpu_torch/csrc/blocksparse_fwd.cu",
                        "flash_attn_tpu/kernels/blocksparse.py:537"),
    "blocksparse_dkv": (blocksparse_attention_dkv,
                        "flash_attn_tpu_torch/csrc/blocksparse_bwd.cu",
                        "flash_attn_tpu/kernels/blocksparse.py:855"),
    "blocksparse_dq": (blocksparse_attention_dq,
                       "flash_attn_tpu_torch/csrc/blocksparse_bwd.cu",
                       "flash_attn_tpu/kernels/blocksparse.py:988"),
}
SERVE_KERNELS = ("flash_fwd", "paged_decode", "append_token", "write_pages")
CHUNKED_KERNELS = ("paged_chunk", "write_pages", "paged_decode",
                   "append_token")
SPEC_KERNELS = ("flash_fwd", "write_pages", "paged_chunk", "append_span")
TRAIN_KERNELS = ("flash_fwd", "flash_bwd")
BS_KERNELS = ("blocksparse_fwd", "blocksparse_dkv", "blocksparse_dq")
# Llama-3-8B (meta-llama/Meta-Llama-3-8B config.json), bf16.
LLAMA3_8B = LlamaConfig(
    vocab_size=128256, n_layer=32, n_embd=4096, n_head=32, n_kv_head=8,
    intermediate_size=14336, rope_theta=500000.0,
    max_position_embeddings=8192, rms_norm_eps=1e-5,
    dtype=torch.bfloat16, param_dtype=torch.bfloat16)
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


def randn(gen, shape, dtype=BF16):
    return torch.randn(shape, generator=gen, device=DEV).to(dtype)


def packed_inputs(gen, b, h, h_kv, s, d):
    """q, k, v and dout as flash_attention hands them to K1 and K2 on the
    main path: (b, h, s, d) views of one fused projection (b, s, (h + 2
    h_kv) d) and of (b, s, h, d) memory."""
    qkv = randn(gen, (b, s, (h + 2 * h_kv) * d))
    views = [x.transpose(1, 2) for x in packed_views(qkv, h, h_kv, d)]
    dout = randn(gen, (b, s, h, d)).transpose(1, 2)
    check(not any(x.is_contiguous() for x in (*views, dout)),
          "packed views came out contiguous")
    return (*views, dout)


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


SDPA_BACKENDS = ("FLASH_ATTENTION", "CUDNN_ATTENTION", "EFFICIENT_ATTENTION")


def sdpa_fastest(make):
    """The library yardstick through scaled_dot_product_attention under each
    backend of SDPA_BACKENDS pinned in turn: ``make()`` builds the call (for
    a backward, its autograd graph too) under the pin, and busy_ms times it
    there. Returns (ms, backend) of the fastest backend that accepts the
    call, and {backend: ms, or None where it refused}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    times = {}
    for name in SDPA_BACKENDS:
        with sdpa_kernel(getattr(SDPBackend, name)):
            try:
                fn = make()
                fn()
                torch.cuda.synchronize()
            except RuntimeError:
                times[name] = None
                continue
            times[name] = busy_ms(fn)
    ok = {k: v for k, v in times.items() if v is not None}
    check(ok, "no SDPA backend accepts the library call")
    best = min(ok, key=ok.get)
    return ok[best], best, times


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


# Mangled kernel names of the Hopper kernels the build report covers.
REPORTED = {"flash_fwd_wgmma": "K1", "flash_bwd_wgmma": "K2",
            "paged_decode_mma": "K5", "paged_decode_f32": "K5",
            "paged_chunk_wgmma": "K6", "paged_merge_kernel": "K5/K6 merge"}


def kernel_label(mangled: str) -> str | None:
    """'K1 bf16 d=64' for a mangled name of a REPORTED kernel, else None."""
    kernel = next((v for k, v in REPORTED.items() if k in mangled), None)
    if kernel is None:
        return None
    dtype = ("bf16" if "nv_bfloat16" in mangled else
             "fp16" if "half" in mangled else "fp32")
    d = re.search(r"Li(\d+)E", mangled).group(1)
    return f"{kernel} {dtype} d={d}"


def phase_build_report():
    """Evidence of what the Hopper kernels K1, K2, K5 and K6 were built
    into: ptxas's registers and spills (-Xptxas -v at build), their
    dynamic shared memory, and, where cuobjdump exists, the HGMMA (wgmma)
    instructions of K1's, K2's and K6's bf16/fp16 kernels in the SASS."""
    lib = _build.lib()
    print("dynamic shared memory: " + ", ".join(
        f"K1 d={d} {lib.fattn_flash_fwd_smem(d)} B, K2 d={d} "
        f"{lib.fattn_flash_bwd_smem(d)} B, K5 d={d} "
        f"{lib.fattn_paged_decode_smem(d)} B, K6 d={d} "
        f"{lib.fattn_paged_chunk_smem(d)} B" for d in (64, 128)))
    log = _build.build_log()
    if log is None:
        print("ptxas report: not measured (the library was not built here)")
    else:
        name, spills = None, ""
        for line in log.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                name = kernel_label(entry.group(1))
            elif name and "spill" in line:
                spills = line.strip()
            elif name and "Used" in line:
                regs = re.search(r"Used (\d+) registers", line).group(1)
                print(f"ptxas {name}: {regs} registers; {spills}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.access(tool, os.X_OK):
        print("HGMMA count: not measured (no cuobjdump)")
        return
    sass = subprocess.run([tool, "-sass", str(_build.library_path())],
                          check=True, capture_output=True, text=True,
                          timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            name = kernel_label(name) if "wgmma" in name else None
        elif name and "HGMMA" in line:
            counts[name] = counts.get(name, 0) + 1
    check(len(counts) == 12 and all(counts.values()),
          f"HGMMA instructions missing from the wgmma kernels: {counts}")
    print("HGMMA instructions in the SASS (cuobjdump): " + ", ".join(
        f"{k} {v}" for k, v in sorted(counts.items())))


# ---------------------------------------------------------------- phase 2

def phase_kernels(gen):
    """Each kernel against its twin at main-path shapes, bf16. Returns
    {name: max_abs_err vs twin}."""
    errs = {}
    # K1: causal prefill at GPT-2 widths, ragged, GQA, head_dim 128, on
    # views of a fused projection as the model passes them.
    for b, h, h_kv, s, d in [(4, 12, 12, 512, 64), (4, 12, 12, 300, 64),
                             (4, 12, 4, 512, 64), (4, 6, 6, 512, 128)]:
        q, k, v, _ = packed_inputs(gen, b, h, h_kv, s, d)
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

    # K5 at GPT-2's and Llama-3-8B's decode shapes.
    errs["paged_decode"] = 0.0
    for shape in DECODE_SHAPES:
        q, kp, vp, lens, table = decode_inputs(gen, shape)
        out = paged_decode_attention(q, kp, vp, lens, table)
        torch.cuda.synchronize()
        twin = paged_decode_attention_plain(q, kp, vp, lens, table,
                                            softmax_scale=q.shape[-1] ** -0.5)
        ref32, ref16 = dense_decode_refs(q, kp, vp, lens, table)
        err, base = assert_two_x_bound(out, ref32, ref16,
                                       label=f"paged_decode {shape}")
        vs_twin = max_err(out, twin)
        errs["paged_decode"] = max(errs["paged_decode"], vs_twin)
        print(f"paged_decode {shape} h={q.shape[1]}/{kp.shape[0]} "
              f"d={q.shape[-1]} lengths={lens.tolist()}, "
              f"{decode_splits(q, kp, table)} splits: err vs fp32 "
              f"{err:.3e} (bf16 baseline {base:.3e}), vs twin {vs_twin:.3e}")
        del q, kp, vp, out, twin, ref32, ref16

    # K7c / K7a: bitwise equal to the twins outside the scratch page 0, on
    # GPT-2's 128-byte rows and Llama-3-8B's 256-byte rows (8 kv heads).
    for h, d in ((12, 64), (8, 128)):
        ps, num_pages = 128, 65
        pages = (randn(gen, (h, num_pages, ps, d)),
                 randn(gen, (h, num_pages, ps, d)))
        on_card = cache.PagedKVCache(pages[0].clone(), pages[1].clone())
        plain = cache.PagedKVCache(pages[0].clone(), pages[1].clone())
        # A 700-token prompt: 6 pages (tail zero-filled) plus a scratch
        # entry.
        k, v = randn(gen, (700, h, d)), randn(gen, (700, h, d))
        ids = int32([7, 3, 9, 11, 5, 13, 0])
        cache.write_prompt(on_card, k, v, ids)
        cache.write_prompt_plain(plain, k, v, ids)
        # Batch 8: page edges, an inactive slot (-1), the last slot of a
        # table.
        lens8 = int32([5, 127, 128, 300, -1, 640, 1023, 0])
        tbl8 = torch.arange(1, 65, dtype=torch.int32, device=DEV).reshape(8, 8)
        nk, nv = randn(gen, (8, h, d)), randn(gen, (8, h, d))
        cache.append_token(on_card, nk, nv, tbl8, lens8)
        cache.append_token_plain(plain, nk, nv, tbl8, lens8)
        torch.cuda.synchronize()
        for name, a, b in (("k", on_card.k_pages, plain.k_pages),
                           ("v", on_card.v_pages, plain.v_pages)):
            check(torch.equal(a[:, 1:], b[:, 1:]),
                  f"cache writes (h_kv={h}, d={d}) differ from the twins in "
                  f"{name} pages")
        print(f"write_pages + append_token h_kv={h} d={d}: bitwise equal to "
              "the twins outside page 0")
    errs["write_pages"] = errs["append_token"] = 0.0
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
    causal bf16, on the main path's strided operands (packed_inputs). Adds
    the max errors vs the twins to ``errs``."""
    errs["flash_bwd"] = 0.0
    for b, h, h_kv, s, d, p in TRAIN_KERNEL_CASES:
        q, k, v, dout = packed_inputs(gen, b, h, h_kv, s, d)
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


def random_pages(gen, lengths, h_kv, d, ps=128, pages_max=8):
    """bf16 K/V pages holding ``lengths`` tokens per sequence, each
    sequence on its own pages in random order (page 0 is never used), and
    the page table."""
    num_pages = 1 + sum(-(-max(n, 0) // ps) for n in lengths)
    kp = randn(gen, (h_kv, num_pages, ps, d))
    vp = randn(gen, (h_kv, num_pages, ps, d))
    perm = torch.randperm(num_pages - 1, generator=gen, device=DEV) + 1
    table = torch.zeros((len(lengths), pages_max), dtype=torch.int32,
                        device=DEV)
    used = 0
    for i, n in enumerate(lengths):
        need = -(-max(n, 0) // ps)
        table[i, :need] = perm[used:used + need].to(torch.int32)
        used += need
    return kp, vp, table


def int32(values):
    return torch.tensor(values, dtype=torch.int32, device=DEV)


# name: (lengths, h, h_kv, d, pages_max)
DECODE_SHAPES = {
    # GPT-2 serving: lengths across 1..1000, an inactive slot (length 0)
    "GPT-2 decode": ([1, 127, 128, 129, 400, 777, 1000, 0], 12, 12, 64, 8),
    # Llama-3-8B chunked serving at batch 8: GQA 32/8, head_dim 128, the
    # contexts 300..4020 of its decode steps
    "Llama decode": ([300, 831, 1362, 1894, 2425, 2957, 3488, 4020], 32, 8,
                     128, 32),
    # one long context at Llama-3-8B's widths: 8 blocks without split-KV
    "Llama decode long": ([16384], 32, 8, 128, 128),
}


def decode_inputs(gen, shape="GPT-2 decode"):
    lengths, h, h_kv, d, pages_max = DECODE_SHAPES[shape]
    kp, vp, table = random_pages(gen, lengths, h_kv, d, pages_max=pages_max)
    return randn(gen, (len(lengths), h, d)), kp, vp, int32(lengths), table


def decode_splits(q, kp, table) -> int:
    """The split count the K5 wrapper chooses for these inputs."""
    return paged_num_splits(q.shape[0], kp.shape[0], table.shape[1],
                            kp.shape[2], sm_count(q.device.index))


def chunk_splits(q, kp, table) -> int:
    """The split count the K6 wrapper chooses (bf16/fp16)."""
    group = q.shape[2] // kp.shape[0]
    tiles = -(-q.shape[1] // (BLOCK_ROWS // group))
    return paged_num_splits(q.shape[0] * tiles, kp.shape[0], table.shape[1],
                            kp.shape[2], sm_count(q.device.index))


def decode_work(q, kp, lens, table):
    """Bytes and tensor-core operations paged decode needs: the cached K and
    V of each active sequence read once, q read and out written for each
    active sequence (an inactive one's output is 0 by definition), the
    int32 tables; QK^T and PV over every cached key for each query head."""
    h, d = q.shape[1:]
    live, active = int(lens.clamp(min=0).sum()), int((lens > 0).sum())
    elem = q.element_size()
    return (2 * live * kp.shape[0] * d * elem + 2 * active * h * d * elem
            + nbytes(lens, table), 4 * live * h * d)


def dense_decode_refs(q, kp, vp, lens, table):
    """fp32 and same-dtype dense attention over each sequence's keys: the
    chunk oracle at sq = 1 (the query is each sequence's last position)."""
    one = (lens > 0).to(torch.int32)
    return tuple(paged_chunk_ref(q[:, None], kp, vp, lens, table, one,
                                 upcast=up)[:, 0] for up in (True, False))


# name: (lengths including the chunk, chunk_lens, sq, h, h_kv, d, pages_max)
CHUNK_SHAPES = {
    # an engine chunk of GPT-2: rows in their first to fourth chunk, short
    # rows, a padding row
    "GPT-2 chunk": ([9, 200, 256, 300, 512, 777, 1000, 600],
                    [9, 200, 256, 44, 256, 9, 232, 0], 256, 12, 12, 64, 8),
    # an engine chunk of Llama-3-8B: GQA 32/8, head_dim 128
    "Llama chunk": ([300, 512, 1024, 1500, 2048, 3000, 4000, 700],
                    [300, 512, 512, 476, 512, 440, 416, 188], 512, 32, 8,
                    128, 32),
    # speculative verification: [last, d1..d4]
    "verify": ([5, 6, 130, 500, 505, 1000, 17, 0],
               [5, 5, 5, 5, 5, 3, 5, 0], 5, 12, 12, 64, 8),
}


def chunk_inputs(gen, shape):
    lengths, chunk_lens, sq, h, h_kv, d, pages_max = CHUNK_SHAPES[shape]
    kp, vp, table = random_pages(gen, lengths, h_kv, d, pages_max=pages_max)
    q = randn(gen, (len(lengths), sq, h, d))
    return q, kp, vp, int32(lengths), table, int32(chunk_lens)


def phase_chunk_kernels(gen, errs):
    """K6 at the GPT-2 and Llama chunk shapes, the verify shape and sq = 1
    (where it must also agree with K5), held to the 2x rule (oracle:
    paged_chunk_ref in fp32; baseline: the same in bf16), padding rows
    exactly 0; K7b bit for bit against its twin, and at sq = 1 against
    K7a. Adds the max errors vs the twins to ``errs``."""
    errs["paged_chunk"] = 0.0
    for shape, (lengths, chunk_lens, sq, h, h_kv, d, _) in \
            CHUNK_SHAPES.items():
        q, kp, vp, lens, table, cl = chunk_inputs(gen, shape)
        out = paged_chunk_attention(q, kp, vp, lens, table, chunk_lens=cl)
        torch.cuda.synchronize()
        twin = paged_chunk_attention_plain(q, kp, vp, lens, table,
                                           chunk_lens=cl,
                                           softmax_scale=d ** -0.5)
        err, base = assert_two_x_bound(
            out, paged_chunk_ref(q, kp, vp, lens, table, cl),
            paged_chunk_ref(q, kp, vp, lens, table, cl, upcast=False),
            label=f"paged_chunk {shape}")
        for i, c in enumerate(chunk_lens):
            check(not out[i, c:].any(),
                  f"paged_chunk {shape}: padding rows of sequence {i}")
        vs_twin = max_err(out, twin)
        errs["paged_chunk"] = max(errs["paged_chunk"], vs_twin)
        print(f"paged_chunk {shape} b={len(lengths)} sq={sq} h={h}/{h_kv} "
              f"d={d}, {chunk_splits(q, kp, table)} splits: err vs fp32 "
              f"{err:.3e} (bf16 baseline {base:.3e}), vs twin {vs_twin:.3e}")
        del q, kp, vp, out, twin

    # sq = 1: decode through K6, against K5 on the same cache.
    for shape in DECODE_SHAPES:
        q, kp, vp, lens, table = decode_inputs(gen, shape)
        cl = (lens > 0).to(torch.int32)
        k6 = paged_chunk_attention(q[:, None], kp, vp, lens, table,
                                   chunk_lens=cl)[:, 0]
        k5 = paged_decode_attention(q, kp, vp, lens, table)
        torch.cuda.synchronize()
        ref32, ref16 = dense_decode_refs(q, kp, vp, lens, table)
        err, base = assert_two_x_bound(k6, ref32, ref16,
                                       label=f"paged_chunk sq=1 {shape}")
        k6_k5 = max_err(k6, k5)
        check(k6_k5 <= 2 * base + 1e-5, f"K6 at sq=1 vs K5 ({shape}): "
              f"{k6_k5:.3e} > 2 * {base:.3e} + 1e-5")
        twin = paged_chunk_attention_plain(
            q[:, None], kp, vp, lens, table, chunk_lens=cl,
            softmax_scale=q.shape[-1] ** -0.5)
        errs["paged_chunk"] = max(errs["paged_chunk"],
                                  max_err(k6, twin[:, 0]))
        print(f"paged_chunk sq=1 {shape} lengths={lens.tolist()}, "
              f"{chunk_splits(q[:, None], kp, table)} splits: err vs "
              f"fp32 {err:.3e} (bf16 baseline {base:.3e}), vs K5 "
              f"{k6_k5:.3e}")
        del q, kp, vp, k6, k5, twin, ref32, ref16

    # K7b: batch 8, spans of 5 crossing page edges, an inactive row (-1), a
    # row running past its table, a short row and a padding row.
    h, d, ps, num_pages = 12, 64, 128, 65
    pages = (randn(gen, (h, num_pages, ps, d)),
             randn(gen, (h, num_pages, ps, d)))
    on_card = cache.PagedKVCache(pages[0].clone(), pages[1].clone())
    plain = cache.PagedKVCache(pages[0].clone(), pages[1].clone())
    lens8 = int32([5, 125, 128, 300, -1, 1020, 638, 0])
    new8 = int32([5, 5, 5, 2, 5, 5, 5, 0])
    tbl8 = torch.arange(1, 65, dtype=torch.int32, device=DEV).reshape(8, 8)
    nk, nv = randn(gen, (8, 5, h, d)), randn(gen, (8, 5, h, d))
    cache.append_span(on_card, nk, nv, tbl8, lens8, new8)
    cache.append_span_plain(plain, nk, nv, tbl8, lens8, new8)
    span = cache.PagedKVCache(pages[0].clone(), pages[1].clone())
    token = cache.PagedKVCache(pages[0].clone(), pages[1].clone())
    first_k, first_v = nk[:, :1].contiguous(), nv[:, :1].contiguous()
    cache.append_span(span, first_k, first_v, tbl8, lens8)
    cache.append_token(token, first_k[:, 0], first_v[:, 0], tbl8, lens8)
    torch.cuda.synchronize()
    for name, a, b in (("k", on_card.k_pages, plain.k_pages),
                       ("v", on_card.v_pages, plain.v_pages)):
        check(torch.equal(a, b), f"append_span differs from its twin in "
              f"{name} pages")
    for name, a, b in (("k", span.k_pages, token.k_pages),
                       ("v", span.v_pages, token.v_pages)):
        check(torch.equal(a[:, 1:], b[:, 1:]),
              f"append_span at sq=1 differs from append_token in {name}")
    errs["append_span"] = 0.0
    print("append_span: bitwise equal to its twin on every page; at sq=1 "
          "equal to append_token outside page 0")


def phase_determinism(gen, n=10):
    """Each kernel ``n`` times on the same inputs and seed: every rerun
    bit for bit the first. K1 + K2 at the train shape with dropout 0.1 (out,
    lse, dq, dk, dv), K8a-c at BS_SHAPES (i) (the same), K5 at "Llama
    decode" and K6 at "Llama chunk" (out; split-KV merged in split order)."""
    def same(label, fn):
        first = [x.clone() for x in fn()]
        for _ in range(n - 1):
            again = fn()
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(first, again)):
                check(torch.equal(a, b),
                      f"determinism {label}: output {i} differs between runs")
        print(f"determinism {label}: {n} seeded reruns bit for bit equal")

    q, k, v, dout = packed_inputs(gen, 8, 12, 12, 1024, 64)
    kw = dict(causal=True, softmax_scale=0.125, dropout_p=0.1, seed=SEED)

    def dense():
        out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
        return (out, lse, *flash_attention_bwd(q, k, v, out, dout, lse, **kw))
    same("flash_fwd + flash_bwd b=8 h=12 s=1024 d=64 p=0.1 (out, lse, dq, "
         "dk, dv)", dense)
    q, k, v, dout, layout, qv, kv, p = bs_inputs(gen, "(i) GPT-2 train")
    kw = dict(softmax_scale=0.125, dropout_p=p, seed=SEED)

    def sparse():
        out, lse = blocksparse_attention_fwd(q, k, v, layout, qv, kv, **kw)
        return (out, lse, *blocksparse_attention_bwd(
            q, k, v, out, dout, lse, layout, qv, kv, **kw))
    same("blocksparse_* BS_SHAPES (i) (out, lse, dq, dk, dv)", sparse)
    q, kp, vp, lens, table = decode_inputs(gen, "Llama decode")
    same(f"paged_decode Llama decode, {decode_splits(q, kp, table)} splits",
         lambda: (paged_decode_attention(q, kp, vp, lens, table),))
    q, kp, vp, lens, table, cl = chunk_inputs(gen, "Llama chunk")
    same(f"paged_chunk Llama chunk, {chunk_splits(q, kp, table)} splits",
         lambda: (paged_chunk_attention(q, kp, vp, lens, table,
                                        chunk_lens=cl),))
    q, kp, vp, lens, table, cl = chunk_inputs(gen, "verify")
    same(f"paged_chunk verify, {chunk_splits(q, kp, table)} splits",
         lambda: (paged_chunk_attention(q, kp, vp, lens, table,
                                        chunk_lens=cl),))
    torch.cuda.empty_cache()


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


def gpt2_fp32(model):
    """The same GPT-2 weights, stored and computed in fp32: the oracle."""
    model32 = GPT2LMHeadModel(
        GPT2Config(dtype=torch.float32), device=DEV,
        generator=torch.Generator(device=DEV).manual_seed(0))
    model32.load_state_dict(model.state_dict())
    return model32


def check_teacher_forced(label, served, full32, full16):
    """The repo's 2x rule applied to a whole serving path. The oracle is
    the same model with its (bf16) weights upcast to fp32; the baseline is
    the full-sequence bf16 forward. The served logits may be at most twice
    as far from the oracle as the baseline's, plus 1e-3 (fp32 noise of the
    oracle's own kernels)."""
    check(bool(torch.isfinite(served).all()), f"{label}: non-finite logits")
    err, base = assert_two_x_bound(served, full32, full16, atol=1e-3,
                                   label=label)
    agree = float((served.argmax(-1) == full32.argmax(-1)).float().mean())
    return (f"max |logit err| vs fp32 model {err:.3e} (bf16 full forward "
            f"{base:.3e}); argmax agreement with fp32 {agree:.3f}")


def phase_teacher_forcing(model, cfg, model32, rng, prompt_len=300,
                          n_decode=16):
    """prefill + n_decode decode steps against the full-sequence model."""
    ids = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, prompt_len + n_decode))).to(DEV)
    with torch.no_grad():
        full16 = model(ids)[0, prompt_len - 1:]
        full32 = model32(ids)[0, prompt_len - 1:]
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
    result = check_teacher_forced("teacher forcing", torch.stack(steps),
                                  full32, full16)
    print(f"teacher forcing: prefill + {n_decode} decode steps, {result}")


def serve_teacher_forced(model, cfg, fns, ids, prompt_len, chunk, n_decode,
                         ps=128):
    """Chunked prefill of ids[:, :prompt_len] in chunks of ``chunk`` tokens,
    then ``n_decode`` decode steps fed ids' next tokens, through ``fns``
    (gpt2_decode or llama_decode) on one sequence's pages. Returns (the
    positions whose logits were served, those logits)."""
    n_pages = -(-max(-(-prompt_len // chunk) * chunk,
                     prompt_len + n_decode) // ps)
    caches = [cache.init_cache(cfg.n_kv_heads, 1 + n_pages, ps, cfg.head_dim,
                               dtype=cfg.dtype, device=DEV)
              for _ in range(cfg.n_layer)]
    table = torch.arange(1, 1 + n_pages, dtype=torch.int32,
                         device=DEV)[None]
    positions, steps = [], []
    for off in range(0, prompt_len, chunk):
        c = min(chunk, prompt_len - off)
        chunk_ids = torch.zeros((1, chunk), dtype=ids.dtype, device=DEV)
        chunk_ids[0, :c] = ids[0, off:off + c]
        logits, caches = fns.chunk_prefill_step(
            model, cfg, caches, chunk_ids, int32([off]), int32([c]),
            table[:, off // ps:(off + chunk) // ps], table)
        positions.append(off + c - 1)
        steps.append(logits[0])
    for t in range(n_decode):
        logits, caches = fns.decode_step(model, cfg, caches, table,
                                         int32([prompt_len + t]),
                                         ids[:, prompt_len + t])
        positions.append(prompt_len + t)
        steps.append(logits[0])
    return positions, torch.stack(steps)


def check_finished(label, finished, n, cfg, new_tokens, limit):
    check(len(finished) == n, f"{label}: {len(finished)} of {n} requests "
          "finished")
    for r in finished:
        # A prompt near the position limit retires when its cache is full.
        want = min(new_tokens, limit - len(r.prompt))
        check(len(r.generated) == want, f"{label}: request {r.seq_id} gave "
              f"{len(r.generated)} tokens, want {want}")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"{label}: request {r.seq_id}: token out of range")


def run_chunked(label, model, cfg, prompts, engine_kw, new_tokens=32):
    """Serve ``prompts`` through a chunked-prefill engine; every request
    must finish, the chunk path's kernels must launch and the dense
    forward must not. Returns the launch counts of the run."""
    engine = ServingEngine(model, cfg, **engine_kw)
    for p in prompts:
        engine.submit(p, max_new_tokens=new_tokens)
    reset_launches()
    t0 = time.perf_counter()
    finished = engine.run(max_steps=1000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(KERNELS)
    limit = min(cfg.max_position_embeddings,
                engine_kw["pages_per_seq"] * engine_kw["page_size"])
    check_finished(label, finished, len(prompts), cfg, new_tokens, limit)
    for name in CHUNKED_KERNELS:
        check(launches[name] > 0, f"{label}: kernel {name} not launched")
    check(launches["flash_fwd"] == 0,
          f"{label}: the dense forward ran; prefill was not chunked")
    lens = [len(p) for p in prompts]
    print(f"{label}: {len(prompts)} requests (prompts {min(lens)}.."
          f"{max(lens)}, chunks of {engine_kw['prefill_chunk']}) x up to "
          f"{new_tokens} tokens in {dt:.2f} s; launches {launches}")
    return launches


def phase_serve_chunked(model, cfg, model32, rng):
    """GPT-2 chunked serving: 12 requests, then a 700-token prompt in three
    chunks of 256 + 16 decode steps held to teacher forcing (logits at each
    chunk's last token and at every decode step). Returns the launch
    counts of the 12 requests."""
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in np.linspace(9, 1000, 12).astype(int)]
    launches = run_chunked("serve chunked", model, cfg, prompts, dict(
        max_batch=8, page_size=128, num_pages=128, pages_per_seq=8,
        prefill_chunk=256))
    prompt_len, n_decode = 700, 16
    ids = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, prompt_len + n_decode))).to(DEV)
    positions, served = serve_teacher_forced(model, cfg, gpt2_decode, ids,
                                             prompt_len, 256, n_decode)
    with torch.no_grad():
        full16 = model(ids)[0, positions]
        full32 = model32(ids)[0, positions]
    result = check_teacher_forced("chunked teacher forcing", served, full32,
                                  full16)
    print(f"chunked teacher forcing: {prompt_len}-token prompt in chunks of "
          f"256 + {n_decode} decode steps (positions {positions[:3]}, "
          f"{positions[3]}..{positions[-1]}), {result}")
    return launches


def phase_speculative(model, cfg, model32, rng, prompt_len=500,
                      new_tokens=48, k=4, draft_layers=6):
    """Speculative decoding at full width: a 6-layer draft of the same
    weights proposes k tokens through K1, the 12-layer model verifies them
    through flash_attn_with_kvcache (K7b + K6). Every verify round's logits
    are held to the 2x rule against the fp32 and bf16 full-sequence models
    on the same tokens (bf16 argmax near-ties may make the tokens differ
    from plain greedy decoding, so they are not compared). Returns the
    launch counts of the run."""
    prompt = rng.integers(0, cfg.vocab_size, prompt_len).tolist()
    reset_launches()
    t0 = time.perf_counter()
    generated, rounds = speculative_decode(model, cfg, prompt, new_tokens,
                                           k=k, draft_layers=draft_layers)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(KERNELS)
    check(len(generated) == new_tokens, f"speculative: {len(generated)} "
          "tokens")
    for name in SPEC_KERNELS:
        check(launches[name] > 0, f"speculative: kernel {name} not launched")
    final = prompt + generated
    accepted, worst = 0, (0.0, 0.0)
    for pos0, chunk, logits in rounds:
        greedy = logits.argmax(-1).tolist()
        n_acc = 0
        while n_acc < k and chunk[1 + n_acc] == greedy[n_acc]:
            n_acc += 1
        accepted += n_acc
        seq = torch.tensor([final[:pos0] + chunk], device=DEV)
        with torch.no_grad():
            full16 = model(seq)[0, pos0:]
            full32 = model32(seq)[0, pos0:]
        check(bool(torch.isfinite(logits).all()), "speculative: non-finite")
        err, base = assert_two_x_bound(logits, full32, full16, atol=1e-3,
                                       label=f"verify round at {pos0}")
        worst = max(worst, (err, base))
    print(f"speculative: {prompt_len}-token prompt, {new_tokens} tokens in "
          f"{len(rounds)} verify rounds of {k + 1} rows ({accepted} of "
          f"{k * len(rounds)} drafts accepted) in {dt:.2f} s; worst verify "
          f"logit err vs fp32 {worst[0]:.3e} (bf16 full forward "
          f"{worst[1]:.3e}); launches {launches}")
    return launches


# ---------------------------------------------------------------- phase 4

def admission(model, cfg, prompts, engine_kw):
    """A fresh engine with ``prompts`` queued and admitted in one call, and
    the host ms of that admission (prefill of all: time to first token)."""
    eng = ServingEngine(model, cfg, **engine_kw)
    for p in prompts:
        eng.submit(p, max_new_tokens=1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng._admit()
    torch.cuda.synchronize()
    return eng, (time.perf_counter() - t0) * 1e3


def ttft_ms(model, cfg, prompts, engine_kw):
    """Sorted TTFT of 3 admissions on fresh engines after a warm-up."""
    admission(model, cfg, prompts, engine_kw)  # cuBLAS handles, allocator
    return sorted(admission(model, cfg, prompts, engine_kw)[1]
                  for _ in range(3))


def decode_rate(model, cfg, prompts, engine_kw, n_steps=32):
    """(tokens/s, ms/step) of n_steps engine steps with every slot active,
    after 3 warm-up steps."""
    eng, _ = admission(model, cfg, prompts, engine_kw)
    for _ in range(3):
        eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_steps):
        eng.step()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    return len(prompts) * n_steps / dt, dt / n_steps * 1e3


def ttft_line(label, ttft, card):
    return (f"{label}: median {ttft[1]:.2f} ms (min {ttft[0]:.2f}, max "
            f"{ttft[2]:.2f}) [{card}]")


def phase_timing(model, cfg, rng):
    lens = np.linspace(9, 700, 8).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    kw = dict(max_batch=8, page_size=128, num_pages=128, pages_per_seq=8)
    ttft = ttft_ms(model, cfg, prompts, kw)
    ttft_chunked = ttft_ms(model, cfg, prompts, dict(kw, prefill_chunk=256))
    tok_s, ms_step = decode_rate(model, cfg, prompts, kw)
    card = card_line()
    print(ttft_line(f"prefill TTFT, one batch of 8 admissions (prompts "
                    f"{lens.min()}..{lens.max()}, bucket 768)", ttft, card))
    print(ttft_line("chunked prefill TTFT, the same 8 admissions in chunks "
                    "of 256", ttft_chunked, card))
    print(f"decode at batch 8 (contexts {lens.min()}..{lens.max() + 35}): "
          f"{tok_s:.1f} tokens/s, {ms_step:.2f} ms/step [{card}]")


def llama_fp32(model):
    """The same Llama weights, stored and computed in fp32: the oracle."""
    cfg32 = dataclasses.replace(model.config, dtype=torch.float32,
                                param_dtype=torch.float32)
    model32 = LlamaForCausalLM(
        cfg32, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0))
    model32.load_state_dict(model.state_dict())
    return model32


def phase_llama(rng):
    """Llama-3-8B's published widths, bf16, random weights: 8 requests
    (prompts 300..4000) through the chunked engine, its TTFT and decode
    rate, and a 1500-token prompt in three chunks of 512 + 16 decode steps
    held to the 2x rule against the same weights in fp32. Returns the
    launch counts of the 8 requests."""
    cfg = LLAMA3_8B
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama: Llama-3-8B widths, {n_params / 1e9:.3f} B parameters "
          f"(bf16) built in {time.perf_counter() - t0:.1f} s")
    lens = np.linspace(300, 4000, 8).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    kw = dict(model_fns=llama_decode, max_batch=8, page_size=128,
              pages_per_seq=32, num_pages=8 * 32 + 1, prefill_chunk=512)
    launches = run_chunked("llama chunked", model, cfg, prompts, kw)
    ttft = ttft_ms(model, cfg, prompts, kw)
    tok_s, ms_step = decode_rate(model, cfg, prompts, kw, n_steps=16)
    card = card_line()
    print(ttft_line(f"llama chunked prefill TTFT, one batch of 8 admissions "
                    f"(prompts {lens.min()}..{lens.max()}, chunks of 512)",
                    ttft, card))
    print(f"llama decode at batch 8 (contexts {lens.min()}.."
          f"{lens.max() + 20}): {tok_s:.1f} tokens/s, {ms_step:.2f} ms/step "
          f"[{card}]")
    engine = ServingEngine(model, cfg, **kw)
    for p in prompts:
        engine.submit(p, max_new_tokens=1000)
    print(f"llama prefill trace, one admission of 8: "
          f"{device_summary(*trace_call(engine._admit)[::2])} [{card}]")
    wall, _, events = trace_call(lambda: [engine.step() for _ in range(4)])
    print(f"llama decode trace, 4 steps at batch 8: "
          f"{device_summary(wall, events)} [{card}]")
    del engine
    torch.cuda.empty_cache()

    prompt_len, n_decode = 1500, 16
    ids = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, prompt_len + n_decode))).to(DEV)
    positions, served = serve_teacher_forced(model, cfg, llama_decode, ids,
                                             prompt_len, 512, n_decode)
    with torch.no_grad():
        full16 = model(ids)[0, positions]
        model32 = llama_fp32(model)
        del model
        torch.cuda.empty_cache()
        full32 = model32(ids)[0, positions]
    del model32
    torch.cuda.empty_cache()
    result = check_teacher_forced("llama chunked teacher forcing", served,
                                  full32, full16)
    print(f"llama chunked teacher forcing: {prompt_len}-token prompt in "
          f"chunks of 512 + {n_decode} decode steps, {result}")
    return launches


def chunk_work(shape, elem=2):
    """Bytes and tensor-core operations paged chunk attention needs on
    CHUNK_SHAPES[shape]: q read for each live row (a padding row's output
    is 0 by definition), out written for every row, the cached K and V of
    each sequence with a live row read once, the int32 tables; QK^T and PV
    over each live row's visible keys."""
    lengths, chunk_lens, sq, h, h_kv, d, pages_max = CHUNK_SHAPES[shape]
    keys = sum(n for n, c in zip(lengths, chunk_lens) if c > 0)
    pairs = sum(n - c + t + 1 for n, c in zip(lengths, chunk_lens)
                for t in range(c))
    rows = sum(chunk_lens) + len(lengths) * sq  # q read, out written
    n_bytes = (rows * h * d + 2 * keys * h_kv * d) * elem \
        + 4 * len(lengths) * (2 + pages_max)
    return n_bytes, 4 * pairs * h * d


def sdpa_fwd(q, k, v, p=0.0, mask=None):
    """The SDPA forward yardstick: causal, or with a boolean mask."""
    kw = dict(is_causal=True) if mask is None else dict(attn_mask=mask)
    gqa = k.shape[1] != q.shape[1]
    return lambda: lambda: F.scaled_dot_product_attention(
        q, k, v, dropout_p=p, enable_gqa=gqa, **kw)


def sdpa_bwd(q, k, v, dout, p=0.0, mask=None, wrt="qkv"):
    """The SDPA backward yardstick: the gradients ``wrt`` of a graph built
    under the pinned backend."""
    kw = dict(is_causal=True) if mask is None else dict(attn_mask=mask)
    gqa = k.shape[1] != q.shape[1]

    def make():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, dropout_p=p,
                                             enable_gqa=gqa, **kw)
        wanted = [leaves["qkv".index(c)] for c in wrt]
        return lambda: torch.autograd.grad(out, wanted, dout,
                                           retain_graph=True)
    return make


def kernel_timing(gen):
    """Each kernel against its twin and, where one exists, a single PyTorch
    call computing the same function, at the main paths' shapes, in turns
    (plain, kernel, kernel, plain; the library call last, under each pinned
    SDPA backend). Returns {name: (ms, plain_ms, library_ms, bound_ms,
    bound_by, library_backend)}."""
    card = card_line()
    # K1 at the serving bucket (b=8, s=768, no lse) and at the train step
    # (s=1024, dropout 0.1 and 0, lse saved); K2 at the train step.
    q = randn(gen, (8, 12, 768, 64))
    k, v = randn(gen, (8, 12, 768, 64)), randn(gen, (8, 12, 768, 64))
    fwd = dict(causal=True, softmax_scale=0.125, save_lse=False)
    qt, kt, vt, dt = (randn(gen, (8, 12, 1024, 64)) for _ in range(4))
    train = dict(causal=True, softmax_scale=0.125, dropout_p=0.1, seed=SEED)
    train0 = dict(causal=True, softmax_scale=0.125)
    ot, lt = flash_attention_fwd(qt, kt, vt, save_lse=True, **train)
    # K1 and K2 at Llama-3-8B's attention widths (GQA 32/8, d=128), b=2,
    # s=2048: not on a path (Llama serving prefills through K6).
    qa, da = randn(gen, (2, 32, 2048, 128)), randn(gen, (2, 32, 2048, 128))
    ka, va = randn(gen, (2, 8, 2048, 128)), randn(gen, (2, 8, 2048, 128))
    wide = dict(causal=True, softmax_scale=128 ** -0.5)
    oa, la = flash_attention_fwd(qa, ka, va, save_lse=True, **wide)
    qd, kp, vp, dl, tbl = decode_inputs(gen)
    ql, kl, vl, ll, tl = decode_inputs(gen, "Llama decode")
    qg, kg, vg, lg, tg = decode_inputs(gen, "Llama decode long")
    pages = cache.init_cache(12, 65, 128, 64, dtype=BF16, device=DEV)
    kw, vw = randn(gen, (768, 12, 64)), randn(gen, (768, 12, 64))
    ids = torch.tensor([7, 3, 9, 11, 5, 13], dtype=torch.int32, device=DEV)
    nk, nv = randn(gen, (8, 12, 64)), randn(gen, (8, 12, 64))
    tbl8 = torch.arange(1, 65, dtype=torch.int32, device=DEV).reshape(8, 8)
    l8 = torch.tensor([5, 127, 128, 300, -1, 640, 999, 0], dtype=torch.int32,
                      device=DEV)
    sk, sv = randn(gen, (8, 5, 12, 64)), randn(gen, (8, 5, 12, 64))
    span = ([5, 125, 128, 300, -1, 1020, 638, 0], [5, 5, 5, 2, 5, 5, 5, 0])
    span_lens, span_new = int32(span[0]), int32(span[1])
    written = sum(1 for n, c in zip(*span) if n >= 0 for t in range(c)
                  if (n + t) // 128 < 8)  # tokens append_span stores

    specs = {
        # name: (kernel, plain twin, library call or None, bytes, flops)
        "flash_fwd": (
            lambda: flash_attention_fwd(q, k, v, **fwd),
            lambda: flash_attention_fwd_plain(q, k, v, **fwd),
            sdpa_fwd(q, k, v),
            nbytes(q, k, v, q), 4 * 8 * 12 * causal_pairs(768) * 64),
        "flash_fwd (train step, dropout 0.1, lse)": (
            lambda: flash_attention_fwd(qt, kt, vt, save_lse=True, **train),
            lambda: flash_attention_fwd_plain(qt, kt, vt, save_lse=True,
                                              **train),
            sdpa_fwd(qt, kt, vt, p=0.1),
            nbytes(qt, kt, vt, qt, lt),
            4 * 8 * 12 * causal_pairs(1024) * 64),
        "flash_fwd (train step, dropout 0, lse)": (
            lambda: flash_attention_fwd(qt, kt, vt, save_lse=True, **train0),
            lambda: flash_attention_fwd_plain(qt, kt, vt, save_lse=True,
                                              **train0),
            sdpa_fwd(qt, kt, vt),
            nbytes(qt, kt, vt, qt, lt),
            4 * 8 * 12 * causal_pairs(1024) * 64),
        "flash_bwd": (
            lambda: flash_attention_bwd(qt, kt, vt, ot, dt, lt, **train),
            lambda: flash_attention_bwd_plain(qt, kt, vt, ot, dt, lt, **train),
            sdpa_bwd(qt, kt, vt, dt, p=0.1),
            nbytes(qt, kt, vt, ot, dt, lt) + nbytes(qt, kt, vt),
            10 * 8 * 12 * causal_pairs(1024) * 64),
        "flash_fwd (Llama-3-8B widths, lse)": (
            lambda: flash_attention_fwd(qa, ka, va, save_lse=True, **wide),
            lambda: flash_attention_fwd_plain(qa, ka, va, save_lse=True,
                                              **wide),
            sdpa_fwd(qa, ka, va),
            nbytes(qa, ka, va, qa, la),
            4 * 2 * 32 * causal_pairs(2048) * 128),
        "flash_bwd (Llama-3-8B widths)": (
            lambda: flash_attention_bwd(qa, ka, va, oa, da, la, **wide),
            lambda: flash_attention_bwd_plain(qa, ka, va, oa, da, la, **wide),
            sdpa_bwd(qa, ka, va, da),
            nbytes(qa, ka, va, oa, da, la) + nbytes(qa, ka, va),
            10 * 2 * 32 * causal_pairs(2048) * 128),
        "paged_decode": (
            lambda: paged_decode_attention(qd, kp, vp, dl, tbl),
            lambda: paged_decode_attention_plain(qd, kp, vp, dl, tbl,
                                                 softmax_scale=0.125),
            None, *decode_work(qd, kp, dl, tbl)),
        "paged_decode (Llama decode)": (
            lambda: paged_decode_attention(ql, kl, vl, ll, tl),
            lambda: paged_decode_attention_plain(ql, kl, vl, ll, tl,
                                                 softmax_scale=128 ** -0.5),
            None, *decode_work(ql, kl, ll, tl)),
        "paged_decode (Llama decode long)": (
            lambda: paged_decode_attention(qg, kg, vg, lg, tg),
            lambda: paged_decode_attention_plain(qg, kg, vg, lg, tg,
                                                 softmax_scale=128 ** -0.5),
            None, *decode_work(qg, kg, lg, tg)),
        "append_token": (
            lambda: cache.append_token(pages, nk, nv, tbl8, l8),
            lambda: cache.append_token_plain(pages, nk, nv, tbl8, l8),
            None, 2 * nbytes(nk, nv) + nbytes(tbl8, l8), 0),
        "write_pages": (
            lambda: cache.write_prompt(pages, kw, vw, ids),
            lambda: cache.write_prompt_plain(pages, kw, vw, ids),
            None, 2 * nbytes(kw, vw) + nbytes(ids), 0),
        "append_span": (
            lambda: cache.append_span(pages, sk, sv, tbl8, span_lens,
                                      span_new),
            lambda: cache.append_span_plain(pages, sk, sv, tbl8, span_lens,
                                            span_new),
            None, 4 * written * 12 * 64 * sk.element_size()
            + nbytes(tbl8, span_lens, span_new), 0),
    }
    for shape in CHUNK_SHAPES:
        name = "paged_chunk" if shape == "GPT-2 chunk" \
            else f"paged_chunk ({shape})"
        args = chunk_inputs(gen, shape)
        specs[name] = (
            lambda a=args: paged_chunk_attention(*a[:5], chunk_lens=a[5]),
            lambda a=args: paged_chunk_attention_plain(
                *a[:5], chunk_lens=a[5], softmax_scale=a[0].shape[-1] ** -0.5),
            None, *chunk_work(shape))
    # K6 at sq = 1 on K5's inputs: decode through K6.
    for shape, inputs, k5 in (
            ("GPT-2 decode", (qd, kp, vp, dl, tbl), "paged_decode"),
            ("Llama decode", (ql, kl, vl, ll, tl),
             "paged_decode (Llama decode)")):
        a = (inputs[0][:, None].contiguous(), *inputs[1:])
        one = (a[3] > 0).to(torch.int32)
        specs[f"paged_chunk (sq=1, {shape})"] = (
            lambda a=a, one=one: paged_chunk_attention(*a, chunk_lens=one),
            lambda a=a, one=one: paged_chunk_attention_plain(
                *a, chunk_lens=one, softmax_scale=a[0].shape[-1] ** -0.5),
            None, *specs[k5][3:])
    specs.update(bs_timing_specs(gen))
    times = {}
    for name, (kern, plain, library, n_bytes, flops) in specs.items():
        p1, k1, k2, p2 = (busy_ms(plain), busy_ms(kern), busy_ms(kern),
                          busy_ms(plain))
        host = host_ms(kern)
        lib_ms = backend = None
        lib = "none"
        if library is not None:
            lib_ms, backend, each = sdpa_fastest(library)
            lib = f"{lib_ms:.4f} ms ({backend}; " + ", ".join(
                f"{b} {'refused' if t is None else f'{t:.4f}'}"
                for b, t in each.items()) + ")"
        b_ms, b_by = bound(n_bytes, flops)
        times[name] = (min(k1, k2), min(p1, p2), lib_ms, b_ms, b_by, backend)
        print(f"{name}: kernel {k1:.4f} / {k2:.4f} ms (host {host:.4f} ms "
              f"to issue a call), plain {p1:.4f} / "
              f"{p2:.4f} ms, library {lib}, bound {b_ms:.4f} ms "
              f"({b_by}: {n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP) "
              f"[{card}]")
    print("shapes: flash_fwd b=8 h=12 s=768 d=64 causal (the serving "
          "bucket), library = SDPA forward; flash_fwd (train step) and "
          "flash_bwd b=8 h=12 s=1024 d=64 causal dropout 0.1 (and the "
          "forward at dropout 0), library = SDPA forward / backward with the "
          "same dropout; the Llama-3-8B widths rows b=2 h=32/8 s=2048 d=128 "
          "causal, not on a path, library = SDPA with enable_gqa; every "
          "library time is the fastest of SDPA's flash, cuDNN and efficient "
          "backends pinned in turn (graph built under the pin), named in "
          "brackets; kernel, plain and library times are device busy time "
          "in a profiler trace of 10 calls (dense_timing.busy_ms), host = "
          "the host's time to issue one kernel call; "
          "paged_decode at "
          "DECODE_SHAPES (GPT-2 decode b=8 h=12 d=64 page 128, lengths "
          "0..1000; Llama decode b=8 h=32/8 d=128, lengths 300..4020; "
          "Llama decode long b=1 h=32/8 d=128, 16384 keys); "
          "append_token b=8 h=12; write_pages 768 tokens into 6 pages; "
          "append_span b=8 sq=5 h=12 d=64 (the K7b check's rows); "
          "paged_chunk at CHUNK_SHAPES (GPT-2 chunk b=8 sq=256 h=12 d=64, "
          "Llama chunk b=8 sq=512 h=32/8 d=128, verify b=8 sq=5 h=12 d=64) "
          "and at sq=1 on paged_decode's inputs at both DECODE_SHAPES; "
          "blocksparse_* at BS_SHAPES (i) (b=8 h=12 s=1024 d=64 causal "
          "LocalGlobalSparsityConfig(window=256), dropout 0.1) and (ii) "
          "(config 4: b=1 h=8 s=8192 d=64 causal, 25% random cells), the "
          "dkv and dq rows' plain = the whole plain backward, library = SDPA "
          "with the element mask as attn_mask (forward; backward for k, v "
          "and for q), bound by operations over visible pairs (4d forward, "
          "8d dK/dV, 6d dQ); dense K1/K2 on config 4's inputs, library = "
          "causal SDPA; all bf16")
    print_sparsity_pays(times)
    return times


# ---------------------------------------------------------------- phase 5

def train_model(cfg, attn_impl=None):
    return GPT2LMHeadModel(
        cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0),
        attn_impl=attn_impl)


def train_batch(cfg):
    """One b=8, s=1024 batch from numpy's default_rng(0)."""
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (8, 1024))).to(DEV)
    return {"input_ids": ids, "labels": ids}


def phase_train(n_steps=6):
    """The training main path: GPT2Config(dropout=0.1) at full width, fp32
    weights and AdamW state, bf16 compute, n_steps on one b=8, s=1024 batch
    (the JAX package's benchmark run_config(8, 1024)). Returns (launches,
    step, batch, generator, model, optimizer)."""
    cfg = GPT2Config(dropout=0.1)
    batch = train_batch(cfg)
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
    ("blocksparse (K8)", ("bs_fwd", "bs_dkv", "bs_dq")),
    ("flash_bwd (K2)", ("flash_bwd", "bwd_stats", "bwd_dq")),
    ("flash_fwd (K1)", ("flash_fwd",)),
    ("paged_decode (K5)", ("paged_decode",)),
    ("paged_chunk (K6)", ("paged_chunk",)),
    ("cache writes (K7)", ("append_token", "append_span", "write_pages")),
    ("GEMM", ("gemm", "cutlass", "nvjet", "xmma", "sm90_")),
    ("optimizer", ("multi_tensor", "adam")),
    ("loss", ("cross_entropy", "softmax", "nll")),
    ("layer_norm", ("layer_norm",)),
    ("dropout RNG", ("philox", "distribution", "uniform")),
    ("copies", ("memcpy", "memset", "copy")),
]


def device_summary(wall, events):
    """GPU span, busy time (the union of the trace's kernel, memcpy and
    memset intervals), idle share and device time by kernel class."""
    dev = device_events(events)
    busy = union_us(dev)
    span = (max(e["ts"] + e["dur"] for e in dev)
            - min(e["ts"] for e in dev))
    by_class = {}
    for e in dev:
        name = (e.get("cat", "") + " " + e.get("name", "")).lower()
        cls = next((c for c, keys in KERNEL_CLASSES
                    if any(k in name for k in keys)), "elementwise/other")
        by_class[cls] = by_class.get(cls, 0.0) + e["dur"]
    total = sum(by_class.values())
    shares = ", ".join(f"{c} {t / total * 100:.1f}%" for c, t in sorted(
        by_class.items(), key=lambda kv: -kv[1]))
    return (f"wall {wall:.2f} ms (traced), GPU span {span / 1e3:.2f} ms, "
            f"device busy {busy / 1e3:.2f} ms, idle "
            f"{(1 - busy / span) * 100:.1f}% of the span; {len(dev)} device "
            f"events; device time by class: {shares}")


def phase_trace(step, batch, gen):
    """Two traced train steps. The first: no SDPA op may appear, and the
    device time is broken down by kernel class. The second records input
    shapes (which slows the host, so it is not used for the idle share) to
    name the op behind each of the largest kernels."""
    step(batch, gen)
    torch.cuda.synchronize()
    wall, names, events = trace_call(lambda: step(batch, gen))
    sdpa = sorted(n for n in names if n.startswith(
        ("aten::_scaled_dot_product", "aten::_efficient_attention")))
    check(not sdpa, f"SDPA ops in the train step: {sdpa}")
    dev = device_events(events)
    per_step = [sum(key in e["name"] for e in dev)
                for key in ("flash_fwd_wgmma", "flash_bwd_wgmma")]
    check(per_step == [12, 12], f"K1, K2 kernels in a traced step: {per_step}")
    print(f"train step trace: {device_summary(wall, events)}; K1 and K2 12 "
          f"kernels each; no SDPA op [{card_line()}]")

    _, _, events = trace_call(lambda: step(batch, gen), record_shapes=True)
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


def phase_train_timing(step, batch, gen, warmup=2, n=5, label="train"):
    """Host ms of ``n`` steps after ``warmup``; prints and returns the
    median."""
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
    print(f"{label} step b=8 s=1024 dropout 0.1: median {med:.2f} ms (min "
          f"{min(times):.2f}, max {max(times):.2f}, {n} steps after "
          f"{warmup} warm-ups), {8 * 1024 / med * 1e3:.0f} tokens/s "
          f"[{card_line()}]")
    return med


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


# ---------------------------------------------------------------- phase 6

# name: (b, h, s, d, cell mask, causal, dropout_p, valid keys of batch row 0
# or None)
BS_SHAPES = {
    # (i) the GPT-2 training step's attention
    "(i) GPT-2 train": (8, 12, 1024, 64, "local-global", True, 0.1, None),
    # (ii) benchmarks/benchmark_baseline_configs.py config4
    "(ii) config 4": (1, 8, 8192, 64, "config4", True, 0.0, None),
    # (iii) every tile FULL, keys >= 300 of batch row 0 padded (C9)
    "(iii) padding on full tiles": (2, 4, 512, 64, "ones", False, 0.0, 300),
    # (iv) ragged s (not a multiple of 16 rows or 256 columns), d=128
    "(iv) ragged, d=128": (2, 4, 600, 128, "random", False, 0.1, None),
}


def gpt2_bs_layout(s=1024):
    """The GPT-2 training mask: LocalGlobalSparsityConfig(window=256) (one
    global cell column, 16 global cell rows), causal."""
    return build_layout(LocalGlobalSparsityConfig(window=256).make_layout(s),
                        sq=s, sk=s, causal=True)


def bs_inputs(gen, shape):
    """q, k, v, dout (b, h, s, d) bf16, the layout, q_valid, k_valid and
    dropout_p of BS_SHAPES[shape]. Config 4 draws q, k, v and then its 25%
    cell mask from numpy's default_rng(0), as the benchmark does."""
    b, h, s, d, cells, causal, p, valid = BS_SHAPES[shape]
    if cells == "config4":
        rng = np.random.default_rng(0)
        q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, d))).to(
            DEV, BF16).transpose(1, 2).contiguous() for _ in range(3))
        bm = rng.random((s // 16, s // 256)) < 0.25
    else:
        q, k, v = (randn(gen, (b, h, s, d)) for _ in range(3))
        n = (-(-s // 16), -(-s // 256))
        bm = {"local-global": lambda: LocalGlobalSparsityConfig(
                  window=256).make_layout(s),
              "ones": lambda: np.ones(n, bool),
              "random": lambda: np.random.default_rng(s).random(n) < 0.35,
              }[cells]()
    layout = build_layout(bm, sq=s, sk=s, causal=causal)
    q_valid = k_valid = None
    if valid is not None:
        k_valid = torch.ones((b, s), dtype=torch.uint8, device=DEV)
        k_valid[0, valid:] = 0
        q_valid = k_valid.clone()
    return q, k, v, randn(gen, (b, h, s, d)), layout, q_valid, k_valid, p


def bs_oracle(q, k, v, dout, ref, upcast):
    """out and dq, dk, dv of attention_ref with the element mask, dropout
    mask and p in ``ref``, by autograd."""
    leaves = [(x.float() if upcast else x).detach().requires_grad_()
              for x in (q, k, v)]
    out = attention_ref(*leaves, upcast=upcast, **ref)
    out.backward(dout.to(out.dtype))
    return out.detach(), [x.grad for x in leaves]


def phase_blocksparse_kernels(gen, errs):
    """K8a, K8b and K8c at BS_SHAPES against their twins and, by the 2x
    rule, the fp32 oracle attention_ref(mask=...) (gradients by autograd,
    atol 1e-4); bf16. Rows that see nothing give 0 and lse -inf. Adds the
    max errors vs the twins to ``errs``."""
    for name in BS_KERNELS:
        errs[name] = 0.0
    for shape, (b, h, s, d, _, _, p, valid) in BS_SHAPES.items():
        q, k, v, dout, layout, qv, kv, p = bs_inputs(gen, shape)
        kw = dict(softmax_scale=d ** -0.5, dropout_p=p,
                  seed=SEED if p else None)
        out, lse = blocksparse_attention_fwd(q, k, v, layout, qv, kv, **kw)
        grads = blocksparse_attention_bwd(q, k, v, out, dout, lse, layout,
                                          qv, kv, **kw)
        torch.cuda.synchronize()
        twin, twin_lse = blocksparse_attention_fwd_plain(q, k, v, layout, qv,
                                                         kv, **kw)
        di = (out.float() * dout.float()).sum(-1)
        twins = blocksparse_attention_bwd_plain(q, k, v, dout, lse, di,
                                                layout, qv, kv, **kw)
        mask = visible_plain(layout, qv, kv, DEV)
        keep = dropout_mask_dense(SEED, b, h, s, s, p, device=DEV) if p \
            else None
        ref = dict(mask=mask, dropout_mask=keep, dropout_p=p)
        out32, oracle = bs_oracle(q, k, v, dout, ref, True)
        out16, native = bs_oracle(q, k, v, dout, ref, False)
        label = f"blocksparse {shape}"
        err, base = assert_two_x_bound(out, out32, out16, label=label)
        dead = ~mask.any(-1).expand(b, h, s)
        check(not out[dead].any() and bool(torch.isneginf(lse[dead]).all()),
              f"{label}: rows that see nothing")
        check(torch.equal(torch.isneginf(lse), torch.isneginf(twin_lse))
              and max_err(lse[~dead], twin_lse[~dead]) < 1e-3,
              f"{label}: lse vs twin")
        if valid is not None:  # C9: padded keys of full tiles unseen
            check(bool(layout.kv_full.all()), f"{label}: a tile not FULL")
        errs["blocksparse_fwd"] = max(errs["blocksparse_fwd"],
                                      max_err(out, twin))
        parts = []
        for g_name, g, tw, o, n in zip("qkv", grads, twins, oracle, native):
            e, be = assert_two_x_bound(g, o, n, atol=1e-4,
                                       label=f"{label} d{g_name}")
            kernel = "blocksparse_dq" if g_name == "q" else "blocksparse_dkv"
            errs[kernel] = max(errs[kernel], max_err(g, tw))
            parts.append(f"d{g_name} {e:.3e} ({be:.3e})")
        print(f"{label} b={b} h={h} s={s} d={d} causal={layout.causal} "
              f"p={p}: {int(mask.expand(b, 1, s, s).sum()) * h} visible "
              f"pairs, "
              f"{int(layout.kv_counts.sum())} live and "
              f"{int(layout.kv_full.sum())} full 64x64 tiles; out err vs "
              f"fp32 {err:.3e} (bf16 baseline {base:.3e}); grads "
              f"{', '.join(parts)}; vs twins fwd {max_err(out, twin):.3e}")
        del q, k, v, dout, out, lse, grads, twin, twins, oracle, native, mask
        torch.cuda.empty_cache()


def bs_attn_impl(layout, dropout_p):
    """GPT-2's ``attn_impl``: causal blocksparse attention over ``layout``,
    with dropout when the block passes a seed."""
    def attn(q, k, v, dropout_seed=None):
        return blocksparse_attention(
            q, k, v, layout, causal=True, dropout_seed=dropout_seed,
            dropout_p=0.0 if dropout_seed is None else dropout_p)
    return attn


def phase_blocksparse_train(n_steps=4):
    """The blocksparse training path: GPT2Config(dropout=0.1) at full
    width, attn_impl = causal blocksparse attention over gpt2_bs_layout(),
    n_steps AdamW steps on the train batch. Each step launches K8a, K8b and
    K8c once per layer and no dense attention kernel; a traced step holds no
    K1, K2 or SDPA kernel. Returns (launches, median step ms)."""
    cfg = GPT2Config(dropout=0.1)
    batch = train_batch(cfg)
    model = train_model(cfg, bs_attn_impl(gpt2_bs_layout(), cfg.dropout))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    step = make_train_step(model, opt)
    gen = torch.Generator().manual_seed(0)
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
    for name in BS_KERNELS:
        check(launches[name] == cfg.n_layer * n_steps,
              f"{name}: {launches[name]} launches in {n_steps} steps, want "
              f"{cfg.n_layer} per step")
    for name in TRAIN_KERNELS:
        check(launches[name] == 0, f"blocksparse training launched {name}")
    print(f"blocksparse train: GPT-2 full width, b=8 s=1024, dropout 0.1, "
          f"LocalGlobalSparsityConfig(window=256) causal, {n_steps} AdamW "
          f"steps in {dt:.2f} s; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}")

    wall, names, events = trace_call(lambda: step(batch, gen))
    sdpa = sorted(n for n in names if n.startswith(
        ("aten::_scaled_dot_product", "aten::_efficient_attention",
         "aten::_flash_attention")))
    dense = sorted({e["name"][:60] for e in device_events(events) if any(
        key in e["name"] for key in ("flash_fwd", "flash_bwd", "bwd_stats",
                                     "bwd_dq_kernel", "fmha", "sdpa"))})
    check(not sdpa and not dense,
          f"dense attention in the blocksparse step: {sdpa} {dense}")
    print(f"blocksparse train step trace: {device_summary(wall, events)}; "
          f"no K1, K2 or SDPA kernel [{card_line()}]")
    med = phase_train_timing(step, batch, gen, warmup=1,
                             label="blocksparse train")
    return launches, med


def masked_reference(mask, upcast):
    """attn_impl over attention_ref with an element mask, differentiable by
    autograd: fp32 (``upcast``) or in the input dtype."""
    def attn(q, k, v, dropout_seed=None):
        def tr(x):
            return x.transpose(1, 2)

        return tr(attention_ref(tr(q), tr(k), tr(v), mask=mask,
                                upcast=upcast))
    return attn


def phase_blocksparse_train_check(batch):
    """One step at dropout 0 through blocksparse attention, its loss and
    global gradient norm: the bf16 model through K8a-c against the same
    step in fp32 compute with attention through the fp32 masked
    attention_ref (no port kernel on that side), by the 2x rule. Baseline:
    the bf16 model through the bf16 masked attention_ref. The floor, 1e-6
    of the fp32 value, is fp32 rounding, far under the bf16 baseline. The
    check has power: the fp32 step with plain causal attention lies outside
    the bound it sets, in the loss or the gradient norm."""
    layout = gpt2_bs_layout()
    mask = layout.visible(DEV)
    model16 = train_model(GPT2Config(), bs_attn_impl(layout, 0.0))
    got = loss_and_grad_norm(model16, batch)
    for block in model16.h:
        block.attn_impl = masked_reference(mask, upcast=False)
    base = loss_and_grad_norm(model16, batch)
    del model16
    torch.cuda.empty_cache()
    model32 = train_model(GPT2Config(dtype=torch.float32),
                          masked_reference(mask, upcast=True))
    want = loss_and_grad_norm(model32, batch)
    for block in model32.h:
        block.attn_impl = masked_reference(torch.ones_like(mask).tril(),
                                           upcast=True)
    causal = loss_and_grad_norm(model32, batch)
    del model32
    torch.cuda.empty_cache()
    apart = []
    for i, what in enumerate(("loss", "grad norm")):
        atol = 1e-6 * float(want[i].abs())
        err, b = assert_two_x_bound(got[i], want[i], base[i], atol=atol,
                                    label=f"blocksparse train step {what}")
        sep = max_err(causal[i], want[i])
        apart.append(sep > 2 * b + atol)
        print(f"blocksparse train step at dropout 0, {what}: bf16 + K8 "
              f"{float(got[i]):.6f}, fp32 + masked attention_ref "
              f"{float(want[i]):.6f}, bf16 + masked attention_ref "
              f"{float(base[i]):.6f}: err {err:.3e} (bf16 baseline {b:.3e}, "
              f"bound {2 * b + atol:.3e}); fp32 + causal attention_ref "
              f"{float(causal[i]):.6f}, {sep:.3e} from the masked step")
    check(any(apart), "the blocksparse train check cannot tell the mask "
          "from causal attention")


def bs_timing_specs(gen):
    """kernel_timing rows of K8a, K8b and K8c at BS_SHAPES (i) and (ii),
    and of dense K1 and K2 at shape (ii) (at shape (i) they are the train
    step's rows). Library: SDPA with the element mask as attn_mask, its
    forward, and its backward for (k, v) and for q."""
    specs = {}
    for shape, suffix in (("(i) GPT-2 train", ""),
                          ("(ii) config 4", " (config 4)")):
        q, k, v, dout, layout, _, _, p = bs_inputs(gen, shape)
        b, h, s, d = q.shape
        kw = dict(softmax_scale=d ** -0.5, dropout_p=p,
                  seed=SEED if p else None)
        out, lse = blocksparse_attention_fwd(q, k, v, layout, **kw)
        di = (out.float() * dout.float()).sum(-1)
        mask = layout.visible(DEV)
        pairs = int(mask.sum()) * b * h
        lay = layout.on(DEV)
        q_lists = nbytes(lay["q_indices"], lay["q_counts"], lay["q_full"],
                         lay["rowmask"])
        kv_lists = nbytes(lay["kv_indices"], lay["kv_counts"],
                          lay["kv_full"], lay["rowmask"])
        bwd = (q, k, v, dout, lse, di, layout)

        def plain_bwd(a=bwd, kw=kw):
            return blocksparse_attention_bwd_plain(*a, **kw)

        specs["blocksparse_fwd" + suffix] = (
            lambda a=(q, k, v, layout), kw=kw:
                blocksparse_attention_fwd(*a, **kw),
            lambda a=(q, k, v, layout), kw=kw:
                blocksparse_attention_fwd_plain(*a, **kw),
            sdpa_fwd(q, k, v, p=p, mask=mask),
            nbytes(q, k, v, q, lse) + kv_lists, 4 * pairs * d)
        specs["blocksparse_dkv" + suffix] = (
            lambda a=bwd, kw=kw: blocksparse_attention_dkv(*a, **kw),
            plain_bwd,
            sdpa_bwd(q, k, v, dout, p=p, mask=mask, wrt="kv"),
            nbytes(q, k, v, dout, lse, di, k, v) + q_lists, 8 * pairs * d)
        specs["blocksparse_dq" + suffix] = (
            lambda a=bwd, kw=kw: blocksparse_attention_dq(*a, **kw),
            plain_bwd,
            sdpa_bwd(q, k, v, dout, p=p, mask=mask, wrt="q"),
            nbytes(q, k, v, dout, lse, di, q) + kv_lists, 6 * pairs * d)
    # Dense K1 and K2 on config 4's q, k, v: does the sparsity pay?
    dense = dict(causal=True, softmax_scale=d ** -0.5)
    o_dense, l_dense = flash_attention_fwd(q, k, v, save_lse=True, **dense)
    specs["flash_fwd (config 4 shape, dense)"] = (
        lambda: flash_attention_fwd(q, k, v, save_lse=True, **dense),
        lambda: flash_attention_fwd_plain(q, k, v, save_lse=True, **dense),
        sdpa_fwd(q, k, v), nbytes(q, k, v, q, l_dense),
        4 * b * h * causal_pairs(s) * d)
    specs["flash_bwd (config 4 shape, dense)"] = (
        lambda: flash_attention_bwd(q, k, v, o_dense, dout, l_dense, **dense),
        lambda: flash_attention_bwd_plain(q, k, v, o_dense, dout, l_dense,
                                          **dense),
        sdpa_bwd(q, k, v, dout), nbytes(q, k, v, o_dense, dout, l_dense, q, k,
                                        v),
        10 * b * h * causal_pairs(s) * d)
    return specs


def print_sparsity_pays(times):
    """K8 against dense K1/K2 on the same inputs, at both shapes."""
    def ms(name):
        return times[name][0]

    for label, suffix, fwd, bwd in (
            ("(i) GPT-2 train, dropout 0.1", "",
             "flash_fwd (train step, dropout 0.1, lse)", "flash_bwd"),
            ("(ii) config 4", " (config 4)",
             "flash_fwd (config 4 shape, dense)",
             "flash_bwd (config 4 shape, dense)")):
        k8_bwd = ms("blocksparse_dkv" + suffix) + ms("blocksparse_dq" + suffix)
        print(f"sparsity at {label}: K8a {ms('blocksparse_fwd' + suffix):.4f}"
              f" ms vs dense K1 {ms(fwd):.4f} ms; K8b + K8c {k8_bwd:.4f} ms "
              f"vs dense K2 {ms(bwd):.4f} ms [{card_line()}]")


def main():
    phase_device()
    phase_build_report()
    gen = torch.Generator(device=DEV).manual_seed(0)
    rng = np.random.default_rng(0)
    errs = phase_kernels(gen)
    phase_chunk_kernels(gen, errs)
    phase_train_kernels(gen, errs)
    phase_determinism(gen)

    # Serving GPT-2: full width, weights stored in bf16 (the serving dtype).
    cfg = GPT2Config(param_dtype=BF16)
    model = GPT2LMHeadModel(cfg, device=DEV,
                            generator=torch.Generator(device=DEV).manual_seed(0))
    model32 = gpt2_fp32(model)
    launches = {"serve": phase_serve(model, cfg, rng)}
    phase_teacher_forcing(model, cfg, model32, rng)
    launches["serve_chunked"] = phase_serve_chunked(model, cfg, model32, rng)
    launches["speculative"] = phase_speculative(model, cfg, model32, rng)
    phase_timing(model, cfg, rng)
    del model, model32
    torch.cuda.empty_cache()

    launches["train"], step, batch, dgen, *held = phase_train()
    phase_trace(step, batch, dgen)
    dense_ms = phase_train_timing(step, batch, dgen)
    del step, held
    torch.cuda.empty_cache()
    phase_train_check(batch)
    torch.cuda.empty_cache()

    phase_blocksparse_kernels(gen, errs)
    launches["blocksparse_train"], bs_ms = phase_blocksparse_train()
    print(f"train step medians in this run: blocksparse {bs_ms:.2f} ms, "
          f"dense {dense_ms:.2f} ms [{card_line()}]")
    torch.cuda.empty_cache()
    phase_blocksparse_train_check(batch)
    torch.cuda.empty_cache()

    launches["llama_chunked"] = phase_llama(rng)
    times = kernel_timing(gen)

    kernels = []
    for name, (_, src, tpu) in KERNELS.items():
        ms, plain_ms, lib_ms, b_ms, b_by, backend = times[name]
        by_path = {path: counts[name] for path, counts in launches.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library_backend": backend})
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
