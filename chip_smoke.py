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
    round's logits held to the 2x rule; one verify round timed;
  - the cache appends of decode (K7a) and verification (K7b) run inside
    the paged attention launch that reads them (K5, K6): each path must
    launch no standalone append, and the fused kernels must equal the
    standalone append followed by K5 / K6 bit for bit at GPT-2's and
    Llama-3-8B's decode shapes and at verification; a traced GPT-2 decode
    window must show no copy kernel between a layer's qkv projection and
    K5;
  - chunked serving, Llama-3-8B's published widths (32 layers, GQA 32/8,
    head_dim 128, bf16): 8 requests (prompts 300..4000) with
    prefill_chunk=512, and a 1500-token prompt in three chunks + 16 decode
    steps held to the 2x rule against the same weights in fp32;
  - training: 6 AdamW steps of GPT2Config(dropout=0.1) (fp32 weights,
    bf16 compute) on one b=8, s=1024 batch, with falling finite loss, K1
    and K2 launched 12 times per step and no SDPA op in a traced step; one
    step at dropout 0 held to the 2x rule against fp32 compute;
  - BERT training with padding masks: 4 AdamW steps of
    BertForMaskedLM(BertConfig(dtype=bf16)) at BERT-base's published
    width (12 layers, 12 heads, 768 wide, intermediate 3072, vocab 30522,
    512 positions; fp32 weights) on one b=32, s=512 batch whose row
    lengths are drawn uniformly in [171, 512], 15% of the real tokens
    carrying MLM labels, dropout 0.1: falling finite loss, K1 and K2
    launched 12 times per step each in their segment form (padding masked
    inside the kernels by segment ids; no unpad), no SDPA op in a traced
    step, one dropout-0 step held to the 2x rule against fp32 compute;
  - GPT-2 remat policies: one backward each with remat off, full remat,
    "dots" and "dots_flash" on the training phase's model and batch: the
    same loss, every gradient within the 2x rule of the no-remat step
    against fp32 compute, K1 launched 12, 24, 24 and 12 times (under
    "dots_flash" its output and lse are kept), a timed step each;
  - ViT training: 4 AdamW steps of ViTClassifier(ViTConfig(dtype=bf16))
    at ViT-B/16's published widths (224/16, 12 layers x 768, 12 heads,
    MLP 3072, 1000 classes, 2-D rotary; fp32 weights) on b=64 seeded
    random images, dropout 0.1: falling finite loss, K1 and K2 12 times per
    step each (non-causal over 196 tokens), no SDPA op in a traced step,
    one dropout-0 step held to the 2x rule against fp32 compute;
  - Llama training at Llama-3-8B's widths cut to 2 layers (fp32 weights,
    about 1.5 B parameters, bf16 compute), b=4 s=2048, the head and loss
    in chunks of 512: 3 AdamW steps with falling finite loss, K1 and K2
    twice per step; at the same weights remat gives the same loss and
    gradient norm and 4 K1 launches; a traced and timed step each way;
  - sliding windows (M4): Mistral-7B-v0.1's published widths and depth
    (7.24 B parameters, bf16, window 4096) serving 8 requests (prompts
    1000..7000) chunked with and without streaming page release (the same
    tokens; pages freed and peak pages printed), a 5000-token prompt held
    to the 2x rule against fp32, no SDPA op in a traced admission or
    decode step; its widths cut to 2 layers training 3 steps at b=2
    s=8192 (windowed K1 + K2 twice a step, a step held to fp32 compute);
    GPT-2 decoding with a 256 window and 4 StreamingLLM sinks against a
    dense band-plus-sinks reference.
K1 and K2 with windows, sinks, ALiBi and softcap (bf16 and fp32, the
segment form included) and K5 and K6 with the same terms at Mistral's
decode and chunk shapes are held to their twins and the 2x rule; K5 and
K6 are run again with every page wholly below the band set to NaN (bit
for bit the same output), and 10 reruns of the windowed K2 with sinks
agree bit for bit.
K1 and K2 in segment form are held to their twins and the 2x rule at
BERT's attention shape (b=32 h=12 s=512 d=64), and the cu_seqlens
interface on the same tokens packed (qkvpacked; kvpacked with per-sequence
sq != sk, causal) against the padded segment-id route.
K1 and K2 are held to their twins and the 2x rule at the attention shapes
of every training path (GPT-2, ViT-B/16, the Llama train step), before
the paths run.
The Llama serving chain's kernels (residual add + RMSNorm, QK-norm +
rotary, SwiGLU: kernels/llama_chain.py) are held to their twins and the
2x rule at Mistral-7B's widths (longdoc's chunk of 8 x 512 tokens and its
64-row decode step) and at Qwen3-30B-A3B's (a 512-token chunk and its
32-row decode step, with QK-norm and the routed experts' strided SwiGLU
halves), and timed there beside their byte bound and twin (the
``llama_chain`` JSON line); the Llama serving paths must launch them 2L +
1 / L / L times a phase call, and the training forward not at all.
A determinism phase requires 10 seeded reruns to agree bit for bit: K1 + K2
at GPT-2's, ViT-B/16's and the Llama train step's shapes and in segment
form at BERT's shape,
K8a-c at BS_SHAPES (i), K5 and K6 at
Llama-3-8B's decode and chunk shapes, and K5 and K6 with the append at
Llama's decode and at the verify shape; each paged shape prints the split
count the host chose for it.
It prints ptxas's registers and spills, the dynamic shared memory and the
HGMMA (wgmma) instructions of the Hopper kernels K1, K2, K5, K6 and K8a-c,
and times both paths and every kernel against its twin and, where one
exists, a PyTorch call computing the same function (SDPA under each of its
flash, cuDNN and efficient backends pinned in turn, the fastest reported;
index_copy_ or index_put_ for the cache writes), all by device busy time
in a profiler trace (dense_timing.busy_ms), since the host can issue a call
more slowly than the card runs the shortest ones; the host's time to
issue a kernel call is printed beside. The step traces (train steps, the
Llama admission and decode) take the same guard against dropped device
events (dense_timing.trace_call). Any failed check raises and
the exit code is nonzero. Without CUDA it exits nonzero
and prints no result. Output, in order: the card and toolchain, per-phase
lines, the kernels' JSON line, the card's name and power limit, and as the
last line {"ok": true, "device": {...}}. Each phase prints its own
time on the host clock (``phase ...: N s``).
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import re
import shutil
import contextlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dense_timing import (
    APPEND_SHAPES,
    MISTRAL_TRAIN,
    MISTRAL_WINDOW,
    ROTATE,
    append_inputs,
    band_pairs,
    bert_lengths,
    bert_padding,
    busy_ms,
    decode_window,
    device_events,
    host_ms,
    k7c_inputs,
    k8b_inputs,
    rotating,
    trace_call,
    union_us,
    window_inputs,
)
from flash_attn_tpu_torch import flash_attention
from flash_attn_tpu_torch.kernels import _build, llama_chain
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
from flash_attn_tpu_torch.kernels.common import (
    Band,
    Segments,
    paged_live_span,
    paged_num_splits,
    segment_mask,
    segment_plan,
    sm_count,
)
from flash_attn_tpu_torch.kernels.decode import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_with_append,
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
from flash_attn_tpu_torch.models import llama as llama_module
from flash_attn_tpu_torch.models.bert import (
    BertConfig,
    BertForMaskedLM,
    make_train_step as make_bert_step,
    mlm_loss,
)
from flash_attn_tpu_torch.models.blocksparse_modules import (
    LocalGlobalSparsityConfig,
)
from flash_attn_tpu_torch.models.gpt2 import (
    GPT2Config,
    GPT2LMHeadModel,
    chunked_lm_loss,
    cross_entropy_loss,
    make_train_step,
)
from flash_attn_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    make_train_step as make_llama_step,
)
from flash_attn_tpu_torch.models.vit import (
    ViTClassifier,
    ViTConfig,
    classification_loss,
    make_train_step as make_vit_step,
)
from flash_attn_tpu_torch.ops.attention import alibi_slopes
from flash_attn_tpu_torch.ops.blocksparse import blocksparse_attention
from flash_attn_tpu_torch.ops.interface import (
    flash_attn_unpadded_kvpacked_func,
    flash_attn_unpadded_qkvpacked_func,
)
from flash_attn_tpu_torch.ops.packing import (
    cu_seqlens_to_segments,
    pad_input,
    unpad_input,
)
from flash_attn_tpu_torch.reference import (
    alibi_bias,
    attention_ref,
    build_mask,
    paged_chunk_ref,
)
from flash_attn_tpu_torch.serving import cache
from flash_attn_tpu_torch.serving.engine import ServingEngine
from flash_attn_tpu_torch.serving.kvcache import flash_attn_with_kvcache
from flash_attn_tpu_torch.serving.speculative import (
    score_chunk,
    speculative_decode,
)
from flash_attn_tpu_torch.utils.testing import (
    assert_two_x_bound,
    max_err,
    packed_views,
)

DEV = torch.device("cuda")
BF16 = torch.bfloat16
def counter(fn, attr="launches"):
    """A wrapper's launch counter: the attribute ``attr`` of ``fn``."""
    return (fn, attr)


# The appends that run inside K5's and K6's launches on the serving paths.
FUSED_K7A = counter(paged_decode_with_append)
FUSED_K7B = counter(paged_chunk_attention, "append_launches")
KERNELS = {
    # name: (counters of its launches, source, TPU kernel it replaces)
    "flash_fwd": ((counter(flash_attention_fwd),),
                  "flash_attn_tpu_torch/csrc/flash_fwd.cu",
                  "flash_attn_tpu/kernels/flash_fwd.py:104"),
    "flash_bwd": ((counter(flash_attention_bwd),),
                  "flash_attn_tpu_torch/csrc/flash_bwd.cu",
                  "flash_attn_tpu/kernels/flash_bwd.py:106"),
    "paged_decode": ((counter(paged_decode_attention), FUSED_K7A),
                     "flash_attn_tpu_torch/csrc/paged_decode.cu",
                     "flash_attn_tpu/kernels/decode.py:50"),
    # K7a and K7b: their appends inside K5 / K6, and the standalone kernels
    "append_token": ((FUSED_K7A, counter(cache.append_token)),
                     "flash_attn_tpu_torch/csrc/cache_write.cu",
                     "flash_attn_tpu/serving/cache.py:94"),
    "write_pages": ((counter(cache._write_prompts),),
                    "flash_attn_tpu_torch/csrc/cache_write.cu",
                    "flash_attn_tpu/serving/cache.py:460"),
    "paged_chunk": ((counter(paged_chunk_attention),),
                    "flash_attn_tpu_torch/csrc/paged_chunk.cu",
                    "flash_attn_tpu/kernels/chunk.py:61"),
    "append_span": ((FUSED_K7B, counter(cache.append_span)),
                    "flash_attn_tpu_torch/csrc/cache_write.cu",
                    "flash_attn_tpu/serving/cache.py:250"),
    "blocksparse_fwd": ((counter(blocksparse_attention_fwd),),
                        "flash_attn_tpu_torch/csrc/blocksparse_fwd.cu",
                        "flash_attn_tpu/kernels/blocksparse.py:537"),
    "blocksparse_dkv": ((counter(blocksparse_attention_dkv),),
                        "flash_attn_tpu_torch/csrc/blocksparse_bwd.cu",
                        "flash_attn_tpu/kernels/blocksparse.py:855"),
    "blocksparse_dq": ((counter(blocksparse_attention_dq),),
                       "flash_attn_tpu_torch/csrc/blocksparse_bwd.cu",
                       "flash_attn_tpu/kernels/blocksparse.py:988"),
    # the Llama serving chain, which XLA fuses on the TPU
    "add_rmsnorm": ((counter(llama_chain.add_rmsnorm),),
                    "flash_attn_tpu_torch/csrc/llama_chain.cu",
                    "none (XLA fusion)"),
    "qk_rope": ((counter(llama_chain.qk_rope),),
                "flash_attn_tpu_torch/csrc/llama_chain.cu",
                "none (XLA fusion)"),
    "swiglu": ((counter(llama_chain.swiglu),),
               "flash_attn_tpu_torch/csrc/llama_chain.cu",
               "none (XLA fusion)"),
}
# Counts that are not a kernel's own: the standalone appends, the fused
# appends, and flash_attn_with_kvcache's two-launch route past one row
# tile.
SIDE_COUNTS = {
    "append_token standalone": counter(cache.append_token),
    "append_span standalone": counter(cache.append_span),
    "append_token in K5": FUSED_K7A,
    "append_span in K6": FUSED_K7B,
    "kvcache split_appends": counter(flash_attn_with_kvcache,
                                     "split_appends"),
    # the tile plan of K1/K2's segment form (csrc/segments.cu): made once
    # per attention call by the forward and reused by the backward
    "segment plan": counter(segment_plan),
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
# BERT-base (google-research/bert BERT-Base: 12 layers, 12 heads, hidden
# 768, intermediate 3072, vocab 30522, 512 positions), bf16 compute over
# fp32 weights; one b=32 x s=512 batch.
BERT_BASE = BertConfig(dtype=BF16)
BERT_B, BERT_S = 32, 512


@contextlib.contextmanager
def phase_time(label):
    """Prints the host-clock seconds of the phase it wraps."""
    t0 = time.perf_counter()
    yield
    print(f"phase {label}: {time.perf_counter() - t0:.1f} s")


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


def sdpa_fastest(make, n=10):
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
            times[name] = busy_ms(fn, n=n)
    ok = {k: v for k, v in times.items() if v is not None}
    check(ok, "no SDPA backend accepts the library call")
    best = min(ok, key=ok.get)
    return ok[best], best, times


def reset_launches():
    for counters, _, _ in KERNELS.values():
        for fn, attr in counters:
            setattr(fn, attr, 0)
    for fn, attr in SIDE_COUNTS.values():
        setattr(fn, attr, 0)


def read_launches(names):
    """{kernel: launches} for ``names``, and SIDE_COUNTS."""
    counts = {name: sum(getattr(fn, attr) for fn, attr in KERNELS[name][0])
              for name in names}
    return {**counts, **{name: getattr(fn, attr)
                         for name, (fn, attr) in SIDE_COUNTS.items()}}


def check_fused_appends(label, launches, decode=False, verify=False):
    """A serving path appended only inside K5's (decode) and K6's
    (verification) launches: every K5 launch appended, no standalone
    append ran."""
    if decode:
        check(launches["append_token standalone"] == 0
              and launches["append_token in K5"] == launches["paged_decode"]
              > 0, f"{label}: decode appends outside K5: {launches}")
    if verify:
        check(launches["append_span standalone"] == 0
              and launches["kvcache split_appends"] == 0
              and launches["append_span in K6"] == launches["paged_chunk"]
              > 0,
              f"{label}: verification appends outside K6: {launches}")


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
            "paged_chunk_wgmma": "K6", "paged_merge_kernel": "K5/K6 merge",
            "bs_fwd_wgmma": "K8a", "bs_dkv_wgmma": "K8b",
            "bs_dq_wgmma": "K8c"}


def kernel_label(mangled: str) -> str | None:
    """'K1 bf16 d=64' for a mangled name of a REPORTED kernel, else None."""
    kernel = next((v for k, v in REPORTED.items() if k in mangled), None)
    if kernel is None:
        return None
    dtype = ("bf16" if "nv_bfloat16" in mangled else
             "fp16" if "half" in mangled else "fp32")
    # The template arguments after the dtype: K1 <D, kSeg, kBand>, K2 <D,
    # kSeg, kTerms>, K5/K6 <D, kAppend, kBand> (K5's fp32 kernel <D,
    # kAppend>).
    d, *terms = re.findall(r"Li(\d+)E", mangled)
    flags = re.findall(r"Lb([01])E", mangled)
    form = ""
    if flags[:1] == ["1"]:
        form = " segments" if kernel in ("K1", "K2") else " with the append"
    if flags[1:2] == ["1"] or terms[:1] == ["1"]:
        form += " band"
    elif terms[:1] == ["2"]:
        form += " band+softcap"
    return f"{kernel} {dtype} d={d}{form}"


def phase_build_report():
    """Evidence of what the Hopper kernels K1, K2, K5, K6 and K8a-c were
    built into: ptxas's registers and spills (-Xptxas -v at build), their
    dynamic shared memory, and, where cuobjdump exists, the HGMMA (wgmma)
    instructions of K1's and K2's (dense and segment form), K6's (alone and
    with the append) and K8a-c's bf16/fp16 kernels in the SASS."""
    lib = _build.lib()
    print("dynamic shared memory: " + ", ".join(
        f"K1 d={d} {lib.fattn_flash_fwd_smem(d)} B, K2 d={d} "
        f"{lib.fattn_flash_bwd_smem(d)} B, K5 d={d} "
        f"{lib.fattn_paged_decode_smem(d)} B, K6 d={d} "
        f"{lib.fattn_paged_chunk_smem(d)} B, K8a d={d} "
        f"{lib.fattn_blocksparse_fwd_smem(d)} B, K8b d={d} "
        f"{lib.fattn_blocksparse_dkv_smem(d)} B, K8c d={d} "
        f"{lib.fattn_blocksparse_dq_smem(d)} B" for d in (64, 128)))
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
    check(len(counts) == 68 and all(counts.values()),
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
        # A chunk of every row of a batch of 8 in one launch (GPT-2's 256
        # tokens as views of the fused projection, Llama's 512 contiguous, as
        # chunk_prefill_step passes them): shuffled pages, row 6's list
        # padded with page 0, row 7 all padding.
        chunk = 256 if h == 12 else 512
        per_row = chunk // ps
        tbl = torch.randperm(64, generator=torch.Generator().manual_seed(d))
        tbl = (tbl[: 8 * per_row] + 1).reshape(8, per_row).to(torch.int32)
        tbl[6, per_row // 2:] = 0
        tbl[7] = 0
        tbl = tbl.to(DEV)
        if h == 12:
            _, kb, vb = randn(gen, (8, chunk, 3, h, d)).unbind(2)
        else:
            kb, vb = randn(gen, (8, chunk, h, d)), randn(gen, (8, chunk, h, d))
        cache._write_prompts(on_card, kb, vb, tbl)
        cache._write_prompts_plain(plain, kb, vb, tbl)
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
        print(f"write_pages (8 rows x {chunk} tokens in one launch, then "
              f"one 700-token prompt) + append_token h_kv={h} d={d}: bitwise "
              "equal to the twins outside page 0")
    errs["write_pages"] = errs["append_token"] = 0.0
    return errs


# (b, h, h_kv, s, d, dropout_p, causal): the GPT-2 train step's attention,
# then ragged, GQA 12/4 and head_dim 128; ViT-B/16's (non-causal over 196
# patches: the last q and key tiles cut at the edge); the Llama-3-8B-width
# train step's (GQA 32/8, d=128, s=2048).
TRAIN_KERNEL_CASES = [
    (8, 12, 12, 1024, 64, 0.0, True), (8, 12, 12, 1024, 64, 0.1, True),
    (8, 12, 12, 1000, 64, 0.1, True), (8, 12, 4, 1024, 64, 0.1, True),
    (8, 6, 6, 1024, 128, 0.1, True),
    (64, 12, 12, 196, 64, 0.0, False), (64, 12, 12, 196, 64, 0.1, False),
    (4, 32, 8, 2048, 128, 0.0, True),
]


def ref_grads(q, k, v, dout, keep, p, upcast, causal=True):
    """dq, dk, dv of attention_ref by autograd (dropout mask ``keep``)."""
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = attention_ref(*leaves, causal=causal, upcast=upcast,
                        dropout_mask=keep, dropout_p=p)
    out.backward(dout.to(out.dtype))
    return [x.grad for x in leaves]


def phase_train_kernels(gen, errs):
    """K1 with dropout and K2 against their twins and the 2x rule (oracle:
    fp32 attention_ref, by autograd for the gradients; baseline: the
    same-dtype attention_ref, atol 1e-4 for the gradients' fp32 sums),
    bf16, on the main path's strided operands (packed_inputs), at
    TRAIN_KERNEL_CASES. Adds the max errors vs the twins to ``errs``."""
    errs["flash_bwd"] = 0.0
    for b, h, h_kv, s, d, p, causal in TRAIN_KERNEL_CASES:
        q, k, v, dout = packed_inputs(gen, b, h, h_kv, s, d)
        kw = dict(causal=causal, softmax_scale=d ** -0.5, dropout_p=p,
                  seed=SEED if p else None)
        out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
        grads = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        torch.cuda.synchronize()
        twin, _ = flash_attention_fwd_plain(q, k, v, save_lse=False, **kw)
        twin_grads = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
        keep = dropout_mask_dense(SEED, b, h, s, s, p, device=DEV) if p \
            else None
        label = (f"b={b} h={h} h_kv={h_kv} s={s} d={d} p={p}"
                 + ("" if causal else " non-causal"))
        err, base = assert_two_x_bound(
            out, attention_ref(q, k, v, causal=causal, dropout_mask=keep,
                               dropout_p=p),
            attention_ref(q, k, v, causal=causal, upcast=False,
                          dropout_mask=keep, dropout_p=p),
            label=f"flash_fwd {label}")
        fwd_twin = max_err(out, twin)
        errs["flash_fwd"] = max(errs["flash_fwd"], fwd_twin)
        oracle = ref_grads(q.float(), k.float(), v.float(), dout.float(),
                           keep, p, True, causal)
        native = ref_grads(q, k, v, dout, keep, p, False, causal)
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


def decode_splits(q, kp, table, window=None, sinks=0) -> int:
    """The split count the K5 wrapper chooses for these inputs (with a
    window: over the band and the sinks)."""
    return paged_num_splits(q.shape[0], kp.shape[0], table.shape[1],
                            kp.shape[2], sm_count(q.device.index),
                            paged_live_span(table.shape[1], kp.shape[2],
                                            window, sinks))


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


def fused_route(shape):
    """On dense_timing.append_inputs(shape) (the serving path's views of
    the projections): the attention kernel with the append in its launch,
    and the standalone append followed by the same kernel on a copy of the
    cache. Returns (fused out, its cache, two-launch out, its cache, the
    pages to compare (K7a writes page 0 for inactive slots), split count)."""
    c, table, lens, before, new, q, k, v = append_inputs(DEV, shape)
    pair = cache.PagedKVCache(c.k_pages.clone(), c.v_pages.clone())
    if new is None:
        out = paged_decode_with_append(q, k, v, c.k_pages, c.v_pages, before,
                                       table)
        cache.append_token(pair, k, v, table, before)
        want = paged_decode_attention(q, pair.k_pages, pair.v_pages,
                                      (before.clamp(min=0) + 1).int(), table)
        return out, c, want, pair, slice(1, None), decode_splits(
            q, c.k_pages, table)
    out = paged_chunk_attention(q, c.k_pages, c.v_pages, lens, table,
                                chunk_lens=new, new_k=k, new_v=v,
                                cache_seqlens=before)
    cache.append_span(pair, k, v, table, before, new)
    want = paged_chunk_attention(q, pair.k_pages, pair.v_pages, lens, table,
                                 chunk_lens=new)
    return out, c, want, pair, slice(None), chunk_splits(q, c.k_pages, table)


def phase_fused_kernels():
    """K5 and K6 with the append in their launch, bit for bit the
    two-launch route (K7a + K5, K7b + K6) in output and cache, at GPT-2's
    and Llama-3-8B's decode shapes and at verification."""
    for shape in APPEND_SHAPES:
        out, c, want, pair, pages, splits = fused_route(shape)
        torch.cuda.synchronize()
        check(torch.equal(out, want), f"fused append {shape}: the output "
              f"differs from the two-launch route by {max_err(out, want)}")
        for name, a, b in (("k", c.k_pages, pair.k_pages),
                           ("v", c.v_pages, pair.v_pages)):
            check(torch.equal(a[:, pages], b[:, pages]),
                  f"fused append {shape}: {name} pages differ")
        kernel = "K5" if out.dim() == 3 else "K6"
        print(f"{kernel} with the append, {shape} {tuple(out.shape)}, "
              f"{splits} splits: output and cache bit for bit the "
              "standalone append followed by the kernel")
        del out, c, want, pair
    torch.cuda.empty_cache()


# The serving chain's kernels (kernels/llama_chain.py) at the widths of the
# two served models: Mistral-7B (longdoc's chunk of 8 x 512 tokens and its
# 64-row decode step) and Qwen3-30B-A3B (a 512-token chunk and turns'
# 32-row decode step: QK-norm, and SwiGLU on the halves of the routed
# experts' fused product, top-8 slots a token).
CHAIN_MODELS = {
    # model: (n_embd, n_head, n_kv_head, head_dim, rope_theta, rms_norm_eps,
    #         MLP width, experts per token (None: dense), {shape: (b, s)})
    "Mistral-7B": (4096, 32, 8, 128, 1e4, 1e-5, 14336, None,
                   {"chunk 8x512": (8, 512), "decode 64": (64, 1)}),
    "Qwen3-30B-A3B": (2048, 32, 4, 128, 1e6, 1e-6, 768, 8,
                      {"chunk 1x512": (1, 512), "decode 32": (32, 1)}),
}
CHAIN_KERNELS = ("add_rmsnorm", "qk_rope", "swiglu")
L2_BYTES = 50 * 2**20  # H100 SXM


def chain_inputs(model, b, s, seed):
    """One layer's chain operands of CHAIN_MODELS[model] for b x s tokens,
    bf16: the residual and the pending sublayer output (b s, n_embd) with
    the norm weight, q (b, s, n_head, hd) and k (b, s, n_kv_head, hd) as
    views of one projection with positions to 7000 (with QK-norm weights
    where the model has them), and gate and up: two (b s, width) products,
    or for routed experts the halves gu[:, :I] and gu[:, I:] of one (b s
    top_k, 2 I) product."""
    e, h, h_kv, hd, theta, eps, width, top_k, _ = CHAIN_MODELS[model]
    g = torch.Generator(device=DEV).manual_seed(seed)
    rows = b * s
    qkv = randn(g, (b, s, h + 2 * h_kv, hd))
    pos = (torch.randint(0, 7000 - s + 1, (b, 1), generator=g, device=DEV)
           + torch.arange(s, device=DEV))

    def weight(n):
        return (0.5 + torch.rand(n, generator=g, device=DEV)).to(BF16)

    if top_k is None:
        gate, up = randn(g, (rows, width)), randn(g, (rows, width))
    else:
        gu = randn(g, (rows * top_k, 2 * width))
        gate, up = gu[:, :width], gu[:, width:]
    return {"x": randn(g, (rows, e)), "d": randn(g, (rows, e)),
            "w": weight(e), "eps": eps,
            "q": qkv[:, :, :h], "k": qkv[:, :, h:h + h_kv], "pos": pos,
            "inv_freq": llama_chain.rope_inv_freq(hd, theta, DEV),
            "norms": ((None, None) if top_k is None
                      else (weight(hd), weight(hd))),
            "gate": gate, "up": up}


def chain_calls(a, plain=False):
    """{kernel: (call, bytes it must move)} on inputs ``a``."""
    m = llama_chain
    norm = m.add_rmsnorm_plain if plain else m.add_rmsnorm
    rope = m.qk_rope_plain if plain else m.qk_rope
    glu = m.swiglu_plain if plain else m.swiglu
    norms = [w for w in a["norms"] if w is not None]
    return {
        "add_rmsnorm": (lambda: norm(a["x"], a["d"], a["w"], a["eps"]),
                        4 * nbytes(a["x"]) + nbytes(a["w"])),
        "qk_rope": (lambda: rope(a["q"], a["k"], a["pos"], a["inv_freq"],
                                 *a["norms"], eps=a["eps"]),
                    2 * (a["q"].numel() + a["k"].numel()) * 2
                    + nbytes(a["pos"], a["inv_freq"], *norms)),
        "swiglu": (lambda: glu(a["gate"], a["up"]),
                   3 * nbytes(a["gate"])),
    }


def check_chain(label, a, errs):
    """The three kernels on inputs ``a`` against their twins: the residual
    sum bit for bit, the rest under the 2x rule against fp32. Records each
    kernel's largest error in ``errs``."""
    m, eps = llama_chain, a["eps"]
    res, out = m.add_rmsnorm(a["x"], a["d"], a["w"], eps)
    base_res, base = m.add_rmsnorm_plain(a["x"], a["d"], a["w"], eps)
    check(torch.equal(res, base_res),
          f"add_rmsnorm {label}: residual sum differs")
    found = {"add_rmsnorm": [assert_two_x_bound(
        out, m.rms_norm_plain(res.float(), a["w"], eps, torch.float32), base,
        label=f"add_rmsnorm {label}")[0]]}
    q, k = a["q"].clone(), a["k"].clone()
    want = [t.float() for t in (q, k)]
    base = [a["q"].clone(), a["k"].clone()]
    m.qk_rope(q, k, a["pos"], a["inv_freq"], *a["norms"], eps=eps)
    m.qk_rope_plain(*want, a["pos"], a["inv_freq"], *a["norms"], eps=eps)
    m.qk_rope_plain(*base, a["pos"], a["inv_freq"], *a["norms"], eps=eps)
    found["qk_rope"] = [
        assert_two_x_bound(got, w32, b16, label=f"qk_rope {t} {label}")[0]
        for got, w32, b16, t in zip((q, k), want, base, "qk")]
    found["swiglu"] = [assert_two_x_bound(
        m.swiglu(a["gate"], a["up"]),
        m.swiglu_plain(a["gate"].float(), a["up"].float()),
        m.swiglu_plain(a["gate"], a["up"]), label=f"swiglu {label}")[0]]
    torch.cuda.synchronize()
    for name, err in found.items():
        errs[name] = max(errs.get(name, 0.0), *err)


def phase_chain_kernels(errs):
    """add_rmsnorm, qk_rope and swiglu against their twins (check_chain) at
    every shape of CHAIN_MODELS, their registers and spills, and their
    device time by busy_ms beside the byte bound and the twin's (a chunk's
    calls cycle through enough input sets that each kernel's operands over
    the sets are twice the L2, so that no call runs from it). Returns
    {kernel: {"<model> <shape>": row}} for the kernels' JSON line."""
    log = _build.build_log() or ""
    name, seen = None, set()
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:  # the first bf16 instance of each
            name = next((k for k in CHAIN_KERNELS
                         if k in entry.group(1)
                         and "nv_bfloat16" in entry.group(1)), None)
        elif name and name not in seen and ("spill" in line
                                            or "Used" in line):
            print(f"ptxas {name} (bf16): {line.strip()}")
            if "Used" in line:
                seen.add(name)
    rows_out = {}
    with torch.no_grad():
        for model, (*_, shapes) in CHAIN_MODELS.items():
            for shape, (b, s) in shapes.items():
                label = f"{model} {shape}"
                a = chain_inputs(model, b, s, 0)
                check_chain(label, a, errs)
                least = min(n for _, n in chain_calls(a).values())
                n_sets = max(ROTATE, -(-2 * L2_BYTES // least)) if s > 1 \
                    else 1
                sets = [a] + [chain_inputs(model, b, s, 1 + i)
                              for i in range(n_sets - 1)]
                kernel = [chain_calls(x) for x in sets]
                plain = [chain_calls(x, plain=True) for x in sets]
                for name in CHAIN_KERNELS:
                    k_ms = busy_ms(rotating([c[name][0] for c in kernel]))
                    p_ms = busy_ms(rotating([c[name][0] for c in plain]),
                                   n=3)
                    b_ms, _ = bound(kernel[0][name][1], 0)
                    rows_out.setdefault(name, {})[label] = {
                        "ms": k_ms, "bound_ms": b_ms, "bound_by": "bytes",
                        "plain_ms": p_ms}
                    print(f"{name} ({label}, bf16, {len(sets)} input "
                          f"sets): kernel {k_ms:.4f} ms, bound {b_ms:.4f} "
                          f"ms (bytes), plain {p_ms:.4f} ms "
                          f"[{card_line()}]")
                del a, sets, kernel, plain
                torch.cuda.empty_cache()
    print(json.dumps({"llama_chain": rows_out}))
    return rows_out


def check_chain_launches(label, launches, n_layer):
    """A Llama serving path launched the chain's kernels, per phase call
    (each launches one K5 or one K6 a layer) 2 n_layer + 1 add_rmsnorm
    (two a layer and the final norm), n_layer qk_rope and n_layer
    swiglu."""
    per_layer = launches["append_token in K5"] + launches["paged_chunk"]
    calls = per_layer // n_layer
    got = [launches[name] for name in CHAIN_KERNELS]
    check(calls > 0 and per_layer == calls * n_layer
          and got == [calls * (2 * n_layer + 1), per_layer, per_layer],
          f"{label}: chain launches {dict(zip(CHAIN_KERNELS, got))} for "
          f"{calls} phase calls of {n_layer} layers")
    print(f"{label}: {calls} phase calls launched the chain's "
          f"{dict(zip(CHAIN_KERNELS, got))}")


def phase_determinism(gen, n=10):
    """Each kernel ``n`` times on the same inputs and seed: every rerun
    bit for bit the first. K1 + K2 (out, lse, dq, dk, dv) at GPT-2's train
    shape with dropout 0.1, at ViT-B/16's with dropout 0.1 and at the
    Llama-3-8B-width train step's, K8a-c at BS_SHAPES (i) (the same), K5 at "Llama
    decode" and K6 at "Llama chunk" (out; split-KV merged in split order),
    K5 and K6 with the append at "Llama decode" and "verify" (out and
    pages: each rerun stores the same rows again)."""
    def same(label, fn):
        first = [x.clone() for x in fn()]
        for _ in range(n - 1):
            again = fn()
            torch.cuda.synchronize()
            for i, (a, b) in enumerate(zip(first, again)):
                check(torch.equal(a, b),
                      f"determinism {label}: output {i} differs between runs")
        print(f"determinism {label}: {n} seeded reruns bit for bit equal")

    for b, h, h_kv, s, d, p, causal in (
            (8, 12, 12, 1024, 64, 0.1, True), (64, 12, 12, 196, 64, 0.1, False),
            (4, 32, 8, 2048, 128, 0.0, True)):
        q, k, v, dout = packed_inputs(gen, b, h, h_kv, s, d)
        kw = dict(causal=causal, softmax_scale=d ** -0.5, dropout_p=p,
                  seed=SEED if p else None)

        def dense(q=q, k=k, v=v, dout=dout, kw=kw):
            out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
            return (out, lse,
                    *flash_attention_bwd(q, k, v, out, dout, lse, **kw))
        same(f"flash_fwd + flash_bwd b={b} h={h}/{h_kv} s={s} d={d} p={p}"
             f"{'' if causal else ' non-causal'} (out, lse, dq, dk, dv)",
             dense)
    seg = padding_segments()
    q, k, v, dout = packed_inputs(gen, BERT_B, 12, 12, BERT_S, 64)
    kw = dict(causal=False, softmax_scale=0.125, dropout_p=0.1, seed=SEED)

    def segments():
        plan = Segments(seg.q_seg, seg.kv_seg, seg.q_pos, seg.kv_pos)
        out, lse = flash_attention_fwd(q, k, v, save_lse=True,
                                       segments=plan, **kw)
        return (out, lse, *flash_attention_bwd(q, k, v, out, dout, lse,
                                               segments=plan, **kw))
    same("flash_fwd + flash_bwd in segment form, BERT b=32 h=12 s=512 d=64 "
         "padding masks, p=0.1 (out, lse, dq, dk, dv)", segments)
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
    c, table, lens, before, _, q, k, v = append_inputs(DEV, "Llama decode")
    same(f"paged_decode_with_append Llama decode, "
         f"{decode_splits(q, c.k_pages, table)} splits (out, pages)",
         lambda: (paged_decode_with_append(q, k, v, c.k_pages, c.v_pages,
                                           before, table),
                  c.k_pages, c.v_pages))
    c, table, lens, before, new, q, k, v = append_inputs(DEV, "verify")
    same(f"paged_chunk with the append, verify, "
         f"{chunk_splits(q, c.k_pages, table)} splits (out, pages)",
         lambda: (paged_chunk_attention(q, c.k_pages, c.v_pages, lens, table,
                                        chunk_lens=new, new_k=k, new_v=v,
                                        cache_seqlens=before),
                  c.k_pages, c.v_pages))
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
    check_fused_appends("serve", launches, decode=True)
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
        # llama_decode's logits on the card live in its graph's buffer.
        steps.append(logits[0].clone())
    for t in range(n_decode):
        logits, caches = fns.decode_step(model, cfg, caches, table,
                                         int32([prompt_len + t]),
                                         ids[:, prompt_len + t])
        positions.append(prompt_len + t)
        steps.append(logits[0].clone())
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
    check_fused_appends(label, launches, decode=True)
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
    through flash_attn_with_kvcache (K6 with K7b's append in its launch).
    Every verify round's logits are held to the 2x rule against the fp32
    and bf16 full-sequence models on the same tokens (bf16 argmax near-ties
    may make the tokens differ from plain greedy decoding, so they are not
    compared). Returns the launch counts of the run."""
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
    check_fused_appends("speculative", launches, verify=True)
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
    print(f"verify round (score_chunk, 12 layers, {k + 1} rows after the "
          f"{prompt_len}-token prompt): {verify_round_ms(model, cfg, prompt, k)}"
          f" [{card_line()}]")
    return launches


def verify_round_ms(model, cfg, prompt, k, ps=128):
    """One verify round of the speculative loop on the prompt's cache:
    device busy ms (busy_ms) and host wall ms of a score_chunk call that
    appends and attends k + 1 rows in every layer (each call writes the
    same slots again)."""
    n_pages = -(-(len(prompt) + k + 1) // ps)
    caches = [cache.init_cache(cfg.n_kv_heads, 1 + n_pages, ps, cfg.head_dim,
                               dtype=cfg.dtype, device=DEV)
              for _ in range(cfg.n_layer)]
    table = torch.arange(1, 1 + n_pages, dtype=torch.int32, device=DEV)[None]
    _, ks, vs = gpt2_decode.prefill(model, cfg, torch.tensor([prompt],
                                                             device=DEV))
    for c, kk, vv in zip(caches, ks, vs):
        cache.write_prompt(c, kk[0], vv[0], table[0, : -(-len(prompt) // ps)])
    chunk = prompt[-1:] + prompt[:k]

    def call():
        return score_chunk(model, cfg, caches, table, chunk, len(prompt))
    busy = busy_ms(call)
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        call()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return (f"device busy {busy:.4f} ms, host wall {statistics.median(walls):.3f}"
            f" ms (median of 5)")


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
    eng, _ = admission(model, cfg, prompts, kw)
    win = decode_window(eng, 16)
    check(win["copies_before_k5"] == 0 and win["k7a_launches"] == 0
          and win["k5_launches"] == 16 * cfg.n_layer,
          f"GPT-2 decode window: copies or standalone appends around K5: "
          f"{win}")
    print(f"GPT-2 decode window, 16 steps at batch 8 after 3: device busy "
          f"{win['busy_ms_per_step']:.4f} ms, {win['launches_per_step']:.1f}"
          f" launches and {win['wall_ms_per_step']:.3f} ms wall per step "
          f"({win['wall_ms_per_step_traced']:.3f} traced), idle "
          f"{win['idle_share'] * 100:.1f}% of the GPU span; "
          f"{win['k5_launches']} K5 launches, no standalone append; no copy "
          f"kernel between a layer's GEMM and K5 (between them: "
          f"{win['between_gemm_and_k5']}) [{card}]")


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
    check_chain_launches("llama chunked", launches, cfg.n_layer)
    ttft = ttft_ms(model, cfg, prompts, kw)
    tok_s, ms_step = decode_rate(model, cfg, prompts, kw, n_steps=16)
    card = card_line()
    print(ttft_line(f"llama chunked prefill TTFT, one batch of 8 admissions "
                    f"(prompts {lens.min()}..{lens.max()}, chunks of 512)",
                    ttft, card))
    print(f"llama decode at batch 8 (contexts {lens.min()}.."
          f"{lens.max() + 20}): {tok_s:.1f} tokens/s, {ms_step:.2f} ms/step "
          f"[{card}]")
    held = {}  # the engine of the last admission trace: decoded below

    def fresh():
        held["engine"] = None  # free the last one's caches first
        held["engine"] = ServingEngine(model, cfg, **kw)
        for p in prompts:
            held["engine"].submit(p, max_new_tokens=1000)
        return held["engine"]

    wall, _, events = trace_call(lambda eng: eng._admit(), setup=fresh)
    k7c = [e["dur"] for e in device_events(events)
           if "write_pages" in e["name"]]
    print(f"llama prefill trace, one admission of 8: "
          f"{device_summary(wall, events)}; {len(k7c)} K7c launches, "
          f"{sum(k7c) / max(len(k7c), 1) / 1e3:.4f} ms each [{card}]")
    engine = held.pop("engine")
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


def sdpa_fwd(q, k, v, p=0.0, mask=None, causal=True):
    """The SDPA forward yardstick: causal (or not), or with a boolean
    mask."""
    kw = dict(is_causal=causal) if mask is None else dict(attn_mask=mask)
    gqa = k.shape[1] != q.shape[1]
    return lambda: lambda: F.scaled_dot_product_attention(
        q, k, v, dropout_p=p, enable_gqa=gqa, **kw)


def sdpa_bwd(q, k, v, dout, p=0.0, mask=None, wrt="qkv", causal=True):
    """The SDPA backward yardstick: the gradients ``wrt`` of a graph built
    under the pinned backend."""
    kw = dict(is_causal=causal) if mask is None else dict(attn_mask=mask)
    gqa = k.shape[1] != q.shape[1]

    def make():
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        out = F.scaled_dot_product_attention(*leaves, dropout_p=p,
                                             enable_gqa=gqa, **kw)
        wanted = [leaves["qkv".index(c)] for c in wrt]
        return lambda: torch.autograd.grad(out, wanted, dout,
                                           retain_graph=True)
    return make


@dataclasses.dataclass
class TorchCall:
    """A library yardstick that is a plain PyTorch call, not SDPA:
    ``label`` names it in the output and ``fn`` runs it."""
    label: str
    fn: object


def cache_library_calls(pages, prompt, chunks, token, span):
    """The one PyTorch call per cache (K, then V) that writes what each
    cache-write kernel writes, with its indices and its sources in the
    cache's layout made here, outside the timed call: index_copy_ of whole
    pages for write_pages (on the Llama chunk, each of ``chunks``' input
    sets in turn, as the kernel is timed), index_put_ of token rows for
    append_token and append_span. {kernel timing row: TorchCall}."""
    ps = pages.page_size

    def copy_pages(c, k, v, table):
        """index_copy_ of row r's (zero-tailed) pages to table[r]."""
        b, n_pages = table.shape
        ids = table.reshape(-1).long()
        src = []
        for x in (k, v):
            xp = x.new_zeros((b, n_pages * ps, *x.shape[2:]))
            xp[:, : x.shape[1]] = x
            src.append(xp.reshape(b * n_pages, ps, *x.shape[2:])
                       .permute(2, 0, 1, 3).contiguous())
        return lambda: (c.k_pages.index_copy_(1, ids, src[0]),
                        c.v_pages.index_copy_(1, ids, src[1]))

    def put_rows(page_ids, slots, k, v):
        """index_put_ of (n, h, d) token rows at (page_ids, slots)."""
        heads = torch.arange(k.shape[1], device=DEV)[:, None]
        idx = (heads, page_ids, slots)
        kt, vt = (x.transpose(0, 1).contiguous() for x in (k, v))
        return TorchCall("index_put_ of token rows, K and V", lambda: (
            pages.k_pages.index_put_(idx, kt),
            pages.v_pages.index_put_(idx, vt)))

    kw, vw, ids = prompt
    nk, nv, tbl8, l8 = token
    ok = (l8 >= 0) & (l8.long() // ps < tbl8.shape[1])
    rows = torch.arange(tbl8.shape[0], device=DEV)
    token_pages = torch.where(
        ok, tbl8[rows, (l8.long().clamp(min=0) // ps).clamp(
            max=tbl8.shape[1] - 1)].long(), 0)
    sk, sv, _, span_lens, span_new = span
    t = torch.arange(sk.shape[1], device=DEV)
    pos = span_lens.long()[:, None] + t
    live = (span_lens[:, None] >= 0) & (t < span_new[:, None]) \
        & (pos // ps < tbl8.shape[1])
    b_idx, t_idx = live.nonzero(as_tuple=True)
    p = pos[b_idx, t_idx]
    copy_label = "index_copy_ of pages, K and V"
    return {
        "write_pages": TorchCall(copy_label, copy_pages(
            pages, kw[None], vw[None], ids[None])),
        "write_pages (Llama chunk)": TorchCall(copy_label, rotating(
            [copy_pages(*inputs) for inputs in chunks])),
        "append_token": put_rows(token_pages, torch.where(
            ok, l8.long() % ps, 0), nk, nv),
        "append_span": put_rows(tbl8[b_idx, p // ps].long(), p % ps,
                                sk[b_idx, t_idx], sv[b_idx, t_idx]),
    }


def append_timing_specs():
    """K5 and K6 alone and with the append in their launch on
    dense_timing.append_inputs (the serving path's views of the
    projections) at GPT-2's and Llama-3-8B's decode shapes and at
    verification: the fused rows' marginal cost over the kernel alone, in
    one run. The bound adds each new row's read and write to the kernel's;
    the plain versions are the twins of the two-launch route."""
    specs = {}
    for shape, (lengths, chunk, sq, h, h_kv, d, _) in APPEND_SHAPES.items():
        c, table, lens, before, new, q, k, v = append_inputs(DEV, shape)
        pages = (c.k_pages, c.v_pages)
        scale = d ** -0.5
        if new is None:
            n_bytes, flops = decode_work(q, c.k_pages, lens, table)
            rows = len(lengths)
            specs[f"K5 alone ({shape})"] = (
                functools.partial(paged_decode_attention, q, *pages, lens,
                                  table),
                functools.partial(paged_decode_attention_plain, q, *pages,
                                  lens, table, softmax_scale=scale),
                None, n_bytes, flops)
            specs[f"K5 with the append ({shape})"] = (
                functools.partial(paged_decode_with_append, q, k, v, *pages,
                                  before, table),
                lambda a=(c, q, k, v, table, before), s=scale: (
                    cache.append_token_plain(a[0], *a[2:]),
                    paged_decode_attention_plain(
                        a[1], a[0].k_pages, a[0].v_pages,
                        (a[5].clamp(min=0) + 1).int(), a[4],
                        softmax_scale=s)),
                None, n_bytes + 4 * rows * h_kv * d * k.element_size(),
                flops)
            continue
        n_bytes, flops = chunk_work(shape)
        cap = 128 * table.shape[1]
        rows = sum(max(0, min(n, cap - (t - n))) for t, n in
                   zip(lengths, chunk) if t - n >= 0)  # rows K7b stores
        specs[f"K6 alone ({shape})"] = (
            functools.partial(paged_chunk_attention, q, *pages, lens, table,
                              chunk_lens=new),
            functools.partial(paged_chunk_attention_plain, q, *pages, lens,
                              table, chunk_lens=new, softmax_scale=scale),
            None, n_bytes, flops)
        specs[f"K6 with the append ({shape})"] = (
            functools.partial(paged_chunk_attention, q, *pages, lens, table,
                              chunk_lens=new, new_k=k, new_v=v,
                              cache_seqlens=before),
            lambda a=(c, q, k, v, table, before, new, lens), s=scale: (
                cache.append_span_plain(a[0], a[2], a[3], a[4], a[5], a[6]),
                paged_chunk_attention_plain(
                    a[1], a[0].k_pages, a[0].v_pages, a[7], a[4],
                    chunk_lens=a[6], softmax_scale=s)),
            None, n_bytes + 4 * rows * h_kv * d * k.element_size(), flops)
    return specs


def kernel_timing(gen):
    """Each kernel against its twin and, where one exists, a single PyTorch
    call computing the same function, at the main paths' shapes, in turns
    (kernel, plain, kernel: the plain twin, 10-1000x slower, is timed once,
    over 3 calls;
    the library call last, under each pinned
    SDPA backend). Returns {name: (ms, plain_ms, library_ms, bound_ms,
    bound_by, library_backend)}."""
    card = card_line()
    # K1 at the serving bucket (b=8, s=768, no lse) and at the train step
    # (s=1024, dropout 0.1, lse saved); K2 at the train step.
    q = randn(gen, (8, 12, 768, 64))
    k, v = randn(gen, (8, 12, 768, 64)), randn(gen, (8, 12, 768, 64))
    fwd = dict(causal=True, softmax_scale=0.125, save_lse=False)
    qt, kt, vt, dt = (randn(gen, (8, 12, 1024, 64)) for _ in range(4))
    train = dict(causal=True, softmax_scale=0.125, dropout_p=0.1, seed=SEED)
    ot, lt = flash_attention_fwd(qt, kt, vt, save_lse=True, **train)
    # K1 and K2 at the Llama-3-8B-width train step's attention (GQA 32/8,
    # d=128, b=4, s=2048; Llama serving prefills through K6).
    qa, da = randn(gen, (4, 32, 2048, 128)), randn(gen, (4, 32, 2048, 128))
    ka, va = randn(gen, (4, 8, 2048, 128)), randn(gen, (4, 8, 2048, 128))
    wide = dict(causal=True, softmax_scale=128 ** -0.5)
    oa, la = flash_attention_fwd(qa, ka, va, save_lse=True, **wide)
    qd, kp, vp, dl, tbl = decode_inputs(gen)
    ql, kl, vl, ll, tl = decode_inputs(gen, "Llama decode")
    # K7c on dense_timing's inputs: GPT-2's prompt, and one layer of
    # Llama-3-8B's chunk (8 rows x 512 tokens into 4 pages each) on four
    # input sets in turn, 137 MB, so that the timed calls miss L2.
    (pages, kw, vw, ids), chunks = k7c_inputs(DEV)
    nk, nv = randn(gen, (8, 12, 64)), randn(gen, (8, 12, 64))
    tbl8 = torch.arange(1, 65, dtype=torch.int32, device=DEV).reshape(8, 8)
    l8 = torch.tensor([5, 127, 128, 300, -1, 640, 999, 0], dtype=torch.int32,
                      device=DEV)
    sk, sv = randn(gen, (8, 5, 12, 64)), randn(gen, (8, 5, 12, 64))
    span = ([5, 125, 128, 300, -1, 1020, 638, 0], [5, 5, 5, 2, 5, 5, 5, 0])
    span_lens, span_new = int32(span[0]), int32(span[1])
    written = sum(1 for n, c in zip(*span) if n >= 0 for t in range(c)
                  if (n + t) // 128 < 8)  # tokens append_span stores
    libs = cache_library_calls(pages, (kw, vw, ids), chunks,
                               (nk, nv, tbl8, l8),
                               (sk, sv, tbl8, span_lens, span_new))

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
        "flash_bwd": (
            lambda: flash_attention_bwd(qt, kt, vt, ot, dt, lt, **train),
            lambda: flash_attention_bwd_plain(qt, kt, vt, ot, dt, lt, **train),
            sdpa_bwd(qt, kt, vt, dt, p=0.1),
            nbytes(qt, kt, vt, ot, dt, lt) + nbytes(qt, kt, vt),
            10 * 8 * 12 * causal_pairs(1024) * 64),
        "flash_fwd (Llama train, lse)": (
            lambda: flash_attention_fwd(qa, ka, va, save_lse=True, **wide),
            lambda: flash_attention_fwd_plain(qa, ka, va, save_lse=True,
                                              **wide),
            sdpa_fwd(qa, ka, va),
            nbytes(qa, ka, va, qa, la),
            4 * 4 * 32 * causal_pairs(2048) * 128),
        "flash_bwd (Llama train)": (
            lambda: flash_attention_bwd(qa, ka, va, oa, da, la, **wide),
            lambda: flash_attention_bwd_plain(qa, ka, va, oa, da, la, **wide),
            sdpa_bwd(qa, ka, va, da),
            nbytes(qa, ka, va, oa, da, la) + nbytes(qa, ka, va),
            10 * 4 * 32 * causal_pairs(2048) * 128),
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
        "append_token": (
            lambda: cache.append_token(pages, nk, nv, tbl8, l8),
            lambda: cache.append_token_plain(pages, nk, nv, tbl8, l8),
            libs["append_token"], 2 * nbytes(nk, nv) + nbytes(tbl8, l8), 0),
        "write_pages": (
            lambda: cache.write_prompt(pages, kw, vw, ids),
            lambda: cache.write_prompt_plain(pages, kw, vw, ids),
            libs["write_pages"], 2 * nbytes(kw, vw) + nbytes(ids), 0),
        "write_pages (Llama chunk)": (
            rotating([functools.partial(cache._write_prompts, *inputs)
                      for inputs in chunks]),
            rotating([functools.partial(cache._write_prompts_plain, *inputs)
                      for inputs in chunks]),
            libs["write_pages (Llama chunk)"],
            2 * nbytes(*chunks[0][1:3]) + nbytes(chunks[0][3]), 0),
        "append_span": (
            lambda: cache.append_span(pages, sk, sv, tbl8, span_lens,
                                      span_new),
            lambda: cache.append_span_plain(pages, sk, sv, tbl8, span_lens,
                                            span_new),
            libs["append_span"], 4 * written * 12 * 64 * sk.element_size()
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
    specs.update(vit_timing_specs(gen))
    specs.update(append_timing_specs())
    specs.update(bs_timing_specs())
    bert_specs, plan_call = bert_timing_specs(gen)
    specs.update(bert_specs)
    plan_ms, plan_host = busy_ms(plan_call), host_ms(plan_call)
    print(f"segment plan (BERT, csrc/segments.cu, one launch; inside the "
          f"flash_fwd (BERT, segments) row): {plan_ms:.4f} ms (host "
          f"{plan_host:.4f} ms to issue a call) [{card}]")
    times = {}
    for name, (kern, plain, library, n_bytes, flops, *tiles) in specs.items():
        t_row = time.perf_counter()
        # The plain twins launch hundreds of small kernels a call, whose
        # trace dominates a row's time: three calls of them suffice.
        k1, p1, k2 = busy_ms(kern), busy_ms(plain, n=3), busy_ms(kern)
        host = host_ms(kern)
        lib_ms = backend = None
        lib = "none"
        if isinstance(library, TorchCall):
            lib_ms, backend = busy_ms(library.fn), library.label
            lib = f"{lib_ms:.4f} ms ({backend})"
        elif library is not None:
            lib_ms, backend, each = sdpa_fastest(library)
            lib = f"{lib_ms:.4f} ms ({backend}; " + ", ".join(
                f"{b} {'refused' if t is None else f'{t:.4f}'}"
                for b, t in each.items()) + ")"
        b_ms, b_by = bound(n_bytes, flops)
        times[name] = (min(k1, k2), p1, lib_ms, b_ms, b_by, backend)
        live = ""
        if tiles:  # K8: (live 64x64 tiles, their products' operations)
            n_tiles, tile_flops = tiles[0]
            live = (f"; {n_tiles} live 64x64 tiles, {tile_flops / 1e9:.2f} "
                    f"GFLOP on them, {tile_flops / min(k1, k2) / 1e9:.1f} "
                    f"TFLOP/s on live tiles")
        print(f"{name}: kernel {k1:.4f} / {k2:.4f} ms (host {host:.4f} ms "
              f"to issue a call), plain {p1:.4f} ms, library {lib}, bound "
              f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
              f"{flops / 1e9:.2f} GFLOP){live} [{card}]; row timed in "
              f"{time.perf_counter() - t_row:.1f} s")
    print("shapes: flash_fwd b=8 h=12 s=768 d=64 causal (the serving "
          "bucket), library = SDPA forward; flash_fwd (train step) and "
          "flash_bwd b=8 h=12 s=1024 d=64 causal dropout 0.1, library = SDPA "
          "forward / backward with the "
          "same dropout; the Llama train rows b=4 h=32/8 s=2048 d=128 "
          "causal (the Llama-3-8B-width train step), library = SDPA with "
          "enable_gqa; the ViT-B/16 rows b=64 h=12 s=196 d=64 non-causal, "
          "dropout 0.1; every "
          "library time is the fastest of SDPA's flash, cuDNN and efficient "
          "backends pinned in turn (graph built under the pin), named in "
          "brackets; kernel, plain and library times are device busy time "
          "in a profiler trace of 10 calls (dense_timing.busy_ms), host = "
          "the host's time to issue one kernel call; "
          "paged_decode at "
          "DECODE_SHAPES (GPT-2 decode b=8 h=12 d=64 page 128, lengths "
          "0..1000; Llama decode b=8 h=32/8 d=128, lengths 300..4020); "
          "append_token b=8 h=12; write_pages 768 tokens into 6 pages "
          "(h=12 d=64) and, as on Llama-3-8B's chunked path, 8 rows x 512 "
          "tokens into 4 pages each (h_kv=8 d=128) in one launch, each call "
          "on the next of 4 input sets (137 MB, over the 50 MB L2); "
          "append_span b=8 sq=5 h=12 d=64 (the K7b check's rows); K5 and K6 "
          "alone and with the append at dense_timing.APPEND_SHAPES (GPT-2 "
          "and Llama decode, verify: views of the projections, lengths "
          "before the append one less, or the chunk less); the cache "
          "writes' library = index_copy_ along the page axis from sources "
          "already in page layout (write_pages) or index_put_ (append_*), "
          "one call each for K and V, indices made outside the timed call; "
          "paged_chunk at CHUNK_SHAPES (GPT-2 chunk b=8 sq=256 h=12 d=64, "
          "Llama chunk b=8 sq=512 h=32/8 d=128, verify b=8 sq=5 h=12 d=64); "
          "blocksparse_* at BS_SHAPES (i) (b=8 h=12 s=1024 d=64 causal "
          "LocalGlobalSparsityConfig(window=256), dropout 0.1) and (ii) "
          "(config 4: b=1 h=8 s=8192 d=64 causal, 25% random cells), the "
          "dkv and dq rows' plain = the whole plain backward, library = SDPA "
          "with the element mask as attn_mask (forward; backward for k, v "
          "and for q), bound by operations over visible pairs (4d forward, "
          "8d dK/dV, 6d dQ); flash_fwd / flash_bwd (BERT, segments) at b=32 "
          "h=12 s=512 d=64, the BERT batch's padding masks (lengths uniform "
          "in [171, 512]), non-causal, dropout 0.1, lse; their bound counts "
          "the "
          "real rows of q, k, v (and o, dout) read, the outputs written "
          "whole and the visible pairs' products, library = SDPA with the "
          "key-padding mask as attn_mask; all bf16")
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


def check_fp32_training(model, opt, label):
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          f"non-fp32 {label} parameters")
    check(all(v.dtype == torch.float32 for st in opt.state.values()
              for v in st.values() if v.dim() > 0),
          f"non-fp32 {label} AdamW state")


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
    check_fp32_training(model, opt, "GPT-2")
    print(f"train: GPT-2 full width, b=8 s=1024, dropout 0.1, {n_steps} "
          f"AdamW steps in {dt:.2f} s; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches}")
    return launches, step, batch, gen, model, opt


KERNEL_CLASSES = [  # (class, substrings of the kernel name), first match
    ("blocksparse (K8)", ("bs_fwd", "bs_dkv", "bs_dq", "bs_stats")),
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


def trace_step(label, call, k1, k2, segments=False, band=False):
    """A traced step: no SDPA op, ``k1`` K1 and ``k2`` K2 kernels, all in
    the dense form (or all in the segment form), all with the band terms
    or all without, device busy time, idle share and time by class; then
    the largest kernels by op."""
    call()
    torch.cuda.synchronize()
    wall, names, events = trace_call(call)
    sdpa = sorted(n for n in names if n.startswith(
        ("aten::_scaled_dot_product", "aten::_efficient_attention",
         "aten::_flash_attention")))
    check(not sdpa, f"SDPA ops in the {label} step: {sdpa}")
    kernels = [e["name"] for e in device_events(events)
               if "flash_fwd_wgmma" in e["name"]
               or "flash_bwd_wgmma" in e["name"]]
    got = [sum(key in n for n in kernels)
           for key in ("flash_fwd_wgmma", "flash_bwd_wgmma")]
    # The template flags <T, D, kSeg, kBand> of each kernel's name.
    # (K2's last argument is its kTerms: 0 without the band terms.)
    flags = [re.search(r"wgmma_kernel<[^<>]*?, \d+, (true|false), "
                       r"(true|false|\d)>", n) for n in kernels]
    want = ("true" if segments else "false", band)
    check(got == [k1, k2] and all(
        f and (f.group(1), f.group(2) not in ("false", "0")) == want
        for f in flags),
          f"K1, K2 kernels in a traced {label} step: {got}, want "
          f"{[k1, k2]}, all {'in segment' if segments else 'in dense'} form"
          f"{' with the band' if band else ''}")
    print(f"{label} step trace: {device_summary(wall, events)}; K1 {k1} and "
          f"K2 {k2} kernels{' in segment form' if segments else ''}; no SDPA "
          f"op [{card_line()}]")
    print_top_kernels(label, call)


def print_top_kernels(label, call, n=8):
    """A second trace of ``call`` that records input shapes (which slows
    the host, so it is not used for the idle share), naming the op behind
    each of the ``n`` largest kernels."""
    _, _, events = trace_call(call, record_shapes=True)
    ops = {e["args"]["External id"]: (e["name"], e["args"].get("Input Dims"))
           for e in events if e.get("cat") == "cpu_op"
           and "External id" in e.get("args", {})}
    by_kernel = {}
    for e in device_events(events):
        op = ops.get(e.get("args", {}).get("External id"), ("?", None))
        key = (e["name"][:60], op[0], str(op[1]))
        by_kernel[key] = by_kernel.get(key, 0.0) + e["dur"]
    top = "; ".join(f"{name} from {op} {dims}: {t / 1e3:.3f} ms"
                    for (name, op, dims), t in sorted(
                        by_kernel.items(), key=lambda kv: -kv[1])[:n])
    print(f"{label} step trace, largest device time by kernel and the op "
          f"that launched it: {top}")


def phase_train_timing(step, batch, gen, warmup=2, n=5, label="train",
                       shape="b=8 s=1024 dropout 0.1"):
    """Host ms of ``n`` steps after ``warmup``; prints and returns the
    median and the peak memory of those steps."""
    torch.cuda.reset_peak_memory_stats()
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
    if "images" in batch:
        rate = f"{len(batch['images']) / med * 1e3:.0f} images/s"
    else:
        rate = f"{batch['input_ids'].numel() / med * 1e3:.0f} tokens/s"
    print(f"{label} step {shape}: median {med:.2f} ms (min "
          f"{min(times):.2f}, max {max(times):.2f}, {n} steps after "
          f"{warmup} warm-ups), {rate}, peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
          f"[{card_line()}]")
    return med


def reference_attention(q, k, v, *, causal, softmax_scale=None,
                        dropout_p=0.0, dropout_seed=None, q_segment_ids=None,
                        kv_segment_ids=None, q_positions=None,
                        kv_positions=None, window_size=None,
                        alibi_slopes=None, softcap=None):
    """flash_attention's signature over the same-dtype attention_ref
    (bshd), segment ids and the window as the equivalent boolean mask,
    differentiable by autograd: the train checks' baseline (whose models
    use no ALiBi or softcap). Past 4096 x 4096 scores it runs one query
    head at a time under torch.utils.checkpoint (the scores are recomputed
    in the backward), so Mistral's s = 8192 fits."""
    check(alibi_slopes is None and softcap is None,
          "reference_attention: no ALiBi or softcap")
    mask = None
    if q_segment_ids is not None:
        mask = segment_mask(Segments(q_segment_ids, kv_segment_ids,
                                     q_positions, kv_positions), causal)
        causal = False
    if window_size is not None:
        band = build_mask(q.shape[1], k.shape[1], window_left=window_size[0],
                          window_right=window_size[1], device=q.device)
        mask = band if mask is None else mask & band

    def attend(qh, kh, vh):
        return attention_ref(qh, kh, vh, causal=causal, mask=mask,
                             softmax_scale=softmax_scale, upcast=False)

    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    if q.shape[2] * k.shape[2] <= 4096 * 4096:
        return attend(q, k, v).transpose(1, 2)
    group = q.shape[1] // k.shape[1]
    heads = [torch.utils.checkpoint.checkpoint(
        attend, q[:, i:i + 1], k[:, i // group:i // group + 1],
        v[:, i // group:i // group + 1], use_reentrant=False)
        for i in range(q.shape[1])]
    return torch.cat(heads, dim=1).transpose(1, 2)


def loss_and_norm(loss_fn, model):
    """Loss and global gradient norm of one backward of ``loss_fn()``."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn()
    loss.backward()
    norm = torch.sqrt(sum(p.grad.float().pow(2).sum()
                          for p in model.parameters() if p.grad is not None))
    return torch.stack([loss.detach().float(), norm])


def check_step_two_x(label, make_model, cfg, cfg32, loss_fn,
                     module=modules):
    """One step's loss and global gradient norm: the bf16 model through
    K1/K2 against the same step in fp32 compute, by the 2x rule. Baseline:
    the bf16 model with attention through the same-dtype attention_ref in
    autograd (``reference_attention`` in place of ``module``'s
    flash_attention). Floor 1e-4 of the fp32 value."""
    model16 = make_model(cfg)
    got = loss_and_norm(lambda: loss_fn(model16), model16)
    original = module.flash_attention
    module.flash_attention = reference_attention
    try:
        base = loss_and_norm(lambda: loss_fn(model16), model16)
    finally:
        module.flash_attention = original
    del model16
    torch.cuda.empty_cache()
    model32 = make_model(cfg32)
    want = loss_and_norm(lambda: loss_fn(model32), model32)
    del model32
    torch.cuda.empty_cache()
    for i, what in enumerate(("loss", "grad norm")):
        err, b = assert_two_x_bound(got[i], want[i], base[i],
                                    atol=1e-4 * float(want[i].abs()),
                                    label=f"{label} step {what}")
        print(f"{label} step at dropout 0, {what}: bf16 + kernels "
              f"{float(got[i]):.6f}, fp32 compute {float(want[i]):.6f}, bf16 "
              f"+ attention_ref {float(base[i]):.6f}: err {err:.3e} (bf16 "
              f"baseline {b:.3e})")


def loss_and_grad_norm(model, batch):
    return loss_and_norm(lambda: cross_entropy_loss(
        model(batch["input_ids"]), batch["labels"]), model)


def phase_train_check(batch):
    """One GPT-2 step at dropout 0 against fp32 compute
    (check_step_two_x)."""
    check_step_two_x(
        "train", train_model, GPT2Config(), GPT2Config(dtype=torch.float32),
        lambda m: cross_entropy_loss(m(batch["input_ids"]), batch["labels"]))


# ---------------------------------------------------------------- ViT

# ViT-B/16 (Dosovitskiy et al. 2020, Table 1: 12 layers, 12 heads, hidden
# 768, MLP 3072; 224 x 224 images in 16 x 16 patches, 196 tokens; 1000
# classes), bf16 compute over fp32 weights; one b=64 batch.
VIT_B16 = ViTConfig(dtype=BF16)
VIT_B = 64


def vit_batch(cfg):
    """b=64 standard-normal images (b, 224, 224, 3) and labels in [0,
    1000) from numpy's default_rng(2)."""
    rng = np.random.default_rng(2)
    images = rng.standard_normal(
        (VIT_B, cfg.image_size, cfg.image_size, cfg.num_channels),
        dtype=np.float32)
    labels = rng.integers(0, cfg.num_classes, VIT_B)
    return {"images": torch.from_numpy(images).to(DEV),
            "labels": torch.from_numpy(labels).to(DEV)}


def vit_model(cfg):
    return ViTClassifier(cfg, device=DEV,
                         generator=torch.Generator(device=DEV).manual_seed(0))


def phase_vit_train(n_steps=4):
    """The ViT main path: ViTClassifier(VIT_B16) with dropout 0.1, fp32
    weights and AdamW state, bf16 compute in the patch convolution,
    FlashMHA and the MLP, n_steps on one b=64 batch. Each step launches K1
    and K2 once per layer (non-causal over 196 tokens). Returns (launches,
    step, batch, generator)."""
    cfg = dataclasses.replace(VIT_B16, dropout=0.1)
    batch = vit_batch(cfg)
    model = vit_model(cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    step = make_vit_step(model, opt)
    gen = torch.Generator().manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = [step(batch, gen) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(KERNELS)
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"ViT losses {losses}")
    check(losses[-1] < losses[0], f"ViT loss did not fall: {losses}")
    for name in TRAIN_KERNELS:
        check(launches[name] == cfg.n_layer * n_steps,
              f"ViT {name}: {launches[name]} launches in {n_steps} steps, "
              f"want {cfg.n_layer} per step")
    check_fp32_training(model, opt, "ViT")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"vit train: ViT-B/16 ({n_params / 1e6:.1f} M parameters), "
          f"b={VIT_B} {cfg.image_size}x{cfg.image_size} images, "
          f"{cfg.seq_len} tokens, dropout 0.1, {n_steps} AdamW steps in "
          f"{dt:.2f} s; losses {', '.join(f'{x:.4f}' for x in losses)}; "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches} [{card_line()}]")
    return launches, step, batch, gen


def phase_vit_check(batch):
    """A dropout-0 ViT-B/16 step against fp32 compute (check_step_two_x);
    the fp32 model computes the patch convolution, attention and MLP in
    fp32 from the same weights."""
    check_step_two_x(
        "vit", vit_model, VIT_B16, dataclasses.replace(VIT_B16, dtype=None),
        lambda m: classification_loss(m(batch["images"]), batch["labels"]))


def vit_timing_specs(gen):
    """kernel_timing rows of K1 and K2 at ViT-B/16's attention (b=64 h=12
    s=196 d=64, non-causal, dropout 0.1, lse saved)."""
    q, k, v, do = (randn(gen, (VIT_B, 12, 196, 64)) for _ in range(4))
    kw = dict(causal=False, softmax_scale=0.125, dropout_p=0.1, seed=SEED)
    out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
    pairs = VIT_B * 12 * 196 * 196
    return {
        "flash_fwd (ViT-B/16, dropout 0.1, lse)": (
            lambda: flash_attention_fwd(q, k, v, save_lse=True, **kw),
            lambda: flash_attention_fwd_plain(q, k, v, save_lse=True, **kw),
            sdpa_fwd(q, k, v, p=0.1, causal=False),
            nbytes(q, k, v, q, lse), 4 * pairs * 64),
        "flash_bwd (ViT-B/16, dropout 0.1)": (
            lambda: flash_attention_bwd(q, k, v, out, do, lse, **kw),
            lambda: flash_attention_bwd_plain(q, k, v, out, do, lse, **kw),
            sdpa_bwd(q, k, v, do, p=0.1, causal=False),
            nbytes(q, k, v, out, do, lse) + nbytes(q, k, v),
            10 * pairs * 64),
    }


# ---------------------------------------------------------------- Llama train

# Llama-3-8B's widths (LLAMA3_8B) cut to 2 layers, fp32 weights and AdamW
# state (about 1.5 B parameters: 24 GB with gradients and both moments),
# bf16 compute; one b=4 x s=2048 batch, the head and loss in chunks of 512
# tokens.
LLAMA_TRAIN = dataclasses.replace(LLAMA3_8B, n_layer=2,
                                  param_dtype=torch.float32)
LLAMA_TRAIN_B, LLAMA_TRAIN_S, LLAMA_LOSS_CHUNK = 4, 2048, 512


def llama_train_batch(cfg):
    """One b=4, s=2048 batch from numpy's default_rng(3)."""
    ids = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (LLAMA_TRAIN_B, LLAMA_TRAIN_S))).to(DEV)
    return {"input_ids": ids, "labels": ids}


def llama_loss(model, batch):
    """The train step's loss: the hidden state through chunked_lm_loss."""
    x, head = model(batch["input_ids"], return_hidden=True)
    return chunked_lm_loss(x, head, batch["labels"], chunk=LLAMA_LOSS_CHUNK,
                           dtype=model.config.dtype)


def phase_llama_train(n_steps=3):
    """The Llama training path at LLAMA_TRAIN: n_steps AdamW steps with
    remat off (falling finite loss, K1 and K2 once per layer per step),
    then at the same weights one backward with remat off and one with remat
    on (the model's config switched: the same module and weights): the same
    loss and gradient norm, and K1 twice per layer with remat. Each setting
    then gets a traced step (busy time; K1/K2 kernels) and timed steps
    (host ms, peak memory). Returns {path: launches}."""
    cfg = LLAMA_TRAIN
    batch = llama_train_batch(cfg)
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"llama train: Llama-3-8B widths cut to {cfg.n_layer} layers, "
          f"{n_params / 1e9:.3f} B parameters (fp32) built in "
          f"{time.perf_counter() - t0:.1f} s")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    step = make_llama_step(model, opt, lm_loss_chunk=LLAMA_LOSS_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = [step(batch) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"llama_train": read_launches(KERNELS)}
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"Llama losses {losses}")
    check(losses[-1] < losses[0], f"Llama loss did not fall: {losses}")
    for name in TRAIN_KERNELS:
        got = launches["llama_train"][name]
        check(got == cfg.n_layer * n_steps,
              f"Llama {name}: {got} launches in {n_steps} steps, want "
              f"{cfg.n_layer} per step")
    check_fp32_training(model, opt, "Llama")
    print(f"llama train: b={LLAMA_TRAIN_B} s={LLAMA_TRAIN_S}, "
          f"lm_loss_chunk={LLAMA_LOSS_CHUNK}, remat off, {n_steps} AdamW "
          f"steps in {dt:.2f} s; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches['llama_train']} [{card_line()}]")

    reset_launches()
    plain = loss_and_norm(lambda: llama_loss(model, batch), model)
    counts = read_launches(TRAIN_KERNELS)
    model.config = dataclasses.replace(cfg, remat=True)
    reset_launches()
    remat = loss_and_norm(lambda: llama_loss(model, batch), model)
    launches["llama_train_remat"] = read_launches(KERNELS)
    got = [launches["llama_train_remat"][name] for name in TRAIN_KERNELS]
    n = cfg.n_layer
    check([counts[name] for name in TRAIN_KERNELS] == [n, n]
          and got == [2 * n, n], f"Llama K1, K2 launches in one backward: "
          f"{counts} without remat, {got} with")
    check(torch.equal(plain[0], remat[0]),
          f"Llama loss with remat {float(remat[0])} != {float(plain[0])}")
    rel = float((remat[1] - plain[1]).abs() / plain[1])
    check(rel <= 1e-6, f"Llama grad norm with remat off by {rel:.3e}")
    print(f"llama train remat at the same weights: loss {float(plain[0]):.6f}"
          f" both, grad norm {float(plain[1]):.6f} vs {float(remat[1]):.6f} "
          f"(rel {rel:.3e}); K1, K2 launches {got} with remat, "
          f"{[counts[n] for n in TRAIN_KERNELS]} without")
    model.zero_grad(set_to_none=True)
    shape = f"b={LLAMA_TRAIN_B} s={LLAMA_TRAIN_S} chunk {LLAMA_LOSS_CHUNK}"
    for flag in (False, True):
        model.config = dataclasses.replace(cfg, remat=flag)
        label = f"llama train (remat {'on' if flag else 'off'})"
        trace_step(label, lambda: step(batch), n * (2 if flag else 1), n)
        phase_train_timing(step, batch, None, warmup=1, n=3, label=label,
                           shape=shape)
    return launches


# ---------------------------------------------------------------- remat

# (remat, remat_policy) and the K1 launches each gives per GPT-2 step.
REMAT_SETTINGS = [(False, None, 12), (True, None, 24), (True, "dots", 24),
                  (True, "dots_flash", 12)]


def gpt2_loss_and_grads(model, batch):
    """Loss and every gradient (one fp32 vector) of one backward with
    dropout seeded from 0."""
    model.zero_grad(set_to_none=True)
    loss = cross_entropy_loss(
        model(batch["input_ids"], deterministic=False,
              generator=torch.Generator().manual_seed(0)), batch["labels"])
    loss.backward()
    return loss.detach(), torch.cat([p.grad.float().flatten()
                                     for p in model.parameters()])


def phase_gpt2_remat(batch):
    """GPT-2 at full width, dropout 0.1, the train phase's batch and
    initial weights, under each of REMAT_SETTINGS: the same loss as without
    remat, every gradient within the 2x rule of the no-remat step against
    the fp32-compute step (same dropout masks), K1 launched the expected
    number of times (once per layer under "dots_flash": its output and lse
    are kept), K2 once per layer; then timed steps (host ms, peak memory)
    and a traced one (busy time, idle share).
    Returns the launches summed over the four backwards."""
    model32 = train_model(GPT2Config(dropout=0.1, dtype=torch.float32))
    _, g32 = gpt2_loss_and_grads(model32, batch)
    del model32
    torch.cuda.empty_cache()
    total, base, card = None, None, card_line()
    for remat, policy, k1 in REMAT_SETTINGS:
        label = f"remat {'on' if remat else 'off'}, policy {policy}"
        model = train_model(GPT2Config(dropout=0.1, remat=remat,
                                       remat_policy=policy))
        reset_launches()
        loss, g = gpt2_loss_and_grads(model, batch)
        launches = read_launches(KERNELS)
        total = launches if total is None else {
            n: total[n] + launches[n] for n in launches}
        got = [launches[name] for name in TRAIN_KERNELS]
        check(got == [k1, 12], f"GPT-2 {label}: K1, K2 launches {got}, want "
              f"{[k1, 12]}")
        if base is None:
            base = (loss, g)
        check(torch.equal(loss, base[0]),
              f"GPT-2 {label}: loss {float(loss)} != {float(base[0])}")
        err, b = assert_two_x_bound(g, g32, base[1], atol=1e-6,
                                    label=f"GPT-2 {label} gradients")
        opt = torch.optim.AdamW(model.parameters(), lr=1e-4,
                                weight_decay=1e-4)
        step = make_train_step(model, opt)
        gen = torch.Generator().manual_seed(0)
        ms = phase_train_timing(step, batch, gen, warmup=1, n=3,
                                label=f"gpt2 train ({label})")
        wall, _, events = trace_call(lambda: step(batch, gen))
        print(f"gpt2 {label}: loss {float(loss):.6f}; K1 {got[0]} and K2 "
              f"{got[1]} launches per step; gradients vs fp32 compute max err "
              f"{err:.3e} (no remat {b:.3e}), vs no remat "
              f"{max_err(g, base[1]):.3e}; step {ms:.2f} ms; traced step: "
              f"{device_summary(wall, events)} [{card}]")
        del model, opt, step, g
        torch.cuda.empty_cache()
    return total


# ---------------------------------------------------------------- BERT

def padding_segments():
    """The BERT batch's padding masks in segment form (dense_timing
    bert_padding)."""
    return Segments(*bert_padding(DEV, BERT_B, BERT_S))


def visible_pairs(seg, causal=False):
    """Visible (query, key) pairs of one head, summed over the batch."""
    return int(segment_mask(seg, causal).sum())


def bert_batch(cfg):
    """One b=32 x s=512 MLM batch from numpy's default_rng(1): real tokens
    up to each row's length, padding id 0 after; 15% of the real tokens
    are replaced by [MASK] (id 103) and carry their original id as the
    label."""
    lengths = bert_lengths(BERT_B, BERT_S)
    rng = np.random.default_rng(1)
    mask = np.arange(BERT_S)[None] < lengths[:, None]
    ids = np.where(mask, rng.integers(1000, cfg.vocab_size,
                                      (BERT_B, BERT_S)), 0)
    label_mask = mask & (rng.random((BERT_B, BERT_S)) < 0.15)

    def dev(x):
        return torch.from_numpy(np.asarray(x, np.int64)).to(DEV)

    return {"input_ids": dev(np.where(label_mask, 103, ids)),
            "attention_mask": dev(mask), "labels": dev(ids),
            "label_mask": dev(label_mask)}


def check_lse(lse, q, k, seg, scale, label):
    """lse against the masked fp32 logsumexp; -inf exactly on rows that
    see no key."""
    s = (q.float() @ k.float().transpose(-1, -2)) * scale
    want = torch.logsumexp(s.masked_fill(~segment_mask(seg, False),
                                         float("-inf")), dim=-1)
    dead = torch.isneginf(want)
    check(torch.equal(torch.isneginf(lse), dead), f"{label}: -inf rows")
    torch.testing.assert_close(lse[~dead], want[~dead], atol=1e-3, rtol=1e-3)


def phase_segment_kernels(gen, errs):
    """K1 and K2 in segment form at BERT's attention shape (b=32 h=12
    s=512 d=64, bf16, the padding masks of the BERT batch, non-causal, on
    views of a fused projection), dropout 0 and 0.1: against their twins
    and against fp32 attention_ref under the equivalent boolean mask (by
    autograd for the gradients), both by the 2x rule (baseline: the bf16
    attention_ref); lse against the masked fp32 logsumexp. Then the
    cu_seqlens interface on the same tokens packed, against the padded
    segment-id route and the oracle; and kvpacked with per-sequence sq !=
    sk, causal. Adds the max errors vs the twins to ``errs``."""
    seg = padding_segments()
    mask = segment_mask(seg, False)
    q, k, v, dout = packed_inputs(gen, BERT_B, 12, 12, BERT_S, 64)
    for p in (0.0, 0.1):
        kw = dict(causal=False, softmax_scale=0.125, dropout_p=p,
                  seed=SEED if p else None, segments=seg)
        out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
        grads = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
        torch.cuda.synchronize()
        twin, _ = flash_attention_fwd_plain(q, k, v, save_lse=False, **kw)
        twin_grads = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
        keep = dropout_mask_dense(SEED, BERT_B, 12, BERT_S, BERT_S, p,
                                  device=DEV) if p else None
        ref = dict(mask=mask, dropout_mask=keep, dropout_p=p)
        native = attention_ref(q, k, v, upcast=False, **ref)
        label = f"segments b={BERT_B} h=12 s={BERT_S} d=64 p={p}"
        err, base = assert_two_x_bound(out, attention_ref(q, k, v, **ref),
                                       native, label=f"flash_fwd {label}")
        assert_two_x_bound(out, twin.float(), native,
                           label=f"flash_fwd vs twin {label}")
        check_lse(lse, q, k, seg, 0.125, f"flash_fwd {label}")
        errs["flash_fwd"] = max(errs["flash_fwd"], max_err(out, twin))
        leaves32 = [x.detach().float().requires_grad_() for x in (q, k, v)]
        attention_ref(*leaves32, **ref).backward(dout.float())
        leaves16 = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        attention_ref(*leaves16, upcast=False, **ref).backward(dout)
        parts = []
        for name, g, tw, o, n in zip("qkv", grads, twin_grads, leaves32,
                                     leaves16):
            e, be = assert_two_x_bound(g, o.grad, n.grad, atol=1e-4,
                                       label=f"flash_bwd d{name} {label}")
            assert_two_x_bound(g, tw.float(), n.grad, atol=1e-4,
                               label=f"flash_bwd d{name} vs twin {label}")
            errs["flash_bwd"] = max(errs["flash_bwd"], max_err(g, tw))
            parts.append(f"d{name} {e:.3e} ({be:.3e})")
        print(f"flash_fwd+bwd {label}: out err vs fp32 {err:.3e} (bf16 "
              f"baseline {base:.3e}); grads vs fp32 autograd (bf16 "
              f"baseline) {', '.join(parts)}; vs twins fwd "
              f"{max_err(out, twin):.3e}")
        del out, lse, grads, twin, twin_grads, keep, native, leaves32, leaves16
        torch.cuda.empty_cache()

    # The same tokens packed: the cu_seqlens interface (qkvpacked) against
    # the padded route, pad_input(packed out) against flash_attention on
    # the padded batch with segment ids; both held to the oracle.
    qkv = torch.stack([x.transpose(1, 2) for x in (q, k, v)], dim=2)
    valid = seg.q_seg >= 0
    packed, idx, cu, max_s = unpad_input(qkv, valid)
    got = pad_input(flash_attn_unpadded_qkvpacked_func(packed, cu, max_s,
                                                       0.0), idx, BERT_B,
                    BERT_S).transpose(1, 2)
    padded = flash_attention(*(x.transpose(1, 2) for x in (q, k, v)),
                             q_segment_ids=seg.q_seg,
                             kv_segment_ids=seg.kv_seg).transpose(1, 2)
    ref32 = attention_ref(q, k, v, mask=mask)
    ref16 = attention_ref(q, k, v, mask=mask, upcast=False)
    e1, base = assert_two_x_bound(got, ref32, ref16,
                                  label="qkvpacked interface vs fp32")
    e2, _ = assert_two_x_bound(got, padded.float(), ref16,
                               label="qkvpacked interface vs padded route")
    print(f"qkvpacked interface, the BERT batch packed ({int(cu[-1])} "
          f"tokens in {BERT_B} sequences): err vs fp32 {e1:.3e} (bf16 "
          f"baseline {base:.3e}), vs pad_input(flash_attention(padded, "
          f"segment ids)) {e2:.3e}")
    # kvpacked: 8 sequences, per-sequence sq != sk, causal (top-left inside
    # each), dropout 0.1: against fp32 attention_ref over the packed
    # tokens with the segment mask (positions included).
    lq, lk = bert_lengths(8, BERT_S, 2), bert_lengths(8, BERT_S, 3)
    cq = torch.from_numpy(np.concatenate([[0], np.cumsum(lq)])).to(
        DEV, torch.int32)
    ck = torch.from_numpy(np.concatenate([[0], np.cumsum(lk)])).to(
        DEV, torch.int32)
    qp = randn(gen, (int(lq.sum()), 12, 64))
    kv = randn(gen, (int(lk.sum()), 2, 12, 64))
    got = flash_attn_unpadded_kvpacked_func(qp, kv, cq, ck, BERT_S, BERT_S,
                                            0.1, causal=True,
                                            dropout_seed=SEED)
    qs, qpos = cu_seqlens_to_segments(cq, len(qp))
    ks, kpos = cu_seqlens_to_segments(ck, len(kv))
    pmask = segment_mask(Segments(qs[None], ks[None], qpos[None],
                                  kpos[None]), True)
    keep = dropout_mask_dense(SEED, 1, 12, len(qp), len(kv), 0.1, device=DEV)
    ref = dict(mask=pmask, dropout_mask=keep, dropout_p=0.1)
    bt = (qp.transpose(0, 1)[None], kv[:, 0].transpose(0, 1)[None],
          kv[:, 1].transpose(0, 1)[None])
    err, base = assert_two_x_bound(
        got.transpose(0, 1)[None], attention_ref(*bt, **ref),
        attention_ref(*bt, upcast=False, **ref),
        label="kvpacked interface sq != sk causal")
    print(f"kvpacked interface, 8 sequences, {int(lq.sum())} queries / "
          f"{int(lk.sum())} keys (per-sequence sq != sk), causal, dropout "
          f"0.1: err vs fp32 {err:.3e} (bf16 baseline {base:.3e})")
    torch.cuda.empty_cache()


def bert_model(cfg):
    return BertForMaskedLM(cfg, device=DEV,
                           generator=torch.Generator(device=DEV).manual_seed(0))


def phase_bert_train(n_steps=4):
    """The BERT main path: BertForMaskedLM(BERT_BASE), fp32 weights and
    AdamW state, bf16 compute in FlashMHA and the MLP, dropout 0.1, n_steps
    on one padded batch. Each step launches K1 and K2 once per layer in
    their segment form (one tile plan per layer). Returns (launches, step,
    batch, generator)."""
    cfg = dataclasses.replace(BERT_BASE, dropout=0.1)
    batch = bert_batch(cfg)
    model = bert_model(cfg)
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    step = make_bert_step(model, opt)
    gen = torch.Generator().manual_seed(0)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = [step(batch, gen) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches(KERNELS)
    losses = [float(x) for x in losses]
    check(all(math.isfinite(x) for x in losses), f"BERT losses {losses}")
    check(losses[-1] < losses[0], f"BERT loss did not fall: {losses}")
    for name in (*TRAIN_KERNELS, "segment plan"):
        check(launches[name] == cfg.n_layer * n_steps,
              f"BERT {name}: {launches[name]} launches in {n_steps} steps, "
              f"want {cfg.n_layer} per step")
    check(all(p.dtype == torch.float32 for p in model.parameters()),
          "non-fp32 BERT parameters")
    n_params = sum(p.numel() for p in model.parameters())
    print(f"bert train: BERT-base ({n_params / 1e6:.1f} M parameters), "
          f"b={BERT_B} s={BERT_S}, {int(batch['attention_mask'].sum())} real "
          f"tokens, {int(batch['label_mask'].sum())} MLM labels, dropout 0.1, "
          f"{n_steps} AdamW steps in {dt:.2f} s; losses "
          f"{', '.join(f'{x:.4f}' for x in losses)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches "
          f"{launches} [{card_line()}]")
    return launches, step, batch, gen


def phase_bert_check(batch):
    """One BERT step at dropout 0 against fp32 compute (the fp32 segment
    kernels; check_step_two_x), the baseline's attention_ref masked by
    the segment ids."""
    check_step_two_x(
        "bert", bert_model, BERT_BASE,
        dataclasses.replace(BERT_BASE, dtype=None),
        lambda m: mlm_loss(m(batch["input_ids"],
                             attention_mask=batch["attention_mask"]),
                           batch["labels"], batch["label_mask"]))
    torch.cuda.empty_cache()


def bert_timing_specs(gen):
    """kernel_timing rows of K1 and K2 in segment form at BERT's attention
    shape (the BERT batch's padding masks, dropout 0.1, lse saved; K1's row
    includes its tile plan, made inside the call as on the path, K2 reuses
    the forward's) and the plan alone (the same kernels without a mask are
    dense_timing.py's "BERT" rows). Bound: the real rows of q, k, v (and o, dout for
    K2) read once, o (dq, dk, dv) written whole; products over the visible
    pairs only (4 d flops each forward, 10 d backward). Library: SDPA with
    the boolean key-padding mask (b, 1, 1, s) as attn_mask (every query row
    attends the real keys). Returns (specs, a call making the plan
    alone)."""
    seg = padding_segments()
    q, k, v, dout = packed_inputs(gen, BERT_B, 12, 12, BERT_S, 64)
    kw = dict(causal=False, softmax_scale=0.125, dropout_p=0.1, seed=SEED)
    plan = Segments(seg.q_seg, seg.kv_seg, seg.q_pos, seg.kv_pos)
    o, lse = flash_attention_fwd(q, k, v, save_lse=True, segments=plan, **kw)
    pairs = visible_pairs(seg) * 12
    real = int((seg.q_seg >= 0).sum()) / (BERT_B * BERT_S)
    row = nbytes(q)  # one (b, h, s, d) bf16 operand
    key_mask = (seg.kv_seg >= 0)[:, None, None, :]

    def fresh():
        return Segments(seg.q_seg, seg.kv_seg, seg.q_pos, seg.kv_pos)

    return {
        "flash_fwd (BERT, segments, dropout 0.1, lse)": (
            lambda: flash_attention_fwd(q, k, v, save_lse=True,
                                        segments=fresh(), **kw),
            lambda: flash_attention_fwd_plain(q, k, v, save_lse=True,
                                              segments=seg, **kw),
            sdpa_fwd(q, k, v, p=0.1, mask=key_mask),
            3 * real * row + row + nbytes(lse), 4 * 64 * pairs),
        "flash_bwd (BERT, segments, dropout 0.1)": (
            lambda: flash_attention_bwd(q, k, v, o, dout, lse,
                                        segments=plan, **kw),
            lambda: flash_attention_bwd_plain(q, k, v, o, dout, lse,
                                              segments=seg, **kw),
            sdpa_bwd(q, k, v, dout, p=0.1, mask=key_mask),
            5 * real * row + 3 * row + nbytes(lse), 10 * 64 * pairs),
    }, lambda: segment_plan(fresh(), False)


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


def bs_timing_specs():
    """kernel_timing rows of K8a, K8b and K8c at BS_SHAPES (i) and (ii),
    on dense_timing's inputs, and of dense K1 and K2 at shape (ii) (at
    shape (i) they are the train step's rows). Library: SDPA with the
    element mask as attn_mask, its forward, and its backward for (k, v)
    and for q. Each K8 row also carries its live 64x64 tiles and their
    products' operations (4d, 8d, 6d per pair of a whole tile): the bound
    stays on visible pairs, and the rate on live tiles shows how far the
    tile granularity sits from it."""
    specs = {}
    inputs = k8b_inputs(DEV)
    for shape, suffix in (("(i) GPT-2 train", ""),
                          ("(ii) config 4", " (config 4)")):
        q, k, v, dout, layout, p = inputs[shape]
        b, h, s, d = q.shape
        kw = dict(softmax_scale=d ** -0.5, dropout_p=p,
                  seed=SEED if p else None)
        out, lse = blocksparse_attention_fwd(q, k, v, layout, **kw)
        di = (out.float() * dout.float()).sum(-1)
        mask = layout.visible(DEV)
        pairs = int(mask.sum()) * b * h
        tiles = int(layout.kv_counts.sum()) * b * h
        tile_pairs = tiles * 64 * 64
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
            nbytes(q, k, v, q, lse) + kv_lists, 4 * pairs * d,
            (tiles, 4 * tile_pairs * d))
        specs["blocksparse_dkv" + suffix] = (
            lambda a=bwd, kw=kw: blocksparse_attention_dkv(*a, **kw),
            plain_bwd,
            sdpa_bwd(q, k, v, dout, p=p, mask=mask, wrt="kv"),
            nbytes(q, k, v, dout, lse, di, k, v) + q_lists, 8 * pairs * d,
            (tiles, 8 * tile_pairs * d))
        specs["blocksparse_dq" + suffix] = (
            lambda a=bwd, kw=kw: blocksparse_attention_dq(*a, **kw),
            plain_bwd,
            sdpa_bwd(q, k, v, dout, p=p, mask=mask, wrt="q"),
            nbytes(q, k, v, dout, lse, di, q) + kv_lists, 6 * pairs * d,
            (tiles, 6 * tile_pairs * d))
    return specs


def print_sparsity_pays(times):
    """K8 against dense K1/K2 at the GPT-2 train step's shape (config 4's
    dense rows are dense_timing.py's "config 4" rows)."""
    def ms(name):
        return times[name][0]

    for label, suffix, fwd, bwd in (
            ("(i) GPT-2 train, dropout 0.1", "",
             "flash_fwd (train step, dropout 0.1, lse)", "flash_bwd"),):
        k8_bwd = ms("blocksparse_dkv" + suffix) + ms("blocksparse_dq" + suffix)
        print(f"sparsity at {label}: K8a {ms('blocksparse_fwd' + suffix):.4f}"
              f" ms vs dense K1 {ms(fwd):.4f} ms; K8b + K8c {k8_bwd:.4f} ms "
              f"vs dense K2 {ms(bwd):.4f} ms [{card_line()}]")


# ---------------------------------------------------------------- M4

# Mistral-7B-v0.1 (mistralai/Mistral-7B-v0.1 config.json: vocab 32000, 32
# layers, hidden 4096, 32/8 heads of 128, intermediate 14336,
# sliding_window 4096, rope_theta 10000, 32768 positions, rms_norm_eps
# 1e-5, untied head), bf16.
MISTRAL_7B = LlamaConfig(
    vocab_size=32000, n_layer=32, n_embd=4096, n_head=32, n_kv_head=8,
    intermediate_size=14336, rope_theta=10000.0,
    max_position_embeddings=32768, rms_norm_eps=1e-5, window=MISTRAL_WINDOW,
    dtype=BF16, param_dtype=BF16)
# K1/K2's band checks: label, (b, h, h_kv, s, d, causal), (left, right,
# sinks, ALiBi, softcap), segment form (BERT's padding masks).
WINDOW_KERNEL_CASES = [
    ("Mistral train: causal window 4096", (2, 32, 8, 8192, 128, True),
     (4096, None, 0, False, None), False),
    ("BERT segments: window (128, 128) + ALiBi", (32, 12, 12, 512, 64, False),
     (128, 128, 0, True, None), True),
    ("GPT-2 train: ALiBi alibi_slopes(12)", (8, 12, 12, 1024, 64, True),
     (None, None, 0, True, None), False),
    ("softcap 50 on a causal window 512", (2, 16, 4, 2048, 128, True),
     (512, None, 0, False, 50.0), False),
    ("causal window 1024 + 4 sinks", (2, 8, 8, 4096, 64, True),
     (1024, None, 4, False, None), False),
]


def band_of(spec, b, h, scale):
    """The kernels' Band of a (left, right, sinks, ALiBi, softcap) spec and
    the slopes (h,) it was made from (None without ALiBi)."""
    left, right, sinks, alibi, softcap = spec
    slopes = alibi_slopes(h).to(DEV) if alibi else None
    return Band(left, right, sinks, softcap, None if slopes is None else (
        slopes / scale)[None].expand(b, h).contiguous()), slopes


def band_slice(band, group):
    """``band`` on batch row 0 and query heads [0, group)."""
    return dataclasses.replace(band, alibi=None if band.alibi is None
                               else band.alibi[:1, :group].contiguous())


def band_oracle(q, k, v, causal, spec, slopes, seg, dout=None, upcast=True):
    """attention_ref on (1, group, s, d) slices under the band's mask,
    ALiBi bias and softcap (segment ids and positions by ``seg``): the
    output, or with ``dout`` the gradients by autograd."""
    left, right, sinks, _, softcap = spec
    s = q.shape[2]
    pos = {} if seg is None else dict(
        q_positions=seg.q_pos, kv_positions=seg.kv_pos)
    mask = build_mask(s, s, causal=causal, window_left=left,
                      window_right=right, num_sinks=sinks, device=DEV,
                      **({} if seg is None else dict(
                          q_segment_ids=seg.q_seg, kv_segment_ids=seg.kv_seg,
                          **pos)))
    if mask.dim() == 3:
        mask = mask[:, None]
    bias = None if slopes is None else alibi_bias(
        slopes[:q.shape[1]], s, s, causal=causal, **pos)
    leaves = [(x.float() if upcast else x).detach().requires_grad_(
        dout is not None) for x in (q, k, v)]
    out = attention_ref(*leaves, causal=causal and seg is None, mask=mask,
                        bias=bias, softcap=softcap, upcast=upcast)
    if dout is None:
        return out
    out.backward(dout.to(out.dtype))
    return [x.grad for x in leaves]


def phase_window_kernels(gen, errs):
    """K1 and K2 with the band terms (WINDOW_KERNEL_CASES), bf16 and fp32,
    launched on the whole shape and held on batch row 0 and the first kv
    head's query group to their twins and the 2x rule (oracle: fp32
    attention_ref under the same mask, bias and softcap, by autograd for
    the gradients; baseline: the same-dtype attention_ref); then K5 and K6
    with a window, sinks, softcap and ALiBi at Mistral's decode and chunk
    shapes, and with every page wholly below each sequence's band (sink
    pages aside) poisoned with NaN: finite and bit for bit the same, as
    those pages are never fetched. Adds the max errors vs the twins to
    ``errs`` ("window <kernel>")."""
    for name in ("flash_fwd", "flash_bwd", "paged_decode", "paged_chunk"):
        errs[f"window {name}"] = 0.0
    for label, (b, h, h_kv, s, d, causal), spec, segmented in \
            WINDOW_KERNEL_CASES:
        group, scale = h // h_kv, d ** -0.5
        seg = padding_segments() if segmented else None
        for dtype in (BF16, torch.float32):
            q, k, v, dout = (randn(gen, (b, n, s, d), dtype)
                             for n in (h, h_kv, h_kv, h))
            band, slopes = band_of(spec, b, h, scale)
            kw = dict(causal=causal, softmax_scale=scale)
            out, lse = flash_attention_fwd(q, k, v, save_lse=True,
                                           segments=seg, band=band, **kw)
            grads = flash_attention_bwd(q, k, v, out, dout, lse,
                                        segments=seg, band=band, **kw)
            torch.cuda.synchronize()
            qs, ks, vs, ds, os_ = (x[:1, :n] for x, n in (
                (q, group), (k, 1), (v, 1), (dout, group), (out, group)))
            seg1 = None if seg is None else Segments(
                *(x[:1].contiguous() for x in (seg.q_seg, seg.kv_seg,
                                               seg.q_pos, seg.kv_pos)))
            kws = dict(kw, segments=seg1, band=band_slice(band, group))
            twin, _ = flash_attention_fwd_plain(qs, ks, vs, save_lse=False,
                                                **kws)
            twins = flash_attention_bwd_plain(
                qs, ks, vs, os_, ds, lse[:1, :group].contiguous(), **kws)
            tag = f"{label} {str(dtype)[6:]}"
            err, base = assert_two_x_bound(
                os_, band_oracle(qs, ks, vs, causal, spec, slopes, seg1),
                band_oracle(qs, ks, vs, causal, spec, slopes, seg1,
                            upcast=False), label=f"window flash_fwd {tag}")
            fwd_twin = max_err(os_, twin)
            oracle = band_oracle(qs, ks, vs, causal, spec, slopes, seg1, ds)
            native = band_oracle(qs, ks, vs, causal, spec, slopes, seg1, ds,
                                 upcast=False)
            parts, bwd_twin = [], 0.0
            for name, g, tw, o, n in zip(
                    "qkv", [x[:1, :m] for x, m in zip(grads, (group, 1, 1))],
                    twins, oracle, native):
                e, be = assert_two_x_bound(
                    g, o, n, atol=1e-4, label=f"window flash_bwd d{name} "
                    f"{tag}")
                bwd_twin = max(bwd_twin, max_err(g, tw))
                parts.append(f"d{name} {e:.3e} ({be:.3e})")
            errs["window flash_fwd"] = max(errs["window flash_fwd"], fwd_twin)
            errs["window flash_bwd"] = max(errs["window flash_bwd"], bwd_twin)
            print(f"window flash_fwd+bwd {tag} b={b} h={h}/{h_kv} s={s} "
                  f"d={d}: out err vs fp32 {err:.3e} (baseline {base:.3e}); "
                  f"grads (baseline) {', '.join(parts)}; vs twins fwd "
                  f"{fwd_twin:.3e} bwd {bwd_twin:.3e}")
            del q, k, v, dout, out, lse, grads, twin, twins, oracle, native
            torch.cuda.empty_cache()

    _, (qd, pages, lens, table), (qc, _, _, _, chunk) = window_inputs(DEV)
    kp, vp = pages.k_pages, pages.v_pages
    h = qd.shape[1]
    for terms in (dict(window_left=MISTRAL_WINDOW),
                  dict(window_left=MISTRAL_WINDOW, num_sinks=4),
                  dict(window_left=MISTRAL_WINDOW, num_sinks=4, softcap=50.0,
                       alibi_slopes=alibi_slopes(h).to(DEV))):
        # Sinks are decode-only: K6 takes the other terms.
        terms6 = {k: x for k, x in terms.items() if k != "num_sinks"}
        tt = (terms["window_left"], terms.get("num_sinks", 0),
              terms.get("alibi_slopes"), terms.get("softcap"))
        tag, tag6 = (", ".join(t) for t in (terms, terms6))
        k5 = paged_decode_attention(qd, kp, vp, lens, table, **terms)
        k6 = paged_chunk_attention(qc, kp, vp, lens, table, chunk_lens=chunk,
                                   **terms6)
        torch.cuda.synchronize()
        one = torch.ones_like(lens)
        err5, base5 = assert_two_x_bound(
            k5, paged_chunk_ref(qd[:, None], kp, vp, lens, table, one,
                                **terms)[:, 0],
            paged_chunk_ref(qd[:, None], kp, vp, lens, table, one,
                            upcast=False, **terms)[:, 0],
            label=f"window paged_decode ({tag})")
        err6, base6 = assert_two_x_bound(
            k6, paged_chunk_ref(qc, kp, vp, lens, table, chunk, **terms6),
            paged_chunk_ref(qc, kp, vp, lens, table, chunk, upcast=False,
                            **terms6), label=f"window paged_chunk ({tag6})")
        scale = qd.shape[-1] ** -0.5
        t5 = max_err(k5, paged_decode_attention_plain(
            qd, kp, vp, lens, table, softmax_scale=scale, terms=tt))
        t6 = max_err(k6, paged_chunk_attention_plain(
            qc, kp, vp, lens, table, chunk_lens=chunk, softmax_scale=scale,
            terms=(tt[0], 0, *tt[2:])))
        errs["window paged_decode"] = max(errs["window paged_decode"], t5)
        errs["window paged_chunk"] = max(errs["window paged_chunk"], t6)
        print(f"window paged_decode Mistral decode ({tag}), "
              f"{decode_splits(qd, kp, table, MISTRAL_WINDOW)} splits: err "
              f"vs fp32 {err5:.3e} (bf16 baseline {base5:.3e}), vs twin "
              f"{t5:.3e}; paged_chunk Mistral chunk sq={qc.shape[1]} "
              f"({tag6}): err {err6:.3e} (baseline {base6:.3e}), vs twin "
              f"{t6:.3e}")
        if terms.get("num_sinks") and "softcap" not in terms:
            poisoned_k, poisoned_v = kp.clone(), vp.clone()
            n_pages = 0
            for i, n in enumerate(lens.tolist()):
                floor = n - int(chunk[i]) - MISTRAL_WINDOW  # K6's first row
                for j in range(1, max(0, floor) // kp.shape[2]):
                    poisoned_k[:, table[i, j]] = float("nan")
                    poisoned_v[:, table[i, j]] = float("nan")
                    n_pages += 1
            p5 = paged_decode_attention(qd, poisoned_k, poisoned_v, lens,
                                        table, **terms)
            p6 = paged_chunk_attention(qc, poisoned_k, poisoned_v, lens,
                                       table, chunk_lens=chunk, **terms6)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(p5).all()) and torch.equal(p5, k5),
                  "K5 read a page below the band")
            check(bool(torch.isfinite(p6).all()) and torch.equal(p6, k6),
                  "K6 read a page below the band")
            print(f"window NaN poison: {n_pages} pages wholly below the "
                  "bands (sink pages aside) set to NaN; K5 and K6 outputs "
                  "finite and bit for bit the unpoisoned ones")
            del poisoned_k, poisoned_v
    del qd, qc, pages, kp, vp
    torch.cuda.empty_cache()


def phase_window_determinism(gen, n=10):
    """K1 + K2 with Mistral's window and 4 sinks at its train shape: out,
    lse, dq, dk and dv bit for bit over ``n`` seeded reruns (the dQ ranks
    follow the band's walks)."""
    b, h, h_kv, s, d = MISTRAL_TRAIN
    q, k, v, dout = packed_inputs(gen, b, h, h_kv, s, d)
    kw = dict(causal=True, softmax_scale=d ** -0.5,
              band=Band(MISTRAL_WINDOW, None, 4))

    def run():
        out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
        return (out, lse, *flash_attention_bwd(q, k, v, out, dout, lse,
                                               **kw))
    first = [x.clone() for x in run()]
    for _ in range(n - 1):
        again = run()
        torch.cuda.synchronize()
        for i, (a, b_) in enumerate(zip(first, again)):
            check(torch.equal(a, b_), f"determinism windowed K2: output {i} "
                  "differs between runs")
    print(f"determinism flash_fwd + flash_bwd Mistral train b={b} h={h}/"
          f"{h_kv} s={s} d={d}, window {MISTRAL_WINDOW} + 4 sinks: {n} "
          "seeded reruns bit for bit equal (out, lse, dq, dk, dv)")


def check_no_sdpa(label, names):
    sdpa = sorted(n for n in names if n.startswith(
        ("aten::_scaled_dot_product", "aten::_efficient_attention",
         "aten::_flash_attention", "aten::scaled_dot_product")))
    check(not sdpa, f"SDPA ops in {label}: {sdpa}")


def phase_mistral_serving(rng, prompts=(1000, 7000), tf_prompt=5000):
    """Mistral-7B-v0.1's published widths and depth, bf16, random weights:
    8 requests (prompts 1000..7000, past the 4096 window) x 32 tokens
    through the chunked engine (chunks of 512, page 128), once with
    stream_free_pages and once without: every request finishes, the tokens
    are the same, pages freed and peak pages printed for each; a traced
    admission and decode step launch K6, K7c and K5 and no SDPA op; then a
    5000-token prompt in chunks of 512 + 16 decode steps held to the 2x
    rule against the same weights in fp32 (the full forward: 32 windowed
    K1 launches). Returns {path: launches}."""
    cfg = MISTRAL_7B
    t0 = time.perf_counter()
    model = LlamaForCausalLM(
        cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"mistral: Mistral-7B-v0.1 widths, {n_params / 1e9:.3f} B "
          f"parameters (bf16), window {cfg.window}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    lens = np.linspace(*prompts, 8).astype(int)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in lens]
    pages_per_seq = -(-(int(lens.max()) + 40) // 128)
    kw = dict(model_fns=llama_decode, max_batch=8, page_size=128,
              pages_per_seq=pages_per_seq, num_pages=8 * pages_per_seq + 1,
              prefill_chunk=512)
    tokens, launches = {}, {}
    for stream in (True, False):
        engine = ServingEngine(model, cfg, stream_free_pages=stream, **kw)
        for p in prompts:
            engine.submit(p, max_new_tokens=32)
        reset_launches()
        t1 = time.perf_counter()
        finished = engine.run(max_steps=1000)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t1
        counts = read_launches(KERNELS)
        label = f"mistral chunked, stream_free_pages={stream}"
        check_finished(label, finished, len(prompts), cfg, 32,
                       pages_per_seq * 128)
        for name in CHUNKED_KERNELS:
            check(counts[name] > 0, f"{label}: kernel {name} not launched")
        check(counts["flash_fwd"] == 0, f"{label}: the dense forward ran")
        check_fused_appends(label, counts, decode=True)
        check_chain_launches(label, counts, cfg.n_layer)
        tokens[stream] = {r.seq_id: r.generated for r in finished}
        print(f"{label}: 8 requests (prompts {lens.min()}..{lens.max()}, "
              f"chunks of 512) x 32 tokens in {dt:.2f} s; pages freed "
              f"mid-flight {engine.pages_freed}, peak pages in use "
              f"{engine.peak_pages} of {engine.alloc.capacity}; launches "
              f"{counts} [{card_line()}]")
        if stream:
            launches["mistral_serve"] = counts
            check(engine.pages_freed > 0, "no page freed by the stream")
            peak_stream = engine.peak_pages
        else:
            check(engine.pages_freed == 0, "pages freed with the stream off")
            check(peak_stream < engine.peak_pages,
                  f"streaming release peak {peak_stream} not below "
                  f"{engine.peak_pages}")
        del engine
        torch.cuda.empty_cache()
    check(tokens[True] == tokens[False],
          "tokens differ with stream_free_pages on and off")
    print("mistral chunked: the same 256 tokens with streaming release on "
          "and off")

    engine = ServingEngine(model, cfg, **kw)
    # Capture this engine's graphs (an 8-row chunk, a decode step) before
    # the trace: a capture inside it queues launches that never run.
    for p in prompts:
        engine.submit(p[:512], max_new_tokens=2)
    engine.run()
    for p in prompts:
        engine.submit(p, max_new_tokens=8)
    wall, names, events = trace_call(engine._admit)
    check_no_sdpa("the Mistral admission", names)
    dev_names = [e["name"] for e in device_events(events)]
    check(any("paged_chunk_wgmma" in n for n in dev_names)
          and any("write_pages" in n for n in dev_names),
          "Mistral admission trace: no K6 / K7c kernel")
    print(f"mistral admission of 8 traced: {device_summary(wall, events)}; "
          "K6 and K7c kernels, no SDPA op")
    engine.step()
    wall, names, events = trace_call(engine.step)
    check_no_sdpa("a Mistral decode step", names)
    check(any("paged_decode" in e["name"] for e in device_events(events)),
          "Mistral decode trace: no K5 kernel")
    print(f"mistral decode step at batch 8 traced: "
          f"{device_summary(wall, events)}; K5 kernels, no SDPA op "
          f"[{card_line()}]")
    del engine
    torch.cuda.empty_cache()

    prompt_len, n_decode = tf_prompt, 16
    ids = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (1, prompt_len + n_decode))).to(DEV)
    positions, served = serve_teacher_forced(model, cfg, llama_decode, ids,
                                             prompt_len, 512, n_decode)
    reset_launches()
    with torch.no_grad():
        full16 = model(ids)[0, positions]
        k1 = read_launches(KERNELS)["flash_fwd"]
        check(k1 == cfg.n_layer, f"Mistral full forward: {k1} K1 launches")
        launches["mistral_forward"] = read_launches(KERNELS)
        chain = [launches["mistral_forward"][n] for n in CHAIN_KERNELS]
        check(chain == [0, 0, 0], "Mistral full forward (the training "
              f"path's) launched the serving chain: {chain}")
        model32 = llama_fp32(model)
        del model
        torch.cuda.empty_cache()
        full32 = model32(ids)[0, positions]
    del model32
    torch.cuda.empty_cache()
    result = check_teacher_forced("mistral chunked teacher forcing", served,
                                  full32, full16)
    print(f"mistral chunked teacher forcing: {prompt_len}-token prompt in "
          f"chunks of 512 + {n_decode} decode steps (window {cfg.window}), "
          f"{result}; the reference forward launched K1 {k1} times")
    return launches


MISTRAL_TRAIN_CFG = dataclasses.replace(MISTRAL_7B, n_layer=2,
                                        param_dtype=torch.float32)
MISTRAL_TRAIN_B, MISTRAL_TRAIN_S = MISTRAL_TRAIN[0], MISTRAL_TRAIN[3]


def phase_mistral_train(n_steps=3):
    """Mistral-7B's widths cut to 2 layers (fp32 weights, bf16 compute),
    b=2 s=8192 so that the 4096 window bites, the head and loss in chunks
    of 512: n_steps AdamW steps with falling finite loss, K1 and K2 twice
    per step (windowed), no SDPA op in a traced step; one step's loss and
    gradient norm at the initial weights held to the 2x rule against fp32
    compute (baseline: bf16 with attention through the windowed
    attention_ref). Returns {path: launches}."""
    cfg = MISTRAL_TRAIN_CFG
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (MISTRAL_TRAIN_B, MISTRAL_TRAIN_S))).to(DEV)
    batch = {"input_ids": ids, "labels": ids}
    model = LlamaForCausalLM(
        cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0))
    opt = torch.optim.AdamW(model.parameters(), lr=1e-4, weight_decay=1e-4)
    step = make_llama_step(model, opt, lm_loss_chunk=LLAMA_LOSS_CHUNK)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    losses = [float(step(batch)) for _ in range(n_steps)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"mistral_train": read_launches(KERNELS)}
    check(all(math.isfinite(x) for x in losses), f"Mistral losses {losses}")
    check(losses[-1] < losses[0], f"Mistral loss did not fall: {losses}")
    for name in TRAIN_KERNELS:
        got = launches["mistral_train"][name]
        check(got == cfg.n_layer * n_steps, f"Mistral {name}: {got} "
              f"launches in {n_steps} steps, want {cfg.n_layer} per step")
    check_fp32_training(model, opt, "Mistral")
    print(f"mistral train: Mistral-7B widths cut to {cfg.n_layer} layers, "
          f"b={MISTRAL_TRAIN_B} s={MISTRAL_TRAIN_S} window {cfg.window}, "
          f"lm_loss_chunk={LLAMA_LOSS_CHUNK}, {n_steps} AdamW steps in "
          f"{dt:.2f} s; losses {', '.join(f'{x:.4f}' for x in losses)}; peak "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
          f"launches {launches['mistral_train']} [{card_line()}]")
    trace_step("mistral train", lambda: step(batch), cfg.n_layer, cfg.n_layer,
               band=True)
    del step, opt, model
    torch.cuda.empty_cache()

    # The check at the initial weights: three steps on one batch take its
    # loss near 0, where the comparison says little.
    check_step_two_x(
        "mistral train",
        lambda c: LlamaForCausalLM(c, device=DEV, generator=torch.Generator(
            device=DEV).manual_seed(0)),
        cfg, dataclasses.replace(cfg, dtype=torch.float32),
        lambda m: llama_loss(m, batch), module=llama_module)
    return launches


# GPT-2 at full width with a window of 256 and StreamingLLM's 4 sinks.
GPT2_STREAM = GPT2Config(param_dtype=BF16, window=256, window_sinks=4)


def phase_gpt2_stream(rng, n_req=8, prompt_len=500, new_tokens=64):
    """GPT-2 at full width (bf16) with window 256 and 4 StreamingLLM sinks
    (decode only): 8 requests of 500-token prompts x 64 tokens through the
    engine with streaming release (every request finishes, pages freed);
    then one prompt served (chunks of 256, then 64 decode steps) and held
    to the 2x rule against a dense reference whose mask is the band for
    the prompt's rows and the band plus the sinks for the decoded rows
    (fp32 oracle; bf16 baseline), not against teacher forcing through the
    full forward (sinks are decode-only). Returns its launches."""
    cfg = GPT2_STREAM
    model = GPT2LMHeadModel(
        cfg, device=DEV, generator=torch.Generator(device=DEV).manual_seed(0))
    prompts = [rng.integers(0, cfg.vocab_size, prompt_len).tolist()
               for _ in range(n_req)]
    kw = dict(max_batch=8, page_size=128, pages_per_seq=8, num_pages=65,
              prefill_chunk=256)
    engine = ServingEngine(model, cfg, **kw)
    for p in prompts:
        engine.submit(p, max_new_tokens=new_tokens)
    reset_launches()
    finished = engine.run(max_steps=1000)
    torch.cuda.synchronize()
    launches = read_launches(KERNELS)
    check_finished("gpt2 stream", finished, n_req, cfg, new_tokens,
                   cfg.max_position_embeddings)
    check(engine.pages_freed > 0, "gpt2 stream: no page freed")
    check_fused_appends("gpt2 stream", launches, decode=True)
    print(f"gpt2 stream: window 256 + 4 sinks, {n_req} requests x "
          f"{prompt_len}-token prompts x {new_tokens} tokens; pages freed "
          f"{engine.pages_freed}, peak pages {engine.peak_pages}; launches "
          f"{launches}")
    del engine

    ids = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, prompt_len + new_tokens))).to(DEV)
    positions, served = serve_teacher_forced(model, cfg, gpt2_decode, ids,
                                             prompt_len, 256, new_tokens)
    s = ids.shape[1]
    i = torch.arange(s, device=DEV)[:, None]
    j = torch.arange(s, device=DEV)[None]
    mask = (j <= i) & ((j >= i - cfg.window)
                       | ((i >= prompt_len) & (j < cfg.window_sinks)))

    def reference(upcast):
        def attn(q, k, v, dropout_seed=None):
            tr = lambda x: x.transpose(1, 2)  # noqa: E731
            return tr(attention_ref(tr(q), tr(k), tr(v), mask=mask,
                                    upcast=upcast))
        return attn

    full = {}
    for dtype in (BF16, torch.float32):
        ref = GPT2LMHeadModel(
            dataclasses.replace(cfg, dtype=dtype, param_dtype=dtype),
            device=DEV, generator=torch.Generator(device=DEV).manual_seed(0),
            attn_impl=reference(dtype == torch.float32))
        ref.load_state_dict(model.state_dict())
        with torch.no_grad():
            full[dtype] = ref(ids)[0, positions]
        del ref
    result = check_teacher_forced("gpt2 stream vs band+sinks reference",
                                  served, full[torch.float32], full[BF16])
    print(f"gpt2 stream: a {prompt_len}-token prompt in chunks of 256 + "
          f"{new_tokens} decode steps against the dense band+sinks "
          f"reference, {result}")
    del model
    torch.cuda.empty_cache()
    return launches


def window_timing(gen):
    """The window rows (dense_timing.window_rows' shapes): each kernel with
    Mistral's window, the same kernel without it on the same tensors, and
    for K1 / K2 SDPA with the band as a boolean attn_mask built outside the
    timed call (K5 and K6 have no one-call library equivalent); bounds over
    the visible pairs and the keys the band holds. Returns {kernel:
    record} for the kernels' JSON ``window`` entries."""
    card = card_line()
    (q, k, v, dout, o, lse), (qd, pages, lens, table), \
        (qc, _, _, _, chunk) = window_inputs(DEV)
    b, h, h_kv, s, d = MISTRAL_TRAIN
    L = MISTRAL_WINDOW
    kw = dict(causal=True, softmax_scale=d ** -0.5)
    band = Band(L)
    mask = build_mask(s, s, causal=True, window_left=L, device=DEV)
    pairs = b * h * band_pairs(s, s, L)
    kp, vp = pages.k_pages, pages.v_pages
    n = lens.tolist()
    keys5 = sum(min(x, L + 1) for x in n)
    c = int(chunk[0])
    keys6 = sum(x - max(0, x - c - L) for x in n)
    pairs6 = sum(min(x - c + t, L) + 1 for x in n for t in range(c))
    tables = nbytes(lens, table, chunk)
    scale = d ** -0.5
    terms = (L, 0, None, None)
    # name: (kernel, the kernel without the window, plain twin or None (the
    # dense twins' fp32 scores at this shape would not fit on the card),
    # library call or None, bytes, operations, shape)
    specs = {
        "flash_fwd": (
            lambda: flash_attention_fwd(q, k, v, save_lse=True, band=band,
                                        **kw),
            lambda: flash_attention_fwd(q, k, v, save_lse=True, **kw),
            None, sdpa_fwd(q, k, v, mask=mask),
            nbytes(q, k, v, o, lse), 4 * pairs * d,
            f"Mistral train b{b} h{h}/{h_kv} s{s} d{d} causal, window {L}, "
            "lse"),
        "flash_bwd": (
            lambda: flash_attention_bwd(q, k, v, o, dout, lse, band=band,
                                        **kw),
            lambda: flash_attention_bwd(q, k, v, o, dout, lse, **kw),
            None, sdpa_bwd(q, k, v, dout, mask=mask),
            nbytes(q, k, v, o, dout, lse) + nbytes(q, k, v), 10 * pairs * d,
            f"Mistral train b{b} h{h}/{h_kv} s{s} d{d} causal, window {L}"),
        "paged_decode": (
            lambda: paged_decode_attention(qd, kp, vp, lens, table,
                                           window_left=L),
            lambda: paged_decode_attention(qd, kp, vp, lens, table),
            lambda: paged_decode_attention_plain(
                qd, kp, vp, lens, table, softmax_scale=scale, terms=terms),
            None, 2 * nbytes(qd) + 2 * keys5 * h_kv * d * 2 + tables,
            4 * keys5 * h * d,
            f"Mistral decode b{len(n)} h{h}/{h_kv} d{d} page 128, contexts "
            f"{n[0]}..{n[-1]}, window {L}"),
        "paged_chunk": (
            lambda: paged_chunk_attention(qc, kp, vp, lens, table,
                                          chunk_lens=chunk, window_left=L),
            lambda: paged_chunk_attention(qc, kp, vp, lens, table,
                                          chunk_lens=chunk),
            lambda: paged_chunk_attention_plain(
                qc, kp, vp, lens, table, chunk_lens=chunk,
                softmax_scale=scale, terms=terms),
            None, 2 * nbytes(qc) + 2 * keys6 * h_kv * d * 2 + tables,
            4 * pairs6 * h * d,
            f"Mistral chunk b{len(n)} sq{c} h{h}/{h_kv} d{d} page 128, "
            f"lengths {n[0]}..{n[-1]}, window {L}"),
    }
    records = {}
    for name, (kern, full, plain, library, n_bytes, flops, shape) in \
            specs.items():
        t_row = time.perf_counter()
        n = 3 if library is not None else 10  # K1/K2 calls take ms each
        k1, u1, k2 = (busy_ms(kern, n=n), busy_ms(full, n=n),
                      busy_ms(kern, n=n))
        p1 = None if plain is None else busy_ms(plain, n=3)
        lib_ms = backend = None
        lib = "none"
        if library is not None:
            lib_ms, backend, each = sdpa_fastest(library, n=n)
            lib = f"{lib_ms:.4f} ms ({backend}; " + ", ".join(
                f"{bk} {'refused' if t is None else f'{t:.4f}'}"
                for bk, t in each.items()) + ")"
        b_ms, b_by = bound(n_bytes, flops)
        records[name] = {"shape": shape, "ms": min(k1, k2),
                         "unwindowed_ms": u1, "plain_ms": p1,
                         "bound_ms": b_ms,
                         "bound_by": b_by, "library_ms": lib_ms,
                         "library_backend": backend}
        plain_txt = ("not measured" if p1 is None else f"{p1:.4f} ms")
        print(f"{name} ({shape}): kernel {k1:.4f} / {k2:.4f} ms, without "
              f"the window {u1:.4f} ms (ratio {min(k1, k2) / u1:.3f}), "
              f"plain {plain_txt}, library {lib}, bound {b_ms:.4f} ms ({b_by}: "
              f"{n_bytes / 1e6:.1f} MB, {flops / 1e9:.2f} GFLOP over the "
              f"visible pairs) [{card}]; row timed in "
              f"{time.perf_counter() - t_row:.1f} s")
    print("window rows: library = SDPA with the band as a boolean attn_mask "
          "(enable_gqa), the fastest backend that accepts it; bounds count "
          "each input read once (K5/K6: the keys the band holds), each "
          "output written once and the products over the visible pairs; "
          "the unwindowed time is the same kernel on the same tensors")
    del q, k, v, dout, o, lse, qd, qc, pages, kp, vp, mask
    torch.cuda.empty_cache()
    return records


def main():
    t_start = time.perf_counter()
    phase_device()
    phase_build_report()
    gen = torch.Generator(device=DEV).manual_seed(0)
    rng = np.random.default_rng(0)
    with phase_time("kernel checks"):
        errs = phase_kernels(gen)
        phase_chunk_kernels(gen, errs)
        phase_fused_kernels()
        phase_train_kernels(gen, errs)
        phase_segment_kernels(gen, errs)
        phase_window_kernels(gen, errs)
    with phase_time("determinism"):
        phase_determinism(gen)
        phase_window_determinism(gen)

    # Serving GPT-2: full width, weights stored in bf16 (the serving dtype).
    with phase_time("GPT-2 serving"):
        cfg = GPT2Config(param_dtype=BF16)
        model = GPT2LMHeadModel(
            cfg, device=DEV,
            generator=torch.Generator(device=DEV).manual_seed(0))
        model32 = gpt2_fp32(model)
        launches = {"serve": phase_serve(model, cfg, rng)}
        phase_teacher_forcing(model, cfg, model32, rng)
        launches["serve_chunked"] = phase_serve_chunked(model, cfg, model32,
                                                        rng)
        launches["speculative"] = phase_speculative(model, cfg, model32, rng)
        phase_timing(model, cfg, rng)
        del model, model32
        torch.cuda.empty_cache()

    with phase_time("GPT-2 training"):
        launches["train"], step, batch, dgen, *held = phase_train()
        trace_step("train", lambda: step(batch, dgen), 12, 12)
        dense_ms = phase_train_timing(step, batch, dgen)
        del step, held
        torch.cuda.empty_cache()
        phase_train_check(batch)
        torch.cuda.empty_cache()

    with phase_time("GPT-2 remat policies"):
        launches["gpt2_remat"] = phase_gpt2_remat(batch)
        torch.cuda.empty_cache()

    with phase_time("ViT training"):
        launches["vit_train"], vstep, vbatch, vgen = phase_vit_train()
        trace_step("vit train", lambda: vstep(vbatch, vgen), 12, 12)
        phase_train_timing(vstep, vbatch, vgen, label="vit train",
                           shape=f"b={VIT_B} 224x224 dropout 0.1")
        del vstep
        torch.cuda.empty_cache()
        phase_vit_check(vbatch)
        torch.cuda.empty_cache()

    with phase_time("BERT training"):
        launches["bert_train"], bstep, bbatch, bgen = phase_bert_train()
        trace_step("bert train", lambda: bstep(bbatch, bgen), 12, 12,
                   segments=True)
        phase_train_timing(bstep, bbatch, bgen, label="bert train",
                           shape=f"b={BERT_B} s={BERT_S} padding masks "
                           "dropout 0.1")
        del bstep
        torch.cuda.empty_cache()
        phase_bert_check(bbatch)
        torch.cuda.empty_cache()

    with phase_time("blocksparse"):
        phase_blocksparse_kernels(gen, errs)
        launches["blocksparse_train"], bs_ms = phase_blocksparse_train()
        print(f"train step medians in this run: blocksparse {bs_ms:.2f} ms, "
              f"dense {dense_ms:.2f} ms [{card_line()}]")
        torch.cuda.empty_cache()
        phase_blocksparse_train_check(batch)
        torch.cuda.empty_cache()

    with phase_time("Llama serving"):
        launches["llama_chunked"] = phase_llama(rng)
    with phase_time("Llama training"):
        launches.update(phase_llama_train())
        torch.cuda.empty_cache()
    with phase_time("kernel timing"):
        times = kernel_timing(gen)
        window = window_timing(gen)
    with phase_time("Llama chain kernels"):
        chain = phase_chain_kernels(errs)
    with phase_time("Mistral serving"):
        launches.update(phase_mistral_serving(rng))
        torch.cuda.empty_cache()
    with phase_time("Mistral training"):
        launches.update(phase_mistral_train())
        torch.cuda.empty_cache()
    with phase_time("GPT-2 streaming decode"):
        launches["gpt2_stream"] = phase_gpt2_stream(rng)

    # K7a and K7b run inside K5's and K6's launches on the paths: their
    # launches by path are those appends (and the standalone kernels',
    # 0 there); ms is the standalone kernel's, and the fused route's
    # marginal cost is the kernel with the append less the kernel alone.
    fused = {"append_token": ("K5", ("GPT-2 decode", "Llama decode"),
                              "flash_attn_tpu_torch/csrc/paged_decode.cu"),
             "append_span": ("K6", ("verify",),
                             "flash_attn_tpu_torch/csrc/paged_chunk.cu")}
    kernels = []
    for name, (_, src, tpu) in KERNELS.items():
        by_path = {path: counts[name] for path, counts in launches.items()}
        if name in CHAIN_KERNELS:  # timed at longdoc's chunk, no library
            row = chain[name]["Mistral-7B chunk 8x512"]
            kernels.append({
                "name": name, "route": "cuda", "source": src,
                "replaces": tpu, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": errs[name],
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": None, "library_backend": None,
                "model_shapes": chain[name]})
            continue
        ms, plain_ms, lib_ms, b_ms, b_by, backend = times[name]
        entry = {
            "name": name, "route": "cuda", "source": src, "replaces": tpu,
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms,
            "library_backend": backend}
        if name in fused:
            kernel, shapes, into = fused[name]
            entry.update({
                "fused_into": into,
                "standalone_launches_by_path": {
                    path: counts[f"{name} standalone"]
                    for path, counts in launches.items()},
                "fused_ms": {shape: times[f"{kernel} with the append "
                                          f"({shape})"][0]
                             for shape in shapes},
                "fused_marginal_ms": {
                    shape: times[f"{kernel} with the append ({shape})"][0]
                    - times[f"{kernel} alone ({shape})"][0]
                    for shape in shapes}})
        if name in ("flash_fwd", "flash_bwd"):  # K1/K2 at BERT's shape
            seg_ms, seg_plain, seg_lib, seg_b, seg_by, seg_backend = times[
                f"{name} (BERT, segments, dropout 0.1"
                + (", lse)" if name == "flash_fwd" else ")")]
            entry["segment_form"] = {
                "shape": "b32 h12 s512 d64, BERT padding masks, dropout 0.1",
                "ms": seg_ms, "plain_ms": seg_plain, "bound_ms": seg_b,
                "bound_by": seg_by, "library_ms": seg_lib,
                "library_backend": seg_backend}
            entry["model_shapes"] = {}
            for shape, row in (
                    ("vit_train: b64 h12 s196 d64 non-causal, dropout 0.1",
                     "ViT-B/16, dropout 0.1" + (", lse" if name == "flash_fwd"
                                                else "")),
                    ("llama_train: b4 h32/8 s2048 d128 causal",
                     "Llama train" + (", lse" if name == "flash_fwd"
                                      else ""))):
                ms_, plain_, lib_, b_, by_, backend_ = times[f"{name} ({row})"]
                entry["model_shapes"][shape] = {
                    "ms": ms_, "plain_ms": plain_, "bound_ms": b_,
                    "bound_by": by_, "library_ms": lib_,
                    "library_backend": backend_}
        if name in window:  # the M4 branch at Mistral's shapes
            entry["window"] = {**window[name],
                               "max_abs_err": errs[f"window {name}"]}
        kernels.append(entry)
    print(json.dumps({"kernels": kernels}))
    print(f"phase total: {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
