"""End-to-end smoke run of flash_attn_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CUDA kernels from flash_attn_tpu_torch/csrc with nvcc (sm_90a),
checks each kernel against its plain-torch twin at the serving path's
shapes, serves 12 requests with GPT-2 at full width (bf16, random weights
from torch.Generator seed 0) through ServingEngine, holds prefill + decode
to teacher forcing against the full-sequence model, and times the path.
Any failed check raises and the exit code is nonzero. Without CUDA it
exits nonzero and prints no result. Output, in order: the card and
toolchain, per-phase lines, the kernels' JSON line, the card's name and
power limit, and as the last line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from flash_attn_tpu_torch.kernels import _build
from flash_attn_tpu_torch.kernels.decode import (
    paged_decode_attention,
    paged_decode_attention_plain,
)
from flash_attn_tpu_torch.kernels.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from flash_attn_tpu_torch.models import gpt2_decode
from flash_attn_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
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
    for wrapper, _, _ in KERNELS.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    finished = engine.run(max_steps=1000)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: w.launches for name, (w, _, _) in KERNELS.items()}
    check(len(finished) == 12, f"{len(finished)} of 12 requests finished")
    for r in finished:
        check(len(r.generated) == 32, f"request {r.seq_id}: "
              f"{len(r.generated)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in r.generated),
              f"request {r.seq_id}: token out of range")
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
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

    # Each kernel against its twin at the main path's shapes.
    q = randn(gen, (8, 12, 768, 64))
    k, v = randn(gen, (8, 12, 768, 64)), randn(gen, (8, 12, 768, 64))
    fwd = dict(causal=True, softmax_scale=0.125, save_lse=False)
    qd, kp, vp, dl, tbl = decode_inputs(gen)
    pages = cache.init_cache(12, 65, 128, 64, dtype=BF16, device=DEV)
    kw, vw = randn(gen, (768, 12, 64)), randn(gen, (768, 12, 64))
    ids = torch.tensor([7, 3, 9, 11, 5, 13], dtype=torch.int32, device=DEV)
    nk, nv = randn(gen, (8, 12, 64)), randn(gen, (8, 12, 64))
    tbl8 = torch.arange(1, 65, dtype=torch.int32, device=DEV).reshape(8, 8)
    l8 = torch.tensor([5, 127, 128, 300, -1, 640, 999, 0], dtype=torch.int32,
                      device=DEV)

    pairs = {
        "flash_fwd": (lambda: flash_attention_fwd(q, k, v, **fwd),
                      lambda: flash_attention_fwd_plain(q, k, v, **fwd)),
        "paged_decode": (
            lambda: paged_decode_attention(qd, kp, vp, dl, tbl),
            lambda: paged_decode_attention_plain(qd, kp, vp, dl, tbl,
                                                 softmax_scale=0.125)),
        "append_token": (
            lambda: cache.append_token(pages, nk, nv, tbl8, l8),
            lambda: cache.append_token_plain(pages, nk, nv, tbl8, l8)),
        "write_pages": (
            lambda: cache.write_prompt(pages, kw, vw, ids),
            lambda: cache.write_prompt_plain(pages, kw, vw, ids)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        # plain, kernel, kernel, plain: compare within one call, in turns
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kern), cuda_ms(kern),
                          cuda_ms(plain))
        times[name] = (min(k1, k2), min(p1, p2))
        print(f"{name}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / "
              f"{p2:.4f} ms [{card}]")
    print("shapes: flash_fwd b=8 h=12 s=768 d=64 causal; paged_decode b=8 "
          "h=12 d=64 page 128, lengths 0..1000; append_token b=8 h=12; "
          "write_pages 768 tokens into 6 pages")
    return times


def main():
    phase_device()
    gen = torch.Generator(device=DEV).manual_seed(0)
    rng = np.random.default_rng(0)
    errs = phase_kernels(gen)

    cfg = GPT2Config()  # full width: 12 layers, 12 heads, 768, bf16
    model = GPT2LMHeadModel(cfg, device=DEV,
                            generator=torch.Generator(device=DEV).manual_seed(0))
    launches = phase_serve(model, cfg, rng)
    phase_teacher_forcing(model, cfg, rng)
    times = phase_timing(model, cfg, rng, gen)

    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (_, src, tpu) in KERNELS.items()
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
