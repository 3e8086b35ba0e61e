"""The port's CUDA kernels against their plain-torch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode), carries the ``gpu`` marker and skips without a card. This file
imports no JAX, so it runs on a machine that has only PyTorch
(``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py -q

Tolerances: attention, decode and chunk attention are held to the repo's
2x rule (error against the fp32 twin at most twice a plain same-dtype
implementation's, plus 1e-5); cache writes are bitwise equal outside the
scratch page 0 (the span append writes nothing there: all pages), and
the paged kernels that append inside their launch (K5 and K6 with new
k/v) are bit for bit the standalone append followed by the kernel. K1
and K2 are also held at the attention shapes of ViT-B/16 and of the
Llama-3-8B-width train step (``MODEL_SHAPES``). The
backward kernels' gradients (K2, and K8b/K8c of blocksparse attention) are
held to the 2x rule against fp32 autograd through ``attention_ref`` (the
same-dtype ``attention_ref(upcast=False)`` in autograd is the baseline),
plus 1e-4: the fp32 gradients sum hundreds of terms in another order than
the oracle. Blocksparse dropout masks are held bit for bit to
``dropout_mask_dense``, and every kernel to itself over 10 seeded reruns.
The Llama serving phases replayed as CUDA graphs are held bit for bit to
their eager bodies (logits and pages) at Mistral-7B's widths, and at
Qwen3-30B-A3B's (routed experts); the experts' grouped GEMMs are held to
the 2x rule against their per-group twin in fp32. The serving chain's
kernels (``kernels/llama_chain.py``: residual add + RMSNorm, QK-norm +
rotary, SwiGLU) are held to the 2x rule against their twins in fp32 at
both models' decode and chunk shapes (the residual sum bit for bit), and a
graphed decode step is counted for the kernels a layer leaves besides
GEMMs and K5.
"""

import copy

import numpy as np
import pytest
import torch

from flash_attn_tpu_torch import flash_attention
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
    paged_num_splits,
    plan_sections,
    segment_mask,
    segment_plan,
    segment_plan_plain,
    sm_count,
)
from flash_attn_tpu_torch.kernels.decode import (
    paged_decode_attention,
    paged_decode_attention_plain,
    paged_decode_with_append,
)
from flash_attn_tpu_torch.kernels import llama_chain
from flash_attn_tpu_torch.kernels.flash_bwd import (
    flash_attention_bwd,
    flash_attention_bwd_plain,
)
from flash_attn_tpu_torch.kernels.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from flash_attn_tpu_torch.kernels.prng import dropout_mask_dense
from flash_attn_tpu_torch.models.blocksparse_modules import (
    LocalGlobalSparsityConfig,
)
from flash_attn_tpu_torch.models.gpt2 import (
    GPT2Config,
    GPT2LMHeadModel,
    make_train_step,
)
from flash_attn_tpu_torch.ops.blocksparse import blocksparse_attention
from flash_attn_tpu_torch.models import llama_decode
from flash_attn_tpu_torch.ops.attention import alibi_slopes
from flash_attn_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from flash_attn_tpu_torch.models.moe import (
    dispatch,
    grouped_mm,
    grouped_mm_plain,
    moe_experts,
    route,
)
from flash_attn_tpu_torch.reference import (
    alibi_bias,
    attention_lse_ref,
    attention_ref,
    build_mask,
    paged_chunk_ref,
)
from flash_attn_tpu_torch.serving import cache as torch_cache
from flash_attn_tpu_torch.serving.engine import ServingEngine
from flash_attn_tpu_torch.serving.speculative import speculative_decode
from flash_attn_tpu_torch.utils.testing import (
    assert_two_x_bound,
    max_err,
    packed_views,
    segment_layout,
)

pytestmark = pytest.mark.gpu

DTYPES = [torch.bfloat16, torch.float16, torch.float32]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (the kernels have no CPU "
                    "mode); run on the card: python -m pytest -m gpu "
                    "--noconftest tests/test_torch_kernels.py")
    torch.backends.cuda.matmul.allow_tf32 = False  # fp32 oracles stay fp32
    return torch.device("cuda")


def _randn(rng, shape, dtype, device):
    return torch.from_numpy(rng.standard_normal(shape)).to(device, dtype)


# (b, sq, sk, h, h_kv, d, causal)
GQA_32_8 = (1, 256, 256, 32, 8, 128, True)  # Llama-3-8B's attention widths
ATTN_CASES = [
    (2, 128, 128, 2, 2, 64, True),
    (2, 128, 128, 2, 2, 64, False),
    (1, 96, 160, 2, 2, 64, True),
    (1, 160, 96, 2, 2, 64, True),
    (1, 80, 200, 2, 2, 64, False),
    (1, 300, 300, 2, 2, 64, True),
    (1, 130, 130, 4, 2, 64, True),
    (1, 200, 200, 2, 1, 128, True),
    # lengths that are not multiples of K1's 128-row and K2's 64-row tiles
    (1, 1, 1, 2, 2, 64, True),
    (1, 77, 77, 2, 2, 64, True),
    (1, 129, 129, 2, 2, 128, False),
    (1, 1000, 1000, 2, 1, 64, True),
    # sq != sk both ways, top-left causal
    (1, 77, 1000, 2, 2, 64, True),
    (1, 1000, 77, 2, 2, 128, True),
    (1, 1, 129, 2, 2, 64, True),
    (1, 129, 1, 2, 2, 128, True),
    GQA_32_8,
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_fwd_kernel_matches_twin(cuda, case, dtype):
    b, sq, sk, h, h_kv, d, causal = case
    rng = np.random.default_rng(0)
    q = _randn(rng, (b, h, sq, d), dtype, cuda)
    k = _randn(rng, (b, h_kv, sk, d), dtype, cuda)
    v = _randn(rng, (b, h_kv, sk, d), dtype, cuda)
    scale = d ** -0.5
    out, lse = flash_attention_fwd(q, k, v, causal=causal,
                                   softmax_scale=scale, save_lse=True)
    torch.cuda.synchronize()
    twin, _ = flash_attention_fwd_plain(q, k, v, causal=causal,
                                        softmax_scale=scale, save_lse=False)
    native = attention_ref(q, k, v, causal=causal, upcast=False)
    assert_two_x_bound(out, twin.float(), native, label=f"{case} {dtype}")
    torch.testing.assert_close(lse, attention_lse_ref(q, k, v, causal=causal),
                               atol=1e-3, rtol=1e-3)


def _qkv(case, dtype, device, seed=0):
    b, sq, sk, h, h_kv, d, _ = case
    rng = np.random.default_rng(seed)
    return (_randn(rng, (b, h, sq, d), dtype, device),
            _randn(rng, (b, h_kv, sk, d), dtype, device),
            _randn(rng, (b, h_kv, sk, d), dtype, device),
            _randn(rng, (b, h, sq, d), dtype, device))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_fwd_dropout_kernel_matches_twin(cuda, case, dtype):
    """K1 with dropout 0.1: the kernel's mask is the twin's hash."""
    b, sq, sk, h, h_kv, d, causal = case
    q, k, v, _ = _qkv(case, dtype, cuda)
    kw = dict(causal=causal, softmax_scale=d ** -0.5, dropout_p=0.1,
              seed=77)
    out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
    torch.cuda.synchronize()
    twin, _ = flash_attention_fwd_plain(q, k, v, save_lse=False, **kw)
    keep = dropout_mask_dense(77, b, h, sq, sk, 0.1, device=cuda)
    native = attention_ref(q, k, v, causal=causal, upcast=False,
                           dropout_mask=keep, dropout_p=0.1)
    assert_two_x_bound(out, twin.float(), native, label=f"{case} {dtype}")
    torch.testing.assert_close(lse, attention_lse_ref(q, k, v, causal=causal),
                               atol=1e-3, rtol=1e-3)


def _ref_grads(q, k, v, dout, causal, keep, p, upcast):
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = attention_ref(*leaves, causal=causal, upcast=upcast,
                        dropout_mask=keep, dropout_p=p)
    out.backward(dout.to(out.dtype))
    return [x.grad for x in leaves]


def _one_key_per_row(case):
    _, sq, sk, _, _, _, causal = case
    return sk == 1 or (causal and sq == 1)


def _rounding_noise_bound(q, k, out, out32, dout, scale):
    """Bounds on |dq| and |dk| where every row sees key 0 alone.

    dS = p (dP - di) is then 0 in exact arithmetic, and the fp32 and
    same-dtype oracles both give exactly 0 (softmax's own backward). With
    dropout, di = rowsum(dout * out) reads the output rounded to its dtype,
    so dS_i is at most e_i = sum_d |dout_i| |out_i - out32_i| (out32: the
    exact fp32 output), dq_i = scale dS_i k_0 and dk_0 = scale sum_i dS_i
    q_i summed over the GQA group. Twice that bound, plus 1e-4."""
    group = q.shape[1] // k.shape[1]
    e = (dout.float().abs() * (out.float() - out32).abs()).sum(-1,
                                                                keepdim=True)
    k0 = k.float()[:, :, :1].abs().repeat_interleave(group, dim=1)
    dq = scale * e * k0
    dk = (scale * e * q.float().abs()).sum(2, keepdim=True)
    dk = dk.unflatten(1, (k.shape[1], group)).sum(2)
    return 2 * dq + 1e-4, 2 * dk + 1e-4


BWD_CASES = [(case, p) for case in ATTN_CASES for p in (0.0, 0.1)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case,dropout_p", BWD_CASES, ids=str)
def test_flash_bwd_kernel_matches_twin(cuda, case, dtype, dropout_p):
    """K2's dq, dk, dv against the twin and, by the 2x rule, against fp32
    autograd through attention_ref. Where every row sees one key, with
    dropout, in bf16/fp16, dq and dk are held to the output's rounding
    noise instead (_rounding_noise_bound), with dk's rows past key 0 zero."""
    b, sq, sk, h, h_kv, d, causal = case
    q, k, v, dout = _qkv(case, dtype, cuda)
    kw = dict(causal=causal, softmax_scale=d ** -0.5, dropout_p=dropout_p,
              seed=5 if dropout_p else None)
    out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
    grads = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    twins = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    keep = (dropout_mask_dense(5, b, h, sq, sk, dropout_p, device=cuda)
            if dropout_p else None)
    oracle = _ref_grads(q.float(), k.float(), v.float(), dout.float(),
                        causal, keep, dropout_p, True)
    native = _ref_grads(q, k, v, dout, causal, keep, dropout_p, False)
    noise = None
    if dropout_p and dtype != torch.float32 and _one_key_per_row(case):
        out32 = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                              dropout_mask=keep, dropout_p=dropout_p)
        noise = _rounding_noise_bound(q, k, out, out32, dout, d ** -0.5)
    for name, g, tw, o, n in zip("qkv", grads, twins, oracle, native):
        assert g.dtype == dtype and g.shape == tw.shape
        label = f"d{name} {case} {dtype} p={dropout_p}"
        if noise is not None and name in "qk":
            bound = noise["qk".index(name)]
            assert (g.float()[:, :, :bound.shape[2]].abs() <= bound).all(), \
                label
            assert not g[:, :, bound.shape[2]:].any(), label
        else:
            assert_two_x_bound(g, o, n, atol=1e-4, label=label)
        assert_two_x_bound(g, tw.float(), n, atol=1e-4,
                           label=f"d{name} vs twin {case} {dtype}")


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", [ATTN_CASES[5], GQA_32_8], ids=str)
def test_flash_bwd_kernel_neg_inf_lse_rows(cuda, case, dtype):
    """Rows whose lse is -inf (no visible key) give p = 0, not inf: they
    add nothing to dk/dv and get dq = 0, as in the twin."""
    q, k, v, dout = _qkv(case, dtype, cuda)
    kw = dict(causal=True, softmax_scale=case[5] ** -0.5)
    out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
    lse[:, :, 5:40] = float("-inf")
    grads = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    twins = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    assert torch.equal(grads[0][:, :, 5:40], torch.zeros_like(q[:, :, 5:40]))
    # fp32: summation order; 16-bit: a few units of the last place of
    # gradients up to ~10 (the bf16 kernel rounds p and dS for its products)
    tol = 1e-4 if dtype == torch.float32 else 6e-2
    for g, tw in zip(grads, twins):
        assert torch.isfinite(g).all()
        torch.testing.assert_close(g.float(), tw.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernels_take_strided_operands(cuda, dtype, heads, d):
    """q, k, v as transposed views of a fused projection (b, s, (h + 2 h_kv)
    d) and dout as a view of (b, s, h, d) memory, as the op passes them: K1
    reads them in place and gives out and lse bit for bit as on contiguous
    copies, K2 gives dq, dk and dv bit for bit (dq's fp32 sums are added in
    a fixed order). Outputs lie in (b, s, h, d) memory."""
    h, h_kv = heads
    b, s = 2, 320
    rng = np.random.default_rng(d + h_kv)
    qkv = _randn(rng, (b, s, (h + 2 * h_kv) * d), dtype, cuda)
    views = [x.transpose(1, 2) for x in packed_views(qkv, h, h_kv, d)]
    dout = _randn(rng, (b, s, h, d), dtype, cuda).transpose(1, 2)
    assert not any(x.is_contiguous() for x in (*views, dout))
    kw = dict(causal=True, softmax_scale=d ** -0.5, dropout_p=0.1, seed=5)
    results = []
    for x in ((*views, dout), [t.contiguous() for t in (*views, dout)]):
        out, lse = flash_attention_fwd(*x[:3], save_lse=True, **kw)
        results.append((out, lse, *flash_attention_bwd(
            *x[:3], out, x[3], lse, **kw)))
    torch.cuda.synchronize()
    for name, a, c in zip(("out", "lse", "dq", "dk", "dv"), *results):
        assert torch.equal(a, c), name
    for x in (results[0][0], *results[0][2:]):
        assert x.transpose(1, 2).is_contiguous()


def test_flash_attention_autograd_on_cuda_matches_cpu(cuda):
    """bshd layout, GQA, dropout and a loss on both outputs through the
    autograd Function: the card's gradients equal the CPU plain path's."""
    rng = np.random.default_rng(4)
    shapes = [(2, 200, 4, 64), (2, 200, 2, 64), (2, 200, 2, 64)]
    host = [torch.from_numpy(rng.standard_normal(s)).float() for s in shapes]
    g_out = torch.from_numpy(rng.standard_normal(shapes[0])).float()
    g_lse = torch.from_numpy(rng.standard_normal((2, 4, 200))).float()
    grads = []
    for dev in ("cpu", cuda):
        leaves = [x.to(dev, copy=True).requires_grad_() for x in host]
        out, lse = flash_attention(*leaves, causal=True, return_lse=True,
                                   dropout_p=0.1, dropout_seed=9)
        torch.autograd.backward([out, lse], [g_out.to(dev), g_lse.to(dev)])
        grads.append([x.grad.cpu() for x in leaves])
    for a, b in zip(*grads):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


def test_gpt2_train_step_on_card_matches_cpu(cuda):
    """A tiny fp32 GPT-2 (head_dim 64): one AdamW step on the card (K1 +
    K2) gives the CPU plain path's loss and gradients. Dropout 0: the
    activation masks come from torch's generators, which differ between
    the CPU and the card (the attention hash does not; see above)."""
    cfg = GPT2Config.tiny(dtype=torch.float32, n_head=2)
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 130)))
    results = []
    for dev in ("cpu", cuda):
        model = GPT2LMHeadModel(cfg, generator=torch.Generator().manual_seed(0),
                                device=dev)
        step = make_train_step(model, torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4))
        batch = {"input_ids": ids.to(dev), "labels": ids.to(dev)}
        loss = step(batch, torch.Generator().manual_seed(1))
        results.append((float(loss), {n: p.grad.cpu()
                                      for n, p in model.named_parameters()}))
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = results
    assert abs(loss_gpu - loss_cpu) < 1e-4
    for name, g in g_cpu.items():
        torch.testing.assert_close(g_gpu[name], g, atol=1e-4, rtol=1e-3,
                                   msg=name)


def _paged_inputs(rng, lengths, h, h_kv, d, ps, num_pages, pmax, dtype,
                  device):
    b = len(lengths)
    q = _randn(rng, (b, h, d), dtype, device)
    kp = _randn(rng, (h_kv, num_pages, ps, d), dtype, device)
    vp = _randn(rng, (h_kv, num_pages, ps, d), dtype, device)
    table = np.zeros((b, pmax), np.int32)
    perm = rng.permutation(np.arange(1, num_pages))
    used = 0
    for i, n in enumerate(lengths):
        need = -(-n // ps)
        table[i, :need] = perm[used:used + need]
        used += need
    return (q, kp, vp, torch.tensor(lengths, dtype=torch.int32, device=device),
            torch.from_numpy(table).to(device))


def _dense_native(q, kp, vp, lens, table):
    """Same-dtype dense attention over each sequence's gathered keys (the
    chunk oracle at sq = 1)."""
    one = (lens > 0).to(torch.int32)
    return paged_chunk_ref(q[:, None], kp, vp, lens, table, one,
                           upcast=False)[:, 0]


# (lengths, h, h_kv, d, page_size, pages_max)
DECODE_CASES = [
    ([1, 16, 17, 40], 2, 2, 64, 16, 3),
    ([33, 48, 5], 4, 2, 64, 16, 4),
    ([100, 7], 8, 2, 128, 32, 4),
    ([64, 0, 12], 2, 1, 64, 16, 4),
    ([1000, 1, 513], 12, 12, 64, 128, 8),  # GPT-2 widths, long context
    # one sequence of 16,384 tokens at Llama-3-8B's widths: 8 blocks
    # without split-KV
    ([16384], 32, 8, 128, 128, 128),
    # group 8 on 16-token pages: more splits than the short rows' pages
    ([3, 700, 1], 16, 2, 128, 16, 48),
    ([50, 2000], 16, 1, 64, 32, 64),  # group 16
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", DECODE_CASES, ids=str)
def test_paged_decode_kernel_matches_twin(cuda, case, dtype):
    lengths, h, h_kv, d, ps, pmax = case
    num_pages = 1 + sum(-(-n // ps) for n in lengths)
    q, kp, vp, lens, table = _paged_inputs(np.random.default_rng(1), lengths,
                                           h, h_kv, d, ps, num_pages, pmax,
                                           dtype, cuda)
    out = paged_decode_attention(q, kp, vp, lens, table)
    torch.cuda.synchronize()
    twin = paged_decode_attention_plain(q, kp, vp, lens, table,
                                        softmax_scale=d ** -0.5)
    native = _dense_native(q, kp, vp, lens, table)
    assert_two_x_bound(out, twin.float(), native, label=f"{case} {dtype}")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_cache_write_kernels_match_twins(cuda, dtype):
    rng = np.random.default_rng(2)
    h, d, ps, num_pages = 2, 64, 16, 13
    k0 = _randn(rng, (h, num_pages, ps, d), dtype, "cpu")
    v0 = _randn(rng, (h, num_pages, ps, d), dtype, "cpu")
    on_cpu = torch_cache.PagedKVCache(k0.clone(), v0.clone())
    on_card = torch_cache.PagedKVCache(k0.to(cuda), v0.to(cuda))
    k = _randn(rng, (37, h, d), dtype, "cpu")
    v = _randn(rng, (37, h, d), dtype, "cpu")
    ids = torch.tensor([5, 2, 7, 0, 0], dtype=torch.int32)
    torch_cache.write_prompt(on_cpu, k, v, ids)
    torch_cache.write_prompt(on_card, k.to(cuda), v.to(cuda), ids.to(cuda))
    table = torch.tensor([[1, 2, 3], [4, 6, 8], [9, 10, 11]],
                         dtype=torch.int32)
    lens = torch.tensor([15, -1, 40], dtype=torch.int32)
    nk = _randn(rng, (3, h, d), dtype, "cpu")
    nv = _randn(rng, (3, h, d), dtype, "cpu")
    torch_cache.append_token(on_cpu, nk, nv, table, lens)
    torch_cache.append_token(on_card, nk.to(cuda), nv.to(cuda),
                             table.to(cuda), lens.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(on_card.k_pages[:, 1:].cpu(), on_cpu.k_pages[:, 1:])
    assert torch.equal(on_card.v_pages[:, 1:].cpu(), on_cpu.v_pages[:, 1:])


# (b, prompt_len, h_kv, d, page_size, pages per row): GPT-2's single-shot
# prompt (6 pages and a scratch entry) and chunk of 256, Llama-3-8B's chunk
# of 512, and an unaligned length on small pages at Llama's widths.
WRITE_CASES = [
    (1, 700, 12, 64, 128, 7),
    (8, 256, 12, 64, 128, 2),
    (8, 512, 8, 128, 128, 4),
    (3, 37, 8, 128, 16, 3),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", WRITE_CASES, ids=str)
def test_write_pages_kernel_matches_twin(cuda, case, dtype):
    """K7c, single (b = 1, through write_prompt) and batched: bitwise equal
    to the twin outside the scratch page 0, with page lists padded with
    page 0 (duplicates in one launch) and a row that is all padding."""
    b, prompt_len, h, d, ps, n_pages = case
    rng = np.random.default_rng(prompt_len)
    num_pages = 1 + b * n_pages
    pages = [_randn(rng, (h, num_pages, ps, d), dtype, cuda) for _ in "kv"]
    on_card = torch_cache.PagedKVCache(*(x.clone() for x in pages))
    plain = torch_cache.PagedKVCache(*(x.clone() for x in pages))
    table = rng.permutation(np.arange(1, num_pages)).reshape(b, n_pages)
    need = -(-prompt_len // ps)
    table[:, need:] = 0
    if b > 1:
        table[1, need - 1:] = 0
        table[-1] = 0
    table = torch.from_numpy(table.astype(np.int32)).to(cuda)
    k, v = (_randn(rng, (b, prompt_len, h, d), dtype, cuda) for _ in "kv")
    if b == 1:
        torch_cache.write_prompt(on_card, k[0], v[0], table[0])
        torch_cache.write_prompt_plain(plain, k[0], v[0], table[0])
    else:
        torch_cache._write_prompts(on_card, k, v, table)
        torch_cache._write_prompts_plain(plain, k, v, table)
    torch.cuda.synchronize()
    assert torch.equal(on_card.k_pages[:, 1:], plain.k_pages[:, 1:])
    assert torch.equal(on_card.v_pages[:, 1:], plain.v_pages[:, 1:])


@pytest.mark.parametrize("dtype", DTYPES)
def test_write_pages_kernel_takes_projection_views(cuda, dtype):
    """K7c reads k and v in place as views of GPT-2's fused (b, C, 3, h, d)
    projection, as chunked prefill hands them over, and writes what it
    writes from contiguous copies."""
    rng = np.random.default_rng(4)
    b, C, h, d, ps = 4, 256, 12, 64, 128
    qkv = _randn(rng, (b, C, 3, h, d), dtype, cuda)
    _, k, v = qkv.unbind(2)
    table = torch.arange(1, 1 + 2 * b, dtype=torch.int32,
                         device=cuda).reshape(b, 2)
    caches = [torch_cache.init_cache(h, 1 + 2 * b, ps, d, dtype=dtype,
                                     device=cuda) for _ in range(2)]
    torch_cache._write_prompts(caches[0], k, v, table)
    torch_cache._write_prompts(caches[1], k.contiguous(), v.contiguous(),
                               table)
    torch.cuda.synchronize()
    assert torch.equal(caches[0].k_pages, caches[1].k_pages)
    assert torch.equal(caches[0].v_pages, caches[1].v_pages)


def test_engine_on_card_matches_cpu(cuda):
    """A tiny fp32 GPT-2 (head_dim 64, as the kernels need): the engine on
    the card (all four kernels) gives the CPU plain path's greedy tokens."""
    cfg = GPT2Config.tiny(dtype=torch.float32, n_head=2)
    model = GPT2LMHeadModel(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (9, 40, 130)]
    outs = []
    for m in (model, copy.deepcopy(model).to(cuda)):
        eng = ServingEngine(m, cfg, max_batch=2, num_pages=24, page_size=16,
                            pages_per_seq=12)
        for p in prompts:
            eng.submit(p, max_new_tokens=6)
        outs.append({r.seq_id: r.generated for r in eng.run(max_steps=100)})
    assert outs[0] == outs[1]


def _chunk_inputs(rng, lengths, sq, h, h_kv, d, ps, pmax, dtype, device):
    """q (b, sq, h, d) and pages with each sequence's pages in shuffled
    order; lengths include the chunk."""
    q, kp, vp, lens, table = _paged_inputs(
        rng, lengths, h, h_kv, d, ps, 1 + sum(-(-n // ps) for n in lengths),
        pmax, dtype, device)
    q = _randn(rng, (len(lengths), sq, h, d), dtype, device)
    return q, kp, vp, lens, table


# (lengths incl. the chunk, chunk_lens, sq, h, h_kv, d, page_size, pages_max)
CHUNK_CASES = [
    ([40, 17, 5, 33], [8, 3, 5, 0], 8, 2, 2, 64, 16, 3),      # group 1
    ([300, 64, 9], [5, 5, 1], 5, 8, 2, 128, 32, 10),           # verify, group 4
    ([700, 256, 1000, 5], [256, 200, 40, 0], 256, 12, 12, 64, 128, 8),
    ([600, 513, 256], [256, 256, 100], 256, 32, 4, 128, 128, 5),  # group 8
    ([100, 1, 0, 47], [1, 1, 0, 1], 1, 8, 2, 64, 16, 7),       # sq 1, group 4
    ([77, 130], [1, 1], 1, 8, 1, 128, 16, 9),                  # sq 1, group 8
    # page 16 at d 128 with GQA: verification over many splits, and a
    # long chunk over a few
    ([300, 520, 47, 0], [5, 5, 5, 0], 5, 16, 4, 128, 16, 40),
    ([600, 1100], [200, 300], 300, 16, 2, 128, 16, 70),
    ([90, 33], [5, 5], 5, 4, 4, 64, 32, 4),                   # verify, page 32
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", CHUNK_CASES, ids=str)
def test_paged_chunk_kernel_matches_twin(cuda, case, dtype):
    """K6: ragged chunk_lens, padding rows (exactly 0), shuffled pages."""
    lengths, chunk_lens, sq, h, h_kv, d, ps, pmax = case
    q, kp, vp, lens, table = _chunk_inputs(np.random.default_rng(6),
                                           lengths, sq, h, h_kv, d, ps, pmax,
                                           dtype, cuda)
    cl = torch.tensor(chunk_lens, dtype=torch.int32, device=cuda)
    out = paged_chunk_attention(q, kp, vp, lens, table, chunk_lens=cl)
    torch.cuda.synchronize()
    twin = paged_chunk_attention_plain(q, kp, vp, lens, table, chunk_lens=cl,
                                       softmax_scale=d ** -0.5)
    native = paged_chunk_ref(q, kp, vp, lens, table, cl, upcast=False)
    assert_two_x_bound(out, twin.float(), native, label=f"{case} {dtype}")
    for i, c in enumerate(chunk_lens):
        assert not out[i, c:].any(), f"padding rows of sequence {i}"


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_chunk_kernel_sq1_matches_decode_kernel(cuda, dtype):
    """K6 at sq = 1 against K5 on the same cache: both within the 2x rule
    of the fp32 oracle, and within twice the baseline of each other."""
    lengths = [1, 127, 128, 129, 400, 777, 1000, 0]
    q, kp, vp, lens, table = _chunk_inputs(np.random.default_rng(7), lengths,
                                           1, 12, 12, 64, 128, 8, dtype, cuda)
    cl = (lens > 0).to(torch.int32)
    k6 = paged_chunk_attention(q, kp, vp, lens, table, chunk_lens=cl)[:, 0]
    k5 = paged_decode_attention(q[:, 0].contiguous(), kp, vp, lens, table)
    torch.cuda.synchronize()
    ref32 = paged_chunk_ref(q, kp, vp, lens, table, cl)[:, 0]
    ref16 = paged_chunk_ref(q, kp, vp, lens, table, cl, upcast=False)[:, 0]
    _, base = assert_two_x_bound(k6, ref32, ref16, label=f"K6 {dtype}")
    assert_two_x_bound(k5, ref32, ref16, label=f"K5 {dtype}")
    assert max_err(k6, k5) <= 2 * base + 1e-5


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernels_take_strided_q(cuda, dtype):
    """K5 and K6 read q in place as a view of a fused projection, as the
    models pass it, and give bit for bit what they give on a copy."""
    lengths, h, h_kv, d = [300, 1000, 5, 0], 8, 2, 128
    rng = np.random.default_rng(12)
    _, kp, vp, lens, table = _paged_inputs(
        rng, lengths, h, h_kv, d, 128, 1 + sum(-(-n // 128) for n in lengths),
        8, dtype, cuda)
    fused = _randn(rng, (4, 5, (h + 2 * h_kv) * d), dtype, cuda)
    q = fused[..., :h * d].unflatten(-1, (h, d))  # (b, 5, h, d), strided
    cl = torch.tensor([5, 5, 5, 0], dtype=torch.int32, device=cuda)
    for a, c in ((paged_decode_attention(q[:, 0], kp, vp, lens, table),
                  paged_decode_attention(q[:, 0].contiguous(), kp, vp, lens,
                                         table)),
                 (paged_chunk_attention(q, kp, vp, lens, table,
                                        chunk_lens=cl),
                  paged_chunk_attention(q.contiguous(), kp, vp, lens, table,
                                        chunk_lens=cl))):
        torch.cuda.synchronize()
        assert torch.equal(a, c)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_append_span_kernel_matches_twin(cuda, dtype):
    """K7b bit for bit on every page (it writes nothing to page 0): spans
    crossing a page edge, an inactive row, a row running past its table,
    a short row; and at sq = 1 the pages K7a gives active rows."""
    rng = np.random.default_rng(8)
    h, d, ps, num_pages, sq = 2, 64, 16, 13, 5
    k0 = _randn(rng, (h, num_pages, ps, d), dtype, "cpu")
    v0 = _randn(rng, (h, num_pages, ps, d), dtype, "cpu")
    table = torch.tensor([[1, 2, 3], [4, 5, 6], [7, 8, 9], [10, 11, 12]],
                         dtype=torch.int32)
    lens = torch.tensor([14, -1, 45, 0], dtype=torch.int32)
    new_lens = torch.tensor([5, 5, 5, 3], dtype=torch.int32)
    nk = _randn(rng, (4, sq, h, d), dtype, "cpu")
    nv = _randn(rng, (4, sq, h, d), dtype, "cpu")
    on_cpu = torch_cache.PagedKVCache(k0.clone(), v0.clone())
    on_card = torch_cache.PagedKVCache(k0.to(cuda), v0.to(cuda))
    torch_cache.append_span(on_cpu, nk, nv, table, lens, new_lens)
    torch_cache.append_span(on_card, nk.to(cuda), nv.to(cuda), table.to(cuda),
                            lens.to(cuda), new_lens.to(cuda))
    torch.cuda.synchronize()
    assert torch.equal(on_card.k_pages.cpu(), on_cpu.k_pages)
    assert torch.equal(on_card.v_pages.cpu(), on_cpu.v_pages)

    span = torch_cache.PagedKVCache(k0.to(cuda), v0.to(cuda))
    token = torch_cache.PagedKVCache(k0.to(cuda), v0.to(cuda))
    args = (table.to(cuda), lens.to(cuda))
    torch_cache.append_span(span, nk[:, :1].to(cuda), nv[:, :1].to(cuda),
                            *args)
    torch_cache.append_token(token, nk[:, 0].to(cuda), nv[:, 0].to(cuda),
                             *args)
    torch.cuda.synchronize()
    assert torch.equal(span.k_pages[:, 1:], token.k_pages[:, 1:])
    assert torch.equal(span.v_pages[:, 1:], token.v_pages[:, 1:])


# Key layouts of the fused-append tests: (page_size, pages_max). One
# 128-key page gives one split; sixteen 16-key pages give 64-key splits
# when the grid is small.
APPEND_LAYOUTS = {"1 split": (128, 1), "64-key splits": (16, 16)}


def _fused_inputs(rng, b, h, h_kv, d, ps, pmax, sq, dtype, device):
    """Pages where every sequence owns pmax pages of its own (never page
    0), and q, k, v as views of one fused (b, [sq,] h + 2 h_kv, d)
    projection (sq None: decode)."""
    num_pages = 1 + b * pmax
    kp = _randn(rng, (h_kv, num_pages, ps, d), dtype, device)
    vp = _randn(rng, (h_kv, num_pages, ps, d), dtype, device)
    table = torch.from_numpy((1 + rng.permutation(b * pmax)).reshape(
        b, pmax).astype(np.int32)).to(device)
    rows = (b,) if sq is None else (b, sq)
    fused = _randn(rng, (*rows, h + 2 * h_kv, d), dtype, device)
    q, k, v = fused.split([h, h_kv, h_kv], dim=-2)
    return kp, vp, table, q, k, v


def _int32(values, device):
    return torch.tensor(values, dtype=torch.int32, device=device)


@pytest.mark.parametrize("layout", APPEND_LAYOUTS)
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_with_append_is_the_two_launch_route(cuda, dtype, d, group,
                                                    layout):
    """K5 with K7a's append in its launch, on views of a fused projection:
    output and cache bit for bit append_token followed by K5. The new key
    at cache length 0, 63 and 64 (the first 64-key segment and the next), a
    split's first and last key, an inactive slot and a position past the
    table (both to the scratch page 0)."""
    ps, pmax = APPEND_LAYOUTS[layout]
    if pmax == 1:
        lengths = [0, 63, 64, 127, -1, 128]
    else:
        lengths = [0, 63, 64, 127, 191, -1, 256, 200]
    h_kv = 2
    kp, vp, table, q, k, v = _fused_inputs(
        np.random.default_rng(20), len(lengths), group * h_kv, h_kv, d, ps,
        pmax, None, dtype, cuda)
    splits = paged_num_splits(len(lengths), h_kv, pmax, ps, sm_count(
        cuda.index or 0))
    assert (splits > 1) == (pmax > 1), splits
    lens = _int32(lengths, cuda)
    fused = torch_cache.PagedKVCache(kp.clone(), vp.clone())
    pair = torch_cache.PagedKVCache(kp.clone(), vp.clone())
    out = paged_decode_with_append(q, k, v, fused.k_pages, fused.v_pages,
                                   lens, table)
    torch_cache.append_token(pair, k.contiguous(), v.contiguous(), table,
                             lens)
    want = paged_decode_attention(q, pair.k_pages, pair.v_pages,
                                  (lens.clamp(min=0) + 1).int(), table)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(fused.k_pages[:, 1:], pair.k_pages[:, 1:])
    assert torch.equal(fused.v_pages[:, 1:], pair.v_pages[:, 1:])


@pytest.mark.parametrize("layout", APPEND_LAYOUTS)
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_with_append_is_the_two_launch_route(cuda, dtype, d, group,
                                                   layout):
    """K6 with K7b's span append in its launch (verification, sq 5), on
    views of a fused projection: output and every page bit for bit
    append_span followed by K6. Spans starting at cache length 0, 63 and 64,
    one straddling a split (62), starting at a split's last key (127),
    running past the table, an inactive row, a short row and a padding
    row."""
    ps, pmax = APPEND_LAYOUTS[layout]
    cap = ps * pmax
    seqlens = [0, 63, 64, 62, 127, cap - 3, -1, 10]
    new_lens = [5, 5, 5, 5, 1, 5, 5, 0]
    if pmax == 1:
        seqlens[4] = 100
    sq, h_kv = 5, 2
    kp, vp, table, q, k, v = _fused_inputs(
        np.random.default_rng(21), len(seqlens), group * h_kv, h_kv, d, ps,
        pmax, sq, dtype, cuda)
    if dtype != torch.float32:
        row_tiles = -(-sq // (BLOCK_ROWS // group))
        splits = paged_num_splits(len(seqlens) * row_tiles, h_kv, pmax, ps,
                                  sm_count(cuda.index or 0))
        assert (splits > 1) == (pmax > 1), splits
    cl, nl = _int32(seqlens, cuda), _int32(new_lens, cuda)
    total = cl + nl
    fused = torch_cache.PagedKVCache(kp.clone(), vp.clone())
    pair = torch_cache.PagedKVCache(kp.clone(), vp.clone())
    out = paged_chunk_attention(q, fused.k_pages, fused.v_pages, total, table,
                                chunk_lens=nl, new_k=k, new_v=v,
                                cache_seqlens=cl)
    torch_cache.append_span(pair, k.contiguous(), v.contiguous(), table, cl,
                            nl)
    want = paged_chunk_attention(q.contiguous(), pair.k_pages, pair.v_pages,
                                 total, table, chunk_lens=nl)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(fused.k_pages, pair.k_pages)
    assert torch.equal(fused.v_pages, pair.v_pages)


@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chunk_with_append_fills_one_row_tile(cuda, dtype, d, group):
    """K6 with the append at the longest chunk it takes, one full row tile
    (sq x group = 128 rows, fp32 64): every new row staged and written
    over its tile, spans over several tiles and splits, bit for bit
    append_span followed by K6."""
    sq = (64 if dtype == torch.float32 else 128) // group
    ps, pmax, h_kv = 16, 24, 2
    seqlens, new_lens = [0, 40, 100, 250, -1, 7], [sq, sq, sq - 3, 3, sq, 0]
    kp, vp, table, q, k, v = _fused_inputs(
        np.random.default_rng(24), len(seqlens), group * h_kv, h_kv, d, ps,
        pmax, sq, dtype, cuda)
    cl, nl = _int32(seqlens, cuda), _int32(new_lens, cuda)
    fused = torch_cache.PagedKVCache(kp.clone(), vp.clone())
    pair = torch_cache.PagedKVCache(kp.clone(), vp.clone())
    out = paged_chunk_attention(q, fused.k_pages, fused.v_pages, cl + nl,
                                table, chunk_lens=nl, new_k=k, new_v=v,
                                cache_seqlens=cl)
    torch_cache.append_span(pair, k.contiguous(), v.contiguous(), table, cl,
                            nl)
    want = paged_chunk_attention(q.contiguous(), pair.k_pages, pair.v_pages,
                                 cl + nl, table, chunk_lens=nl)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(fused.k_pages, pair.k_pages)
    assert torch.equal(fused.v_pages, pair.v_pages)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_appends_take_projection_views_on_card(cuda, dtype, d):
    """K7a and K7b read k/v in place as views of a fused projection, bit
    for bit their twins on contiguous copies (K7a outside page 0)."""
    rng = np.random.default_rng(22)
    b, sq, h_kv, ps, pmax = 4, 5, 2, 16, 4
    for span in (False, True):
        kp, vp, table, _, k, v = _fused_inputs(
            rng, b, 4, h_kv, d, ps, pmax, sq if span else None, dtype, cuda)
        lens = _int32([0, 15, -1, 62], cuda)
        on_card = torch_cache.PagedKVCache(kp.clone(), vp.clone())
        plain = torch_cache.PagedKVCache(kp.clone(), vp.clone())
        if span:
            nl = _int32([5, 3, 5, 5], cuda)
            torch_cache.append_span(on_card, k, v, table, lens, nl)
            torch_cache.append_span_plain(plain, k.contiguous(),
                                          v.contiguous(), table, lens, nl)
        else:
            torch_cache.append_token(on_card, k, v, table, lens)
            torch_cache.append_token_plain(plain, k.contiguous(),
                                           v.contiguous(), table, lens)
        torch.cuda.synchronize()
        assert torch.equal(on_card.k_pages[:, 1:], plain.k_pages[:, 1:])
        assert torch.equal(on_card.v_pages[:, 1:], plain.v_pages[:, 1:])


def test_kvcache_takes_the_two_launch_route_past_one_row_tile(cuda):
    """flash_attn_with_kvcache with a chunk longer than one row tile of
    K6's block (sq 33 at group 4): append_span, then K6, counted in
    split_appends; what the fused route gives for the first 32 rows."""
    from flash_attn_tpu_torch.serving.kvcache import flash_attn_with_kvcache
    rng = np.random.default_rng(23)
    b, h_kv, d, ps, pmax = 3, 2, 64, 16, 8
    kp, vp, table, q, k, v = _fused_inputs(rng, b, 8, h_kv, d, ps, pmax, 33,
                                           torch.bfloat16, cuda)
    cl, nl = _int32([0, 40, 70], cuda), _int32([33, 20, 33], cuda)
    caches = [torch_cache.PagedKVCache(kp.clone(), vp.clone())
              for _ in range(2)]
    before = (flash_attn_with_kvcache.split_appends,
              paged_chunk_attention.append_launches)
    out, _ = flash_attn_with_kvcache(q, caches[0], table, cl, k, v,
                                     new_lens=nl)
    assert (flash_attn_with_kvcache.split_appends,
            paged_chunk_attention.append_launches) == (before[0] + 1,
                                                       before[1])
    want = paged_chunk_attention(
        q[:, :32], caches[1].k_pages, caches[1].v_pages, cl + nl.clamp(max=32),
        table, chunk_lens=nl.clamp(max=32), new_k=k[:, :32], new_v=v[:, :32],
        cache_seqlens=cl)
    torch.cuda.synchronize()
    assert torch.equal(out[:, :32], want)


@pytest.mark.parametrize("prefill_chunk", [None, 32])
def test_engines_on_card_match_cpu(cuda, prefill_chunk):
    """Tiny fp32 GPT-2 and Llama (GQA group 2), head_dim 64 as the kernels
    need: the engine on the card, single-shot and chunked, gives the CPU
    plain path's greedy tokens."""
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 512, n).tolist() for n in (9, 40, 130)]
    for cfg, cls, fns in (
            (GPT2Config.tiny(dtype=torch.float32, n_head=2), GPT2LMHeadModel,
             None),
            (LlamaConfig.tiny(n_embd=256, n_head=4, n_kv_head=2),
             LlamaForCausalLM, llama_decode)):
        model = cls(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu")
        kw = dict(max_batch=2, num_pages=24, page_size=16, pages_per_seq=12,
                  prefill_chunk=prefill_chunk)
        if fns is not None:
            kw["model_fns"] = fns
        outs = []
        for m in (model, copy.deepcopy(model).to(cuda)):
            eng = ServingEngine(m, cfg, **kw)
            for p in prompts:
                eng.submit(p, max_new_tokens=6)
            outs.append({r.seq_id: r.generated
                         for r in eng.run(max_steps=100)})
        assert outs[0] == outs[1], cls.__name__


def test_speculative_decode_on_card_matches_cpu(cuda):
    """The speculative loop (K1 draft, K7b + K6 verify) on the card gives
    the CPU plain path's tokens and verify logits, tiny fp32 GPT-2."""
    cfg = GPT2Config.tiny(dtype=torch.float32, n_head=2)
    model = GPT2LMHeadModel(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    prompt = np.random.default_rng(10).integers(0, 512, 70).tolist()
    cpu = speculative_decode(model, cfg, prompt, 12, page_size=16)
    card = speculative_decode(copy.deepcopy(model).to(cuda), cfg, prompt, 12,
                              page_size=16)
    assert card[0] == cpu[0]
    for (p0, c0, l0), (p1, c1, l1) in zip(cpu[1], card[1]):
        assert (p0, c0) == (p1, c1)
        torch.testing.assert_close(l1.cpu(), l0, atol=1e-4, rtol=1e-4)


# ------------------------------------------------ blocksparse: K8a, K8b, K8c

# (b, h, s, d, causal, key padding): ragged s (600, 384), full tiles with
# key padding, head_dim 128.
BS_CASES = [
    (2, 2, 256, 64, True, False),
    (2, 2, 512, 64, False, False),
    (1, 2, 600, 64, True, False),
    (1, 2, 600, 128, False, False),
    (2, 2, 512, 64, False, True),
    (2, 2, 384, 128, True, True),
]
BS_DTYPES = DTYPES


def _bs_inputs(case, dtype, device):
    """q, k, v, dout (b, h, s, d), the layout of a random cell mask whose
    first cell column is whole (so full tiles occur), and the padding:
    batch row 0 has s - 150 valid keys."""
    b, h, s, d, causal, pad = case
    rng = np.random.default_rng(s + d)
    bm = rng.random(((s + 15) // 16, (s + 255) // 256)) < 0.6
    bm[:, 0] = True
    layout = build_layout(bm, sq=s, sk=s, causal=causal)
    q_valid = k_valid = None
    if pad:
        k_valid = torch.ones((b, s), dtype=torch.uint8, device=device)
        k_valid[0, s - 150:] = 0
        q_valid = k_valid.clone()
    x = [_randn(rng, (b, h, s, d), dtype, device) for _ in range(4)]
    return (*x, layout, q_valid, k_valid)


def _bs_keep(case, p, device):
    b, h, s, *_ = case
    return dropout_mask_dense(11, b, h, s, s, p, device=device) if p else None


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", BS_DTYPES)
@pytest.mark.parametrize("case", BS_CASES, ids=str)
def test_blocksparse_fwd_kernel_matches_twin(cuda, case, dtype, dropout_p):
    """K8a's out and lse against the twin and, by the 2x rule, the oracle
    attention_ref with the layout's element mask and the padding."""
    q, k, v, _, layout, q_valid, k_valid = _bs_inputs(case, dtype, cuda)
    assert layout.kv_full.any()
    kw = dict(softmax_scale=case[3] ** -0.5, dropout_p=dropout_p,
              seed=11 if dropout_p else None)
    out, lse = blocksparse_attention_fwd(q, k, v, layout, q_valid, k_valid,
                                         **kw)
    torch.cuda.synchronize()
    twin, twin_lse = blocksparse_attention_fwd_plain(q, k, v, layout,
                                                     q_valid, k_valid, **kw)
    mask = visible_plain(layout, q_valid, k_valid, cuda)
    keep = _bs_keep(case, dropout_p, cuda)
    ref = dict(mask=mask, dropout_mask=keep, dropout_p=dropout_p)
    native = attention_ref(q, k, v, upcast=False, **ref)
    assert_two_x_bound(out, attention_ref(q, k, v, **ref), native,
                       label=f"{case} {dtype} p={dropout_p}")
    assert_two_x_bound(out, twin.float(), native, label=f"vs twin {case}")
    torch.testing.assert_close(lse, twin_lse, atol=1e-3, rtol=1e-3)
    assert not out[~mask.any(-1).expand_as(lse)].any()  # dead rows: 0


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", BS_DTYPES)
@pytest.mark.parametrize("case", BS_CASES, ids=str)
def test_blocksparse_bwd_kernels_match_twin(cuda, case, dtype, dropout_p):
    """K8b's dk, dv and K8c's dq against the twin and, by the 2x rule, fp32
    autograd through attention_ref with the element mask; dq and dk/dv
    bitwise equal from run to run (no atomics)."""
    q, k, v, dout, layout, q_valid, k_valid = _bs_inputs(case, dtype, cuda)
    kw = dict(softmax_scale=case[3] ** -0.5, dropout_p=dropout_p,
              seed=11 if dropout_p else None)
    out, lse = blocksparse_attention_fwd(q, k, v, layout, q_valid, k_valid,
                                         **kw)
    grads = blocksparse_attention_bwd(q, k, v, out, dout, lse, layout,
                                      q_valid, k_valid, **kw)
    again = blocksparse_attention_bwd(q, k, v, out, dout, lse, layout,
                                      q_valid, k_valid, **kw)
    torch.cuda.synchronize()
    di = (out.float() * dout.float()).sum(-1)
    twins = blocksparse_attention_bwd_plain(q, k, v, dout, lse, di, layout,
                                            q_valid, k_valid, **kw)
    mask = visible_plain(layout, q_valid, k_valid, cuda)
    keep = _bs_keep(case, dropout_p, cuda)

    def ref_grads(upcast):
        leaves = [(x.float() if upcast else x).detach().requires_grad_()
                  for x in (q, k, v)]
        o = attention_ref(*leaves, mask=mask, upcast=upcast,
                          dropout_mask=keep, dropout_p=dropout_p)
        o.backward(dout.to(o.dtype))
        return [x.grad for x in leaves]

    for name, g, g2, tw, o, n in zip("qkv", grads, again, twins,
                                     ref_grads(True), ref_grads(False)):
        assert g.dtype == dtype and torch.equal(g, g2), name
        assert_two_x_bound(g, o, n, atol=1e-4,
                           label=f"d{name} {case} {dtype} p={dropout_p}")
        assert_two_x_bound(g, tw.float(), n, atol=1e-4,
                           label=f"d{name} vs twin {case} {dtype}")


# chip_smoke.py's BS_SHAPES: (b, h, s, d, cell mask, causal, dropout_p,
# valid keys of batch row 0 or None): (i) the GPT-2 training step's
# attention, (ii) config 4's size and density, (iii) every tile FULL with
# key padding (C9), (iv) ragged s at d = 128.
BS_SHAPES = [
    (8, 12, 1024, 64, "local-global", True, 0.1, None),
    (1, 8, 8192, 64, "random 0.25", True, 0.0, None),
    (2, 4, 512, 64, "ones", False, 0.0, 300),
    (2, 4, 600, 128, "random 0.35", False, 0.1, None),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", BS_SHAPES, ids=str)
def test_blocksparse_dkv_kernel_at_bs_shapes(cuda, shape, dtype):
    """K8b alone at BS_SHAPES: dk and dv against the twin and, by the 2x
    rule, fp32 autograd through attention_ref with the element mask; 10
    seeded reruns bit for bit."""
    b, h, s, d, _, _, p, _ = shape
    q, k, v, dout, layout, q_valid, k_valid, kw = _bs_shape_inputs(
        shape, dtype, cuda)
    out, lse = blocksparse_attention_fwd(q, k, v, layout, q_valid, k_valid,
                                         **kw)
    di = (out.float() * dout.float()).sum(-1)

    def run():
        return blocksparse_attention_dkv(q, k, v, dout, lse, di, layout,
                                         q_valid, k_valid, **kw)
    dk, dv = run()
    torch.cuda.synchronize()
    _, twin_dk, twin_dv = blocksparse_attention_bwd_plain(
        q, k, v, dout, lse, di, layout, q_valid, k_valid, **kw)
    mask = visible_plain(layout, q_valid, k_valid, cuda)
    keep = dropout_mask_dense(7, b, h, s, s, p, device=cuda) if p else None

    def ref_grads(upcast):
        leaves = [(x.float() if upcast else x).detach().requires_grad_()
                  for x in (q, k, v)]
        o = attention_ref(*leaves, mask=mask, upcast=upcast,
                          dropout_mask=keep, dropout_p=p)
        o.backward(dout.to(o.dtype))
        return [x.grad for x in leaves[1:]]

    for name, g, tw, o, nat in zip("kv", (dk, dv), (twin_dk, twin_dv),
                                   ref_grads(True), ref_grads(False)):
        assert_two_x_bound(g, o, nat, atol=1e-4,
                           label=f"d{name} {shape} {dtype}")
        assert_two_x_bound(g, tw.float(), nat, atol=1e-4,
                           label=f"d{name} vs twin {shape} {dtype}")
    _reruns_equal(run)


def _ref_dq(q, k, v, dout, ref, upcast):
    """dq of attention_ref(**ref) by autograd, in fp32 (``upcast``) or in
    the inputs' dtype."""
    leaves = [(x.float() if upcast else x).detach().requires_grad_()
              for x in (q, k, v)]
    o = attention_ref(*leaves, upcast=upcast, **ref)
    o.backward(dout.to(o.dtype))
    return leaves[0].grad


def _bs_shape_inputs(shape, dtype, device):
    """q, k, v, dout, the layout, q_valid, k_valid and the kernels' keyword
    arguments of one BS_SHAPES entry, from numpy's default_rng(s)."""
    b, h, s, d, cells, causal, p, valid = shape
    rng = np.random.default_rng(s)
    n = (-(-s // 16), -(-s // 256))
    if cells == "local-global":
        bm = LocalGlobalSparsityConfig(window=256).make_layout(s)
    elif cells == "ones":
        bm = np.ones(n, bool)
    else:
        bm = rng.random(n) < float(cells.split()[1])
    layout = build_layout(bm, sq=s, sk=s, causal=causal)
    q, k, v, dout = (_randn(rng, (b, h, s, d), dtype, device)
                     for _ in range(4))
    q_valid = k_valid = None
    if valid is not None:
        k_valid = torch.ones((b, s), dtype=torch.uint8, device=device)
        k_valid[0, valid:] = 0
        q_valid = k_valid.clone()
        assert layout.kv_full.all()
    kw = dict(softmax_scale=d ** -0.5, dropout_p=p, seed=7 if p else None)
    return q, k, v, dout, layout, q_valid, k_valid, kw


# BS_SHAPES and a config 4-like mask at s = 4096: q tiles' lists run to 64
# live tiles, past the K/V ring's 2-4 stages.
FWD_DQ_SHAPES = BS_SHAPES + [(2, 4, 4096, 64, "random 0.25", True, 0.0,
                              None)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("shape", FWD_DQ_SHAPES, ids=str)
def test_blocksparse_fwd_and_dq_kernels_at_bs_shapes(cuda, shape, dtype):
    """K8a and K8c alone at BS_SHAPES and at s = 4096: out, lse and dq
    against the twins and, by the 2x rule, the oracle (fp32 autograd through
    attention_ref with the element mask for dq); 10 seeded reruns of each
    bit for bit."""
    q, k, v, dout, layout, q_valid, k_valid, kw = _bs_shape_inputs(
        shape, dtype, cuda)
    b, h, s, d, _, _, p, _ = shape

    def fwd():
        return blocksparse_attention_fwd(q, k, v, layout, q_valid, k_valid,
                                         **kw)
    out, lse = fwd()
    di = (out.float() * dout.float()).sum(-1)

    def dq():
        return (blocksparse_attention_dq(q, k, v, dout, lse, di, layout,
                                         q_valid, k_valid, **kw),)
    (dq_k,) = dq()
    torch.cuda.synchronize()
    twin, twin_lse = blocksparse_attention_fwd_plain(
        q, k, v, layout, q_valid, k_valid, **kw)
    twin_dq, _, _ = blocksparse_attention_bwd_plain(
        q, k, v, dout, lse, di, layout, q_valid, k_valid, **kw)
    mask = visible_plain(layout, q_valid, k_valid, cuda)
    keep = dropout_mask_dense(7, b, h, s, s, p, device=cuda) if p else None
    ref = dict(mask=mask, dropout_mask=keep, dropout_p=p)
    native = attention_ref(q, k, v, upcast=False, **ref)
    assert_two_x_bound(out, attention_ref(q, k, v, **ref), native,
                       label=f"out {shape} {dtype}")
    assert_two_x_bound(out, twin.float(), native,
                       label=f"out vs twin {shape} {dtype}")
    dead = ~mask.any(-1).expand(b, h, s)
    assert torch.equal(torch.isneginf(lse), dead)
    torch.testing.assert_close(lse[~dead], twin_lse[~dead], atol=1e-3,
                               rtol=1e-3)
    assert not out[dead].any() and not dq_k[dead].any()

    nat = _ref_dq(q, k, v, dout, ref, upcast=False)
    assert_two_x_bound(dq_k, _ref_dq(q, k, v, dout, ref, upcast=True), nat,
                       atol=1e-4,
                       label=f"dq {shape} {dtype}")
    assert_two_x_bound(dq_k, twin_dq.float(), nat, atol=1e-4,
                       label=f"dq vs twin {shape} {dtype}")
    _reruns_equal(fwd)
    _reruns_equal(dq)


@pytest.mark.parametrize("pad", [False, True], ids=["no-pad", "pad"])
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_blocksparse_empty_lists_and_dead_rows(cuda, dtype, d, pad):
    """A q tile whose list is empty (loads nothing) and rows that see
    nothing inside live tiles (a dead cell row; with padding, padded rows
    and a batch row with every key padded): out 0, lse -inf and dq 0 there,
    the rest against the twins by the 2x rule."""
    b, h, s = 2, 2, 448  # ragged: seven q tiles, two cell columns
    rng = np.random.default_rng(d + pad)
    bm = rng.random((s // 16, 2)) < 0.6
    bm[:, 0] = True
    bm[4:8] = False  # q tile 1: empty list
    bm[13] = False  # one dead cell row inside q tile 3
    layout = build_layout(bm, sq=s, sk=s, causal=True)
    assert layout.kv_counts[1] == 0
    q_valid = k_valid = None
    if pad:
        k_valid = torch.ones((b, s), dtype=torch.uint8, device=cuda)
        k_valid[0, 300:] = 0
        k_valid[1] = 0  # batch row 1 sees nothing
        q_valid = k_valid.clone()
    q, k, v, dout = (_randn(rng, (b, h, s, d), dtype, cuda)
                     for _ in range(4))
    kw = dict(softmax_scale=d ** -0.5, dropout_p=0.1, seed=9)
    out, lse = blocksparse_attention_fwd(q, k, v, layout, q_valid, k_valid,
                                         **kw)
    di = (out.float() * dout.float()).sum(-1)
    dq = blocksparse_attention_dq(q, k, v, dout, lse, di, layout, q_valid,
                                  k_valid, **kw)
    torch.cuda.synchronize()
    mask = visible_plain(layout, q_valid, k_valid, cuda)
    dead = ~mask.any(-1).expand(b, h, s)
    assert dead[:, :, 64:128].all() and dead[:, :, 208:224].all()
    assert torch.equal(torch.isneginf(lse), dead)
    assert not out[dead].any() and not dq[dead].any()
    twin, _ = blocksparse_attention_fwd_plain(q, k, v, layout, q_valid,
                                              k_valid, **kw)
    twin_dq, _, _ = blocksparse_attention_bwd_plain(
        q, k, v, dout, lse, di, layout, q_valid, k_valid, **kw)
    ref = dict(mask=mask, dropout_p=0.1,
               dropout_mask=dropout_mask_dense(9, b, h, s, s, 0.1,
                                               device=cuda))
    native = attention_ref(q, k, v, upcast=False, **ref)
    assert_two_x_bound(out, twin.float(), native, label="out vs twin")
    assert_two_x_bound(dq, twin_dq.float(),
                       _ref_dq(q, k, v, dout, ref, upcast=False), atol=1e-4,
                       label="dq vs twin")


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", BS_DTYPES)
def test_blocksparse_dropout_mask_is_the_hash(cuda, dtype, d):
    """With q = k = 0 every visible key gets p = 1/sk, and with v the
    identity (sk = d) out[i, j] = keep[i, j] / ((1 - p) sk): the kernel's
    mask is dropout_mask_dense bit for bit, on full tiles (all cells live)."""
    b, h, sq, sk, p = 2, 2, 192, d, 0.3
    q = torch.zeros((b, h, sq, d), dtype=dtype, device=cuda)
    k = torch.zeros((b, h, sk, d), dtype=dtype, device=cuda)
    v = torch.eye(d, dtype=dtype, device=cuda).expand(b, h, d, d).contiguous()
    layout = build_layout(np.ones((sq // 16, 1), bool), sq=sq, sk=sk)
    assert layout.kv_full.all()
    out, _ = blocksparse_attention_fwd(q, k, v, layout, softmax_scale=1.0,
                                       dropout_p=p, seed=21)
    torch.cuda.synchronize()
    keep = dropout_mask_dense(21, b, h, sq, sk, p, device=cuda)
    assert torch.equal(out != 0, keep)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", BS_DTYPES)
def test_blocksparse_kernels_take_strided_operands(cuda, dtype, d):
    """q, k, v as views of a packed (b, s, 3, h, d) qkv and dout as a view
    of (b, s, h, d) memory, as the op passes them: K8a-c read them in place
    and give, bit for bit, what they give on contiguous copies; their
    outputs lie in (b, s, h, d) memory."""
    b, s, h = 2, 320, 2
    rng = np.random.default_rng(d)
    qkv = _randn(rng, (b, s, 3, h, d), dtype, cuda)
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    dout = _randn(rng, (b, s, h, d), dtype, cuda).transpose(1, 2)
    bm = rng.random(((s + 15) // 16, (s + 255) // 256)) < 0.6
    bm[:, 0] = True
    layout = build_layout(bm, sq=s, sk=s, causal=True)
    kw = dict(softmax_scale=d ** -0.5, dropout_p=0.1, seed=5)
    results = []
    for x in ((q, k, v, dout), [t.contiguous() for t in (q, k, v, dout)]):
        out, lse = blocksparse_attention_fwd(*x[:3], layout, **kw)
        results.append((out, lse, *blocksparse_attention_bwd(
            *x[:3], out, x[3], lse, layout, **kw)))
    torch.cuda.synchronize()
    for name, a, c in zip(("out", "lse", "dq", "dk", "dv"), *results):
        assert torch.equal(a, c), name
    for x in (results[0][0], *results[0][2:]):
        assert x.transpose(1, 2).is_contiguous()


def test_blocksparse_full_tiles_with_padding_match_oracle(cuda):
    """ROADMAP C9: an all-ones mask (every tile FULL), keys valid up to 300
    of 512: the kernels follow the oracle, which never attends a padded
    key; the JAX kernels attend them on full tiles."""
    rng = np.random.default_rng(3)
    b, s, h, d = 2, 512, 2, 64
    q, k, v, g = (_randn(rng, (b, s, h, d), torch.float32, cuda)
                  for _ in range(4))
    kpm = torch.ones((b, s), dtype=torch.bool, device=cuda)
    kpm[:, 300:] = False
    bm = np.ones((s // 16, s // 256), bool)
    assert build_layout(bm, sq=s, sk=s).kv_full.all()
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = blocksparse_attention(*leaves, bm, key_padding_mask=kpm)
    out.backward(g)
    mask = (kpm[:, None, :, None] & kpm[:, None, None, :])
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = attention_ref(*(x.transpose(1, 2) for x in ref_leaves),
                        mask=mask).transpose(1, 2)
    ref.backward(g)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=1e-5)
    for a, r in zip(leaves, ref_leaves):
        torch.testing.assert_close(a.grad, r.grad, atol=1e-4, rtol=1e-4)


def test_blocksparse_op_on_cuda_matches_cpu(cuda):
    """bshd, head_dim 40 (padded to 64), key padding, dropout and both
    outputs through the autograd Function: the card's gradients equal the
    CPU plain path's."""
    rng = np.random.default_rng(8)
    b, s, h, d = 2, 300, 2, 40
    host = [torch.from_numpy(rng.standard_normal((b, s, h, d))).float()
            for _ in range(3)]
    g_out = torch.from_numpy(rng.standard_normal((b, s, h, d))).float()
    g_lse = torch.from_numpy(rng.standard_normal((b, h, s))).float()
    kpm = torch.ones((b, s), dtype=torch.bool)
    kpm[1, 250:] = False
    bm = LocalGlobalSparsityConfig(window=256).make_layout(512)
    grads = []
    for dev in ("cpu", cuda):
        leaves = [x.to(dev, copy=True).requires_grad_() for x in host]
        out, lse = blocksparse_attention(
            *leaves, bm, causal=True, key_padding_mask=kpm.to(dev),
            dropout_p=0.1, dropout_seed=4, return_lse=True)
        torch.autograd.backward([out, lse], [g_out.to(dev), g_lse.to(dev)])
        grads.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    for a, c in zip(*grads):
        torch.testing.assert_close(c, a, atol=1e-4, rtol=1e-4)


def test_blocksparse_gpt2_train_step_on_card_matches_cpu(cuda):
    """A tiny fp32 GPT-2 through attn_impl = blocksparse attention: one
    AdamW step on the card (K8a-c) gives the CPU plain path's loss and
    gradients; each kernel launches once per layer."""
    cfg = GPT2Config.tiny(dtype=torch.float32, n_head=2)
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab_size, (2, 256)))
    layout = build_layout(LocalGlobalSparsityConfig(
        window=128, num_global_rows=2).make_layout(256), sq=256, sk=256,
        causal=True)

    def attn(q, k, v, dropout_seed=None):
        return blocksparse_attention(q, k, v, layout, causal=True)

    results = []
    for dev in ("cpu", cuda):
        model = GPT2LMHeadModel(cfg, generator=torch.Generator().manual_seed(0),
                                device=dev, attn_impl=attn)
        step = make_train_step(model, torch.optim.AdamW(
            model.parameters(), lr=1e-4, weight_decay=1e-4))
        for fn in (blocksparse_attention_fwd, blocksparse_attention_dkv,
                   blocksparse_attention_dq):
            fn.launches = 0
        loss = step({"input_ids": ids.to(dev), "labels": ids.to(dev)})
        launches = [fn.launches for fn in (blocksparse_attention_fwd,
                                           blocksparse_attention_dkv,
                                           blocksparse_attention_dq)]
        results.append((float(loss), {n: p.grad.cpu()
                                      for n, p in model.named_parameters()}))
    assert launches == [cfg.n_layer] * 3
    (loss_cpu, g_cpu), (loss_gpu, g_gpu) = results
    assert abs(loss_gpu - loss_cpu) < 1e-4
    for name, g in g_cpu.items():
        torch.testing.assert_close(g_gpu[name], g, atol=1e-4, rtol=1e-3,
                                   msg=name)


# (b, sq, sk, h, h_kv, d, causal): ViT-B/16's attention (non-causal over
# 196 patches: the last 64-row and 128-key tiles cut at the edge) and the
# Llama-3-8B-width train step's (GQA 32/8, d=128, causal, s=2048), at a
# smaller batch than chip_smoke.py's.
MODEL_SHAPES = {"vit-b16": (4, 196, 196, 12, 12, 64, False),
                "llama-train": (1, 2048, 2048, 32, 8, 128, True)}


def _packed(case, dtype, device, seed=0):
    """q, k, v as (b, h, s, d) views of one fused projection and dout, as
    the models hand them to the kernels."""
    b, s, _, h, h_kv, d, _ = case
    rng = np.random.default_rng(seed)
    qkv = _randn(rng, (b, s, (h + 2 * h_kv) * d), dtype, device)
    views = [x.transpose(1, 2) for x in packed_views(qkv, h, h_kv, d)]
    return (*views, _randn(rng, (b, h, s, d), dtype, device))


@pytest.mark.parametrize("save_lse", [True, False], ids=["lse", "no-lse"])
@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_flash_kernels_at_model_shapes(cuda, shape, dtype, dropout_p,
                                       save_lse):
    """K1 (with and without the lse) and K2 at the model shapes, on views
    of a fused projection: against their twins and, by the 2x rule,
    against fp32 attention_ref (by autograd for the gradients)."""
    case = MODEL_SHAPES[shape]
    b, s, _, h, _, d, causal = case
    q, k, v, dout = _packed(case, dtype, cuda)
    kw = dict(causal=causal, softmax_scale=d ** -0.5, dropout_p=dropout_p,
              seed=9 if dropout_p else None)
    out, lse = flash_attention_fwd(q, k, v, save_lse=save_lse, **kw)
    torch.cuda.synchronize()
    assert (lse is None) != save_lse
    keep = (dropout_mask_dense(9, b, h, s, s, dropout_p, device=cuda)
            if dropout_p else None)
    ref = dict(causal=causal, dropout_mask=keep, dropout_p=dropout_p)
    native = attention_ref(q, k, v, upcast=False, **ref)
    label = f"{shape} {dtype} p={dropout_p}"
    assert_two_x_bound(out, attention_ref(q, k, v, **ref), native,
                       label=f"out {label}")
    twin, _ = flash_attention_fwd_plain(q, k, v, save_lse=False, **kw)
    assert_two_x_bound(out, twin.float(), native, label=f"out vs twin {label}")
    if not save_lse:
        return
    torch.testing.assert_close(lse, attention_lse_ref(q, k, v, causal=causal),
                               atol=1e-3, rtol=1e-3)
    grads = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    twins = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    oracle = _ref_grads(q.float(), k.float(), v.float(), dout.float(),
                        causal, keep, dropout_p, True)
    native = _ref_grads(q, k, v, dout, causal, keep, dropout_p, False)
    for name, g, tw, o, n in zip("qkv", grads, twins, oracle, native):
        assert g.dtype == dtype and g.shape == tw.shape
        assert_two_x_bound(g, o, n, atol=1e-4, label=f"d{name} {label}")
        assert_two_x_bound(g, tw.float(), n, atol=1e-4,
                           label=f"d{name} vs twin {label}")


# ------------------------------------------------------------ determinism

RERUNS = 10


def _reruns_equal(fn):
    """``fn()`` (a tuple of tensors) RERUNS times: every run bit for bit
    the first."""
    first = [x.clone() for x in fn()]
    for _ in range(RERUNS - 1):
        again = fn()
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(first, again)):
            assert torch.equal(a, b), f"output {i} differs between runs"


@pytest.mark.parametrize("heads", [(4, 4), (8, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_kernels_are_bitwise_reproducible(cuda, dtype, heads):
    """K1 + K2 with dropout: out, lse, dq, dk and dv bit for bit over 10
    seeded reruns."""
    h, h_kv = heads
    q, k, v, dout = _qkv((2, 640, 640, h, h_kv, 64, True), dtype, cuda)
    kw = dict(causal=True, softmax_scale=0.125, dropout_p=0.1, seed=3)

    def run():
        out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
        return (out, lse, *flash_attention_bwd(q, k, v, out, dout, lse, **kw))
    _reruns_equal(run)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MODEL_SHAPES)
def test_flash_kernels_at_model_shapes_are_bitwise_reproducible(cuda, shape,
                                                                dtype):
    """K1 + K2 with dropout at the model shapes: out, lse, dq, dk and dv
    bit for bit over 10 seeded reruns (K2's GQA dK/dV summed in-kernel at
    d=128 for Llama)."""
    case = MODEL_SHAPES[shape]
    q, k, v, dout = _packed(case, dtype, cuda)
    kw = dict(causal=case[-1], softmax_scale=case[5] ** -0.5, dropout_p=0.1,
              seed=3)

    def run():
        out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
        return (out, lse, *flash_attention_bwd(q, k, v, out, dout, lse, **kw))
    _reruns_equal(run)


@pytest.mark.parametrize("dtype", DTYPES)
def test_blocksparse_kernels_are_bitwise_reproducible(cuda, dtype):
    """K8a-c with dropout and key padding: out, lse, dq, dk, dv."""
    case = (2, 2, 384, 128, True, True)
    q, k, v, dout, layout, q_valid, k_valid = _bs_inputs(case, dtype, cuda)
    kw = dict(softmax_scale=128 ** -0.5, dropout_p=0.1, seed=11)

    def run():
        out, lse = blocksparse_attention_fwd(q, k, v, layout, q_valid,
                                             k_valid, **kw)
        return (out, lse, *blocksparse_attention_bwd(
            q, k, v, out, dout, lse, layout, q_valid, k_valid, **kw))
    _reruns_equal(run)


@pytest.mark.parametrize("dtype", DTYPES)
def test_paged_kernels_are_bitwise_reproducible(cuda, dtype):
    """K5 and K6 (split-KV merged in split order), alone and with the
    append in their launch (on a copy of the pages: each rerun stores the
    same rows again): out and pages bit for bit, at Llama-3-8B's widths
    (GQA 32/8, d 128) with a long and an empty row."""
    lengths = [300, 4000, 5, 0]
    rng = np.random.default_rng(9)
    q, kp, vp, lens, table = _chunk_inputs(rng, lengths, 5, 32, 8, 128, 128,
                                           32, dtype, cuda)
    nk, nv = (_randn(rng, (4, 5, 8, 128), dtype, cuda) for _ in "kv")
    cl = torch.tensor([5, 5, 5, 0], dtype=torch.int32, device=cuda)
    kp2, vp2 = kp.clone(), vp.clone()
    _reruns_equal(lambda: (
        paged_decode_attention(q[:, 0], kp, vp, lens, table),
        paged_chunk_attention(q, kp, vp, lens, table, chunk_lens=cl),
        paged_decode_with_append(q[:, 0], nk[:, 0], nv[:, 0], kp2, vp2,
                                 lens - 5, table),
        paged_chunk_attention(q, kp2, vp2, lens, table, chunk_lens=cl,
                              new_k=nk, new_v=nv, cache_seqlens=lens - cl),
        kp2, vp2))


# ------------------------------------------------------------- segments

# (layout kind of utils/testing.py segment_layout, b, sq, sk, h, h_kv, d,
# causal)
SEG_CASES = [
    ("padding", 4, 512, 512, 2, 2, 64, False),   # BERT's padding masks
    ("padding", 2, 300, 300, 4, 2, 128, True),
    # short sequences packed beside long ones: whole query tiles are dead
    # for some key tiles (K2's dQ ranks count live pairs only)
    ("packed", 1, 1000, 1000, 2, 2, 64, True),
    ("packed", 1, 777, 777, 4, 1, 128, False),
    ("packed_qk", 1, 500, 900, 2, 2, 64, True),  # per-segment sq != sk
    ("packed_qk", 1, 900, 400, 2, 1, 128, True),
    ("random", 2, 257, 257, 2, 2, 64, True),     # non-contiguous ids
    ("allpad", 2, 200, 200, 2, 2, 64, False),    # a row of padding only
]


def _seg_inputs(case, dtype, device, seed=0):
    kind, b, sq, sk, h, h_kv, d, _ = case
    rng = np.random.default_rng(seed)
    q, k, v, dout = _qkv((b, sq, sk, h, h_kv, d, None), dtype, device, seed)
    seg = Segments(*(torch.from_numpy(np.ascontiguousarray(x)).to(device)
                     for x in segment_layout(rng, kind, b, sq, sk)))
    return q, k, v, dout, seg


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("case", SEG_CASES, ids=str)
def test_segment_plan_matches_plain(cuda, case, causal):
    """The pre-pass's tile plan (csrc/segments.cu) equals the plain plan
    word for word: rows, tile summaries, classes and dQ ranks, the interval
    form's flag and bounds, and the lists up to their counts."""
    _, b, sq, sk = case[:4]
    *_, seg = _seg_inputs(case, torch.bfloat16, cuda)
    got = plan_sections(segment_plan(seg, causal), b, sq, sk)
    torch.cuda.synchronize()
    want = segment_plan_plain(seg, causal)
    for name in ("qsp", "ksp", "qsum", "ksum", "cls", "fwd_n", "bwd_n",
                 "ivf", "qiv", "kiv"):
        assert torch.equal(got[name], want[name]), name
    for name, n in (("fwd", want["fwd_n"]), ("bwd", want["bwd_n"])):
        live = torch.arange(got[name].shape[2], device=cuda) < n[..., None]
        if name == "bwd":
            live = live[..., None]
        assert torch.equal(torch.where(live, got[name], 0), want[name]), name


def _seg_oracle_grads(q, k, v, dout, mask, keep, p, upcast):
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = attention_ref(*leaves, mask=mask, upcast=upcast,
                        dropout_mask=keep, dropout_p=p)
    out.backward(dout.to(out.dtype))
    return [x.grad for x in leaves]


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", SEG_CASES, ids=str)
def test_flash_segment_kernels_match_twin(cuda, case, dtype, dropout_p):
    """K1 and K2 in segment form against their twins and, by the 2x rule,
    against fp32 attention_ref (autograd for the gradients) under the
    equivalent boolean mask; lse against the masked fp32 logsumexp, -inf
    on rows that see no key, whose output and dq are 0."""
    kind, b, sq, sk, h, h_kv, d, causal = case
    q, k, v, dout, seg = _seg_inputs(case, dtype, cuda)
    kw = dict(causal=causal, softmax_scale=d ** -0.5, dropout_p=dropout_p,
              seed=21 if dropout_p else None, segments=seg)
    out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
    grads = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    twin, _ = flash_attention_fwd_plain(q, k, v, save_lse=False, **kw)
    twins = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    mask = segment_mask(seg, causal)
    keep = (dropout_mask_dense(21, b, h, sq, sk, dropout_p, device=cuda)
            if dropout_p else None)
    ref = dict(mask=mask, dropout_mask=keep, dropout_p=dropout_p)
    native = attention_ref(q, k, v, upcast=False, **ref)
    label = f"{case} {dtype} p={dropout_p}"
    assert_two_x_bound(out, twin.float(), native, label=f"out vs twin {label}")
    assert_two_x_bound(out, attention_ref(q.float(), k.float(), v.float(),
                                          **ref), native, label=f"out {label}")
    s = (q.float() @ k.float().repeat_interleave(h // h_kv, 1).transpose(
        -1, -2)) * d ** -0.5
    want_lse = torch.logsumexp(s.masked_fill(~mask, float("-inf")), dim=-1)
    dead = ~mask.any(-1).expand_as(want_lse)
    assert torch.equal(torch.isneginf(lse), dead), label
    torch.testing.assert_close(lse[~dead], want_lse[~dead], atol=1e-3,
                               rtol=1e-3)
    assert not out[dead].any(), label
    oracle = _seg_oracle_grads(q.float(), k.float(), v.float(), dout.float(),
                               mask, keep, dropout_p, True)
    nat = _seg_oracle_grads(q, k, v, dout, mask, keep, dropout_p, False)
    for name, g, tw, o, n in zip("qkv", grads, twins, oracle, nat):
        assert g.dtype == dtype and g.shape == tw.shape
        assert_two_x_bound(g, o, n, atol=1e-4, label=f"d{name} {label}")
        assert_two_x_bound(g, tw.float(), n, atol=1e-4,
                           label=f"d{name} vs twin {label}")
    assert not grads[0][dead].any(), label


@pytest.mark.parametrize("case", [SEG_CASES[2], SEG_CASES[5]], ids=str)
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_segment_kernels_are_bitwise_reproducible(cuda, dtype, case):
    """K1 + K2 in segment form with dropout, where whole query tiles are
    dead for some key tiles (blocks skip them; the dQ ranks count live
    pairs): out, lse, dq, dk and dv bit for bit over 10 seeded reruns."""
    q, k, v, dout, seg = _seg_inputs(case, dtype, cuda, seed=4)
    kw = dict(causal=case[-1], softmax_scale=case[6] ** -0.5,
              dropout_p=0.1, seed=3)

    def run():
        s = Segments(seg.q_seg, seg.kv_seg, seg.q_pos, seg.kv_pos)
        out, lse = flash_attention_fwd(q, k, v, save_lse=True, segments=s,
                                       **kw)
        return (out, lse, *flash_attention_bwd(q, k, v, out, dout, lse,
                                               segments=s, **kw))
    _reruns_equal(run)


def test_flash_attention_segments_on_cuda_match_cpu(cuda):
    """The op with segment ids and positions (packed, causal, GQA,
    dropout, a loss on both outputs): the card's outputs and gradients
    equal the CPU plain path's (fp32)."""
    rng = np.random.default_rng(6)
    q_seg, kv_seg, q_pos, kv_pos = segment_layout(rng, "packed_qk", 1, 500,
                                                  700)
    shapes = [(1, 500, 4, 64), (1, 700, 2, 64), (1, 700, 2, 64)]
    host = [torch.from_numpy(rng.standard_normal(s)).float() for s in shapes]
    g_out = torch.from_numpy(rng.standard_normal(shapes[0])).float()
    g_lse = torch.from_numpy(rng.standard_normal((1, 4, 500))).float()
    results = []
    for dev in ("cpu", cuda):
        leaves = [x.to(dev, copy=True).requires_grad_() for x in host]
        out, lse = flash_attention(
            *leaves, causal=True, return_lse=True, dropout_p=0.1,
            dropout_seed=9, q_segment_ids=q_seg, kv_segment_ids=kv_seg,
            q_positions=q_pos, kv_positions=kv_pos)
        torch.autograd.backward([out, lse], [g_out.to(dev), g_lse.to(dev)])
        results.append([out.detach().cpu(), lse.detach().cpu()]
                       + [x.grad.cpu() for x in leaves])
    for a, b in zip(*results):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=1e-4)


# ------------------------------------------------ M4: window, sinks, ALiBi

# (case, (left, right), sinks, alibi, softcap): K1 and K2's band branches.
BAND_CASES = [
    ((1, 300, 300, 2, 2, 64, True), (40, None), 0, False, None),
    ((1, 1000, 1000, 2, 1, 64, True), (200, None), 4, False, None),
    ((1, 300, 300, 2, 2, 128, False), (30, 50), 0, True, None),
    ((1, 77, 1000, 2, 2, 64, True), (100, None), 0, False, None),
    ((1, 77, 1000, 2, 2, 64, True), (30, None), 0, False, None),
    ((1, 1000, 77, 2, 2, 128, False), (10, 20), 0, False, None),
    ((2, 256, 256, 4, 2, 64, True), (64, None), 0, False, 5.0),
    ((1, 129, 129, 2, 2, 64, False), (None, None), 0, True, None),
    ((1, 300, 300, 2, 2, 64, False), (None, 20), 3, False, None),
    ((1, 700, 700, 4, 2, 64, False), (200, 300), 130, True, 2.0),
    (GQA_32_8, (100, None), 0, True, 30.0),
]


def _band(spec, b, h, scale, device):
    """The kernels' Band of a BAND_CASES entry, with the oracle's slopes
    ((h,), not over the scale) and softcap."""
    (left, right), sinks, alibi, softcap = spec
    slopes = alibi_slopes(h).to(device) if alibi else None
    band = Band(left, right, sinks, softcap,
                None if slopes is None else (slopes / scale)[None].expand(
                    b, h).contiguous())
    return band, slopes


def _band_oracle(case, spec, slopes, q, k, v, dout=None, upcast=True):
    """attention_ref under the band's mask, ALiBi bias and softcap: the
    output, and with ``dout`` the gradients (autograd)."""
    b, sq, sk, h, h_kv, d, causal = case
    (left, right), sinks, _, softcap = spec
    mask = build_mask(sq, sk, causal=causal, window_left=left,
                      window_right=right, num_sinks=sinks, device=q.device)
    bias = (None if slopes is None
            else alibi_bias(slopes, sq, sk, causal=causal))
    leaves = [x.detach().clone().requires_grad_(dout is not None)
              for x in (q, k, v)]
    if upcast:
        leaves = [x.float().detach().requires_grad_(dout is not None)
                  for x in leaves]
    out = attention_ref(*leaves, causal=causal, mask=mask, bias=bias,
                        softcap=softcap, upcast=upcast)
    if dout is None:
        return out
    out.backward(dout.to(out.dtype))
    return [x.grad for x in leaves]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", BAND_CASES, ids=str)
def test_flash_kernels_band_terms_match_twin(cuda, spec, dtype):
    """K1 and K2 with a window band, sinks, ALiBi and softcap: out and
    gradients against the twins and, by the 2x rule, against fp32
    attention_ref (autograd) under the same mask, bias and softcap."""
    case, *terms = spec
    b, sq, sk, h, h_kv, d, causal = case
    q, k, v, dout = _qkv(case, dtype, cuda, seed=3)
    scale = d ** -0.5
    band, slopes = _band(terms, b, h, scale, cuda)
    kw = dict(causal=causal, softmax_scale=scale, band=band)
    out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
    grads = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    twin, twin_lse = flash_attention_fwd_plain(q, k, v, save_lse=True, **kw)
    twins = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    label = f"{spec} {dtype}"
    native = _band_oracle(case, terms, slopes, q, k, v, upcast=False)
    assert_two_x_bound(out, twin.float(), native, label=f"out vs twin {label}")
    assert_two_x_bound(out, _band_oracle(case, terms, slopes, q, k, v),
                       native, label=f"out {label}")
    torch.testing.assert_close(lse, twin_lse.float(), atol=1e-3, rtol=1e-3)
    oracle = _band_oracle(case, terms, slopes, q, k, v, dout)
    nat = _band_oracle(case, terms, slopes, q, k, v, dout, upcast=False)
    for name, g, tw, o, n in zip("qkv", grads, twins, oracle, nat):
        assert g.dtype == dtype and g.shape == tw.shape
        assert_two_x_bound(g, o, n, atol=1e-4, label=f"d{name} {label}")
        assert_two_x_bound(g, tw.float(), n, atol=1e-4,
                           label=f"d{name} vs twin {label}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_windowed_flash_bwd_is_bitwise_reproducible(cuda, dtype):
    """K1 + K2 with a causal window and 4 sinks (the dQ ranks count the
    band's walkers, the sink tile's among them): out, lse, dq, dk and dv
    bit for bit over 10 seeded reruns."""
    case = (1, 1000, 1000, 4, 2, 64, True)
    q, k, v, dout = _qkv(case, dtype, cuda, seed=8)
    kw = dict(causal=True, softmax_scale=0.125, dropout_p=0.1, seed=3,
              band=Band(200, None, 4))

    def run():
        out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
        return (out, lse, *flash_attention_bwd(q, k, v, out, dout, lse,
                                               **kw))
    _reruns_equal(run)


BAND_SEG = [((16, 16), True), ((32, None), False), ((None, 8), False)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("band_spec", BAND_SEG, ids=str)
@pytest.mark.parametrize("case", [SEG_CASES[0], SEG_CASES[2], SEG_CASES[4],
                                  SEG_CASES[6]], ids=str)
def test_flash_segment_kernels_band_terms(cuda, case, band_spec, dtype):
    """The segment form with a band by positions (and ALiBi by positions):
    the plan word for word against the plain plan, K1 and K2 against
    their twins and, by the 2x rule, fp32 attention_ref under the
    equivalent mask and bias."""
    (left, right), alibi = band_spec
    kind, b, sq, sk, h, h_kv, d, causal = case
    q, k, v, dout, seg = _seg_inputs(case, dtype, cuda)
    scale = d ** -0.5
    slopes = alibi_slopes(h).to(cuda) if alibi else None
    band = Band(left, right, 0, None, None if slopes is None else (
        slopes / scale)[None].expand(b, h).contiguous())
    got = plan_sections(segment_plan(seg, causal, band), b, sq, sk)
    want = segment_plan_plain(seg, causal, band)
    for name in ("qsum", "ksum", "cls", "fwd_n", "bwd_n", "ivf", "qiv",
                 "kiv"):
        assert torch.equal(got[name], want[name]), name
    kw = dict(causal=causal, softmax_scale=scale, segments=seg, band=band)
    out, lse = flash_attention_fwd(q, k, v, save_lse=True, **kw)
    grads = flash_attention_bwd(q, k, v, out, dout, lse, **kw)
    torch.cuda.synchronize()
    twin, _ = flash_attention_fwd_plain(q, k, v, save_lse=False, **kw)
    twins = flash_attention_bwd_plain(q, k, v, out, dout, lse, **kw)
    mask = build_mask(sq, sk, causal=causal, q_positions=seg.q_pos[:, None],
                      kv_positions=seg.kv_pos[:, None],
                      q_segment_ids=seg.q_seg[:, None],
                      kv_segment_ids=seg.kv_seg[:, None], window_left=left,
                      window_right=right)
    bias = None if slopes is None else alibi_bias(
        slopes, sq, sk, causal=causal, q_positions=seg.q_pos,
        kv_positions=seg.kv_pos)

    def ref(x, upcast, g=None):
        leaves = [t.detach().clone().requires_grad_(g is not None)
                  for t in x]
        o = attention_ref(*leaves, mask=mask, bias=bias, upcast=upcast)
        if g is None:
            return o
        o.backward(g.to(o.dtype))
        return [t.grad for t in leaves]

    label = f"{case} {band_spec} {dtype}"
    native = ref((q, k, v), False)
    assert_two_x_bound(out, twin.float(), native, label=f"out vs twin {label}")
    assert_two_x_bound(out, ref([x.float() for x in (q, k, v)], True),
                       native, label=f"out {label}")
    oracle = ref([x.float() for x in (q, k, v)], True, dout.float())
    nat = ref((q, k, v), False, dout)
    for name, g, tw, o, n in zip("qkv", grads, twins, oracle, nat):
        assert_two_x_bound(g, o, n, atol=1e-4, label=f"d{name} {label}")
        assert_two_x_bound(g, tw.float(), n, atol=1e-4,
                           label=f"d{name} vs twin {label}")


# (lengths, h, h_kv, d, page_size, pages_max, window, sinks, alibi, softcap)
PAGED_BAND_CASES = [
    ([1, 16, 17, 400], 2, 2, 64, 16, 26, 40, 0, False, None),
    ([333, 48, 5], 4, 2, 64, 16, 22, 100, 4, True, None),
    ([1000, 7, 600], 8, 2, 128, 32, 32, 128, 4, False, 30.0),
    ([5000, 4097, 1], 32, 8, 128, 128, 40, 4096, 4, True, 50.0),  # Mistral
    ([2000, 3], 12, 12, 64, 128, 16, 256, 0, True, None),
    ([900], 16, 1, 64, 16, 60, 30, 200, False, 5.0),  # sinks past a tile
]


def _paged_band_inputs(case, dtype, device, sq=None, seed=11):
    lengths, h, h_kv, d, ps, pmax, window, sinks, alibi, cap = case
    num_pages = 1 + sum(-(-n // ps) for n in lengths)
    rng = np.random.default_rng(seed)
    q, kp, vp, lens, table = _paged_inputs(rng, lengths, h, h_kv, d, ps,
                                           num_pages, pmax, dtype, device)
    if sq is not None:
        q = _randn(rng, (len(lengths), sq, h, d), dtype, device)
    terms = dict(window_left=window, num_sinks=sinks, softcap=cap,
                 alibi_slopes=alibi_slopes(h).to(device) if alibi else None)
    return q, kp, vp, lens, table, terms


def _poison_below_band(kp, vp, lens, table, window, sinks, ps, floor_of):
    """Copies of the pages with NaN in every page wholly below its
    sequence's band (floor_of(length)) that holds no sink position."""
    kp, vp = kp.clone(), vp.clone()
    for i, n in enumerate(lens.tolist()):
        floor = floor_of(i, n)
        for j in range(-(-sinks // ps), max(0, floor) // ps):
            pid = int(table[i, j])
            kp[:, pid] = float("nan")
            vp[:, pid] = float("nan")
    return kp, vp


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", PAGED_BAND_CASES, ids=str)
def test_paged_decode_band_terms(cuda, case, dtype):
    """K5 with a window, sinks, softcap and ALiBi: against its twin and the
    2x rule over the dense band oracle; then with every page wholly below
    each sequence's band (sink pages aside) poisoned with NaN, finite and
    bit for bit the unpoisoned output (those pages are never fetched)."""
    q, kp, vp, lens, table, terms = _paged_band_inputs(case, dtype, cuda)
    d, ps = case[3], case[4]
    out = paged_decode_attention(q, kp, vp, lens, table, **terms)
    torch.cuda.synchronize()
    twin = paged_decode_attention_plain(
        q, kp, vp, lens, table, softmax_scale=d ** -0.5,
        terms=(terms["window_left"], terms["num_sinks"],
               terms["alibi_slopes"], terms["softcap"]))
    one = (lens > 0).to(torch.int32)
    native = paged_chunk_ref(q[:, None], kp, vp, lens, table, one,
                             upcast=False, **terms)[:, 0]
    assert_two_x_bound(out, twin.float(), native, label=f"{case} {dtype}")
    pk, pv = _poison_below_band(kp, vp, lens, table, terms["window_left"],
                                terms["num_sinks"], ps,
                                lambda i, n: n - 1 - terms["window_left"])
    poisoned = paged_decode_attention(q, pk, pv, lens, table, **terms)
    torch.cuda.synchronize()
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, out)


# (lengths incl. the chunk, chunk_lens, sq, h, h_kv, d, page_size,
# pages_max, window, alibi, softcap): sinks are decode-only, K5's.
CHUNK_BAND_CASES = [
    ([400, 17, 5, 333], [8, 3, 5, 0], 8, 2, 2, 64, 16, 26, 40, True, None),
    ([3000, 64, 900], [5, 5, 1], 5, 8, 2, 128, 32, 100, 100, False, 30.0),
    ([5000, 1024, 3000], [512, 512, 200], 512, 32, 8, 128, 128, 40, 4096,
     False, None),  # Mistral chunked prefill
    ([700, 1000], [256, 40], 256, 12, 12, 64, 128, 8, 128, True, 50.0),
    ([600, 1100], [200, 300], 300, 16, 2, 128, 16, 70, 90, True, None),
]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("spec", CHUNK_BAND_CASES, ids=str)
def test_paged_chunk_band_terms(cuda, spec, dtype):
    """K6 with a window (from the first row's floor), softcap and ALiBi:
    against its twin and the 2x rule over the dense oracle, padding rows
    exactly 0; then NaN in every page wholly below each sequence's
    first-row band: finite, bit for bit the same."""
    lengths, chunk_lens, sq, *rest = spec
    case = (lengths, *rest[:6], 0, *rest[6:])
    q, kp, vp, lens, table, terms = _paged_band_inputs(case, dtype, cuda,
                                                       sq=sq)
    del terms["num_sinks"]
    d, ps = rest[2], rest[3]
    cl = torch.tensor(chunk_lens, dtype=torch.int32, device=cuda)
    out = paged_chunk_attention(q, kp, vp, lens, table, chunk_lens=cl,
                                **terms)
    torch.cuda.synchronize()
    twin = paged_chunk_attention_plain(
        q, kp, vp, lens, table, chunk_lens=cl, softmax_scale=d ** -0.5,
        terms=(terms["window_left"], 0, terms["alibi_slopes"],
               terms["softcap"]))
    native = paged_chunk_ref(q, kp, vp, lens, table, cl, upcast=False,
                             **terms)
    assert_two_x_bound(out, twin.float(), native, label=f"{spec} {dtype}")
    for i, c in enumerate(chunk_lens):
        assert not out[i, c:].any(), f"padding rows of sequence {i}"
    pk, pv = _poison_below_band(
        kp, vp, lens, table, terms["window_left"], 0, ps,
        lambda i, n: n - chunk_lens[i] - terms["window_left"])
    poisoned = paged_chunk_attention(q, pk, pv, lens, table, chunk_lens=cl,
                                     **terms)
    torch.cuda.synchronize()
    assert torch.isfinite(poisoned).all() and torch.equal(poisoned, out)


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", DTYPES)
def test_band_appends_are_the_two_launch_route(cuda, dtype, d):
    """K5 with a window and sinks (the new rows' walk indices run past the
    sink tiles) and K6 with a window appending inside their launch: output
    and cache bit for bit the standalone append followed by the kernel."""
    ps, pmax, h_kv, group = 16, 24, 2, 4
    window, sinks = 50, 4
    lengths = [0, 63, 64, 200, 300, -1, 383, 130]
    kp, vp, table, q, k, v = _fused_inputs(
        np.random.default_rng(30), len(lengths), group * h_kv, h_kv, d, ps,
        pmax, None, dtype, cuda)
    lens = _int32(lengths, cuda)
    terms = dict(window_left=window, num_sinks=sinks)
    fused = torch_cache.PagedKVCache(kp.clone(), vp.clone())
    pair = torch_cache.PagedKVCache(kp.clone(), vp.clone())
    out = paged_decode_with_append(q, k, v, fused.k_pages, fused.v_pages,
                                   lens, table, **terms)
    torch_cache.append_token(pair, k.contiguous(), v.contiguous(), table,
                             lens)
    want = paged_decode_attention(q, pair.k_pages, pair.v_pages,
                                  (lens.clamp(min=0) + 1).int(), table,
                                  **terms)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(fused.k_pages[:, 1:], pair.k_pages[:, 1:])
    sq = 5
    seqlens = [0, 63, 64, 200, 300, -1, 378, 130]
    new_lens = [5, 5, 5, 5, 1, 5, 5, 0]
    kp, vp, table, q, k, v = _fused_inputs(
        np.random.default_rng(31), len(seqlens), group * h_kv, h_kv, d, ps,
        pmax, sq, dtype, cuda)
    cl, nl = _int32(seqlens, cuda), _int32(new_lens, cuda)
    fused = torch_cache.PagedKVCache(kp.clone(), vp.clone())
    pair = torch_cache.PagedKVCache(kp.clone(), vp.clone())
    del terms["num_sinks"]
    out = paged_chunk_attention(q, fused.k_pages, fused.v_pages, cl + nl,
                                table, chunk_lens=nl, new_k=k, new_v=v,
                                cache_seqlens=cl, **terms)
    torch_cache.append_span(pair, k.contiguous(), v.contiguous(), table, cl,
                            nl)
    want = paged_chunk_attention(q.contiguous(), pair.k_pages, pair.v_pages,
                                 cl + nl, table, chunk_lens=nl, **terms)
    torch.cuda.synchronize()
    assert torch.equal(out, want)
    assert torch.equal(fused.k_pages, pair.k_pages)
    assert torch.equal(fused.v_pages, pair.v_pages)


# ------------------------------- CUDA graphs of the Llama serving phases

# Mistral-7B's widths (GQA 32/8, head_dim 128, MLP 14336) cut to 2 layers
# and a 256-token window (so that chunks and decode walk a band), bf16.
GRAPH_CFG = dict(vocab_size=32000, n_layer=2, n_head=32, n_kv_head=8,
                 n_embd=4096, intermediate_size=14336,
                 max_position_embeddings=32768, window=256,
                 dtype=torch.bfloat16, param_dtype=torch.bfloat16)
GRAPH_PS, GRAPH_PMAX = 128, 12  # 1536 tokens a sequence
_graph_models = {}


def _graph_model(cuda):
    if "model" not in _graph_models:
        cfg = LlamaConfig(**GRAPH_CFG)
        _graph_models["model"] = cfg, LlamaForCausalLM(
            cfg, device=cuda,
            generator=torch.Generator(device=cuda).manual_seed(0))
    return _graph_models["model"]


def _graph_caches(cfg, rows, seed, cuda):
    """Random pages for ``rows`` sequences of GRAPH_PMAX pages each (page
    0 the scratch page)."""
    rng = np.random.default_rng(seed)
    shape = (cfg.n_kv_head, 1 + rows * GRAPH_PMAX, GRAPH_PS, cfg.head_dim)
    return [torch_cache.PagedKVCache(_randn(rng, shape, cfg.dtype, cuda),
                                     _randn(rng, shape, cfg.dtype, cuda))
            for _ in range(cfg.n_layer)]


def _graph_args(phase, rows, seed, cfg, cuda):
    """A call's tensor arguments: each row's own pages in a shuffled
    table; a chunk of width 512 at pos0 0, 512 or 1024 (the last row
    padding when rows > 1: no tokens, its writes to page 0), or a decode
    step whose last slot is inactive (length -1)."""
    rng = np.random.default_rng(seed)
    table = (1 + rng.permutation(rows * GRAPH_PMAX)).reshape(
        rows, GRAPH_PMAX).astype(np.int32)
    if phase == "decode_step":
        lens = rng.integers(1, GRAPH_PMAX * GRAPH_PS - 1, rows)
        if rows > 1:
            lens[-1] = -1
        ids = rng.integers(0, cfg.vocab_size, rows)
        return (torch.from_numpy(table).to(cuda), _int32(lens.tolist(), cuda),
                torch.from_numpy(ids).to(cuda))
    C, per = 512, 512 // GRAPH_PS
    pos0 = rng.choice([0, 512, 1024], rows)
    cl = rng.integers(1, C + 1, rows)
    ids = rng.integers(0, cfg.vocab_size, (rows, C))
    wtbl = np.zeros((rows, per), np.int32)
    for i in range(rows):
        wtbl[i] = table[i, pos0[i] // GRAPH_PS:pos0[i] // GRAPH_PS + per]
    if rows > 1:
        cl[-1], ids[-1], wtbl[-1] = 0, 0, 0
    ids[np.arange(C)[None] >= cl[:, None]] = 0
    return (torch.from_numpy(ids).to(cuda), _int32(pos0.tolist(), cuda),
            _int32(cl.tolist(), cuda), torch.from_numpy(wtbl).to(cuda),
            torch.from_numpy(table).to(cuda))


def _eager(phase):
    return {"decode_step": llama_decode._decode_body,
            "chunk_prefill_step": llama_decode._chunk_body}[phase]


CHAIN = (llama_chain.add_rmsnorm, llama_chain.qk_rope, llama_chain.swiglu)


def _chain_grew(grew):
    """The growth of the chain kernels' counters, of a growth of all
    ``llama_decode._COUNTERS``."""
    return [n for (f, _), n in zip(llama_decode._COUNTERS, grew)
            if f in CHAIN]


def _chain_launches(cfg):
    """add_rmsnorm, qk_rope and swiglu launches of one phase call: two
    norms a layer and the final one, one rotary and one SwiGLU a layer."""
    return [2 * cfg.n_layer + 1, cfg.n_layer, cfg.n_layer]


@pytest.mark.parametrize("phase, rows", [
    ("chunk_prefill_step", 1), ("chunk_prefill_step", 2),
    ("chunk_prefill_step", 4), ("decode_step", 8)])
def test_llama_graphs_match_the_eager_body(cuda, phase, rows):
    """Mistral-shaped phases on the card: the graphed call (a capture,
    then a replay, with other inputs) gives the eager body's logits and
    leaves every layer's pages as it leaves them, bit for bit outside the
    scratch page 0, and the launch counters grow by the eager body's
    amounts on each call."""
    cfg, model = _graph_model(cuda)
    graphed = _graph_caches(cfg, rows, 1, cuda)
    eager = [torch_cache.PagedKVCache(c.k_pages.clone(), c.v_pages.clone())
             for c in graphed]
    for seed in (2, 3):
        args = _graph_args(phase, rows, seed, cfg, cuda)
        c0 = llama_decode._counts()
        logits, caches = getattr(llama_decode, phase)(model, cfg, graphed,
                                                      *args)
        c1 = llama_decode._counts()
        want = _eager(phase)(model, cfg, eager, *args)
        c2 = llama_decode._counts()
        torch.cuda.synchronize()
        assert caches is graphed
        assert torch.equal(logits, want), seed
        for g, e in zip(graphed, eager):
            assert torch.equal(g.k_pages[:, 1:], e.k_pages[:, 1:]), seed
            assert torch.equal(g.v_pages[:, 1:], e.v_pages[:, 1:]), seed
        grew = [b - a for a, b in zip(c0, c1)]
        assert grew == [b - a for a, b in zip(c1, c2)], seed
        assert sum(grew) > 0
        assert _chain_grew(grew) == _chain_launches(cfg), seed
    graphs = llama_decode._GRAPHS[model]
    assert sum(1 for sig in graphs.by_sig if sig[0] == phase) == 1


def test_llama_graphs_capture_anew_for_new_caches(cuda, monkeypatch):
    """New caches (a new engine) make a new capture, and its replay writes
    the new pages, not the old ones."""
    cfg, model = _graph_model(cuda)
    captures = []
    capture = llama_decode._Graphs.capture

    def counted(self, *a, **k):
        captures.append(self)
        return capture(self, *a, **k)

    monkeypatch.setattr(llama_decode._Graphs, "capture", counted)
    # Caches freed by an earlier test may come back at the same addresses,
    # where their graphs rightly replay: start from none.
    llama_decode._GRAPHS.pop(model, None)
    rows = 8
    first = _graph_caches(cfg, rows, 4, cuda)
    for seed in (5, 6):
        llama_decode.decode_step(model, cfg, first,
                                 *_graph_args("decode_step", rows, seed, cfg,
                                              cuda))
    assert len(captures) == 1
    old = [c.k_pages.clone() for c in first]
    second = _graph_caches(cfg, rows, 7, cuda)
    eager = [torch_cache.PagedKVCache(c.k_pages.clone(), c.v_pages.clone())
             for c in second]
    for seed in (8, 9):
        args = _graph_args("decode_step", rows, seed, cfg, cuda)
        logits, _ = llama_decode.decode_step(model, cfg, second, *args)
        want = llama_decode._decode_body(model, cfg, eager, *args)
        torch.cuda.synchronize()
        assert torch.equal(logits, want)
    assert len(captures) == 2 and captures[0] is not captures[1]
    for c, e in zip(second, eager):
        assert torch.equal(c.k_pages[:, 1:], e.k_pages[:, 1:])
    for c, o in zip(first, old):
        assert torch.equal(c.k_pages, o)


def test_llama_engine_graphed_gives_the_eager_tokens(cuda):
    """``ServingEngine(model_fns=llama_decode, prefill_chunk=512)`` at
    Mistral's widths (2 layers) serves the greedy tokens the eager bodies
    serve."""
    import types
    cfg, model = _graph_model(cuda)

    def chunk(model, cfg, caches, *args):
        return llama_decode._chunk_body(model, cfg, caches, *args), caches

    def decode(model, cfg, caches, *args):
        return llama_decode._decode_body(model, cfg, caches, *args), caches

    eager = types.SimpleNamespace(prefill=llama_decode.prefill,
                                  chunk_prefill_step=chunk,
                                  decode_step=decode)
    rng = np.random.default_rng(10)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (300, 1100, 90, 700, 520)]
    outs = []
    for fns in (llama_decode, eager):
        eng = ServingEngine(model, cfg, model_fns=fns, max_batch=4,
                            page_size=GRAPH_PS, pages_per_seq=GRAPH_PMAX,
                            num_pages=1 + 4 * GRAPH_PMAX, prefill_chunk=512)
        for p in prompts:
            eng.submit(p, max_new_tokens=12)
        outs.append({r.seq_id: r.generated for r in eng.run(max_steps=200)})
        del eng
    assert len(outs[0]) == len(prompts)
    assert outs[0] == outs[1]


# ------------------------- routed experts: Qwen3-30B-A3B's widths, 2 layers

QWEN_CFG = dict(vocab_size=151936, n_layer=2, n_head=32, n_kv_head=4,
                n_embd=2048, intermediate_size=6144, head_dim=128,
                qk_norm=True, num_experts=128, num_experts_per_tok=8,
                moe_intermediate_size=768, norm_topk_prob=True,
                max_position_embeddings=40960, rope_theta=1e6,
                rms_norm_eps=1e-6, dtype=torch.bfloat16,
                param_dtype=torch.bfloat16)


def _qwen_model(cuda):
    if "qwen" not in _graph_models:
        cfg = LlamaConfig(**QWEN_CFG)
        _graph_models["qwen"] = cfg, LlamaForCausalLM(
            cfg, device=cuda,
            generator=torch.Generator(device=cuda).manual_seed(0))
    return _graph_models["qwen"]


def _moe_inputs(tokens, cuda, seed=0):
    """Tokens (T, 2048) and one layer's router and experts, bf16."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    r = lambda *s: torch.randn(*s, generator=g, device=cuda,  # noqa: E731
                               dtype=torch.bfloat16)
    return (r(tokens, 2048), r(128, 2048) * 0.02, r(128, 1536, 2048) * 0.02,
            r(128, 2048, 768) * 0.02)


@pytest.mark.parametrize("tokens", [32, 32 * 512], ids=["decode", "chunk"])
def test_moe_grouped_gemms_match_the_twin(cuda, tokens):
    """Both expert products at the decode (32 tokens x 8 slots) and chunk
    (32 x 512 tokens x 8) shapes, a quarter of the tokens not live: the
    grouped GEMM against the per-group product in fp32 under the 2x rule
    (the per-group product in bf16 is the baseline), on the live rows."""
    h, router, gate_up, down = _moe_inputs(tokens, cuda)
    live = torch.arange(tokens, device=cuda) % 4 != 3
    _, idx = route(torch.nn.functional.linear(h, router), 8, True)
    order, ends = dispatch(idx, live, 128)
    n = int(ends[-1])
    assert n == int(live.sum()) * 8
    xs = h[order // 8]
    for x, w in ((xs, gate_up),
                 (torch.randn(xs.shape[0], 768, device=cuda,
                              dtype=torch.bfloat16), down)):
        got = grouped_mm(x, w, ends)[:n].float()
        want = grouped_mm_plain(x.float(), w.float(), ends)[:n]
        base = grouped_mm_plain(x, w, ends)[:n].float()
        err = (got - want).abs().max().item()
        assert err <= 2 * (base - want).abs().max().item() + 1e-5


def test_moe_eager_call_reads_nothing_back(cuda):
    """An eager routed-experts call at the chunk shape under
    ``set_sync_debug_mode("error")``: no operation waits for the card."""
    h, router, gate_up, down = _moe_inputs(4 * 512, cuda, seed=1)
    live = torch.arange(h.shape[0], device=cuda) < 1500
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = moe_experts(h, router, gate_up, down, 8, True, live)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert torch.isfinite(out).all() and not out[1500:].any()


def _qwen_caches(cfg, rows, seed, cuda):
    rng = np.random.default_rng(seed)
    shape = (cfg.n_kv_head, 1 + rows * GRAPH_PMAX, GRAPH_PS, cfg.head_dim)
    return [torch_cache.PagedKVCache(_randn(rng, shape, cfg.dtype, cuda),
                                     _randn(rng, shape, cfg.dtype, cuda))
            for _ in range(cfg.n_layer)]


@pytest.mark.parametrize("phase, rows", [
    ("chunk_prefill_step", 1), ("chunk_prefill_step", 4),
    ("decode_step", 32)])
def test_qwen3_moe_graphs_match_the_eager_body(cuda, phase, rows):
    """Qwen3-30B-A3B-shaped phases (2 layers: QK-norm, head_dim 128 at
    hidden 2048, GQA 32/4, 128 routed experts) on the card: the graphed
    call gives the eager body's logits and pages bit for bit, and the
    launch counters, the experts' grouped GEMMs among them, grow by the
    eager body's amounts."""
    cfg, model = _qwen_model(cuda)
    graphed = _qwen_caches(cfg, rows, 1, cuda)
    eager = [torch_cache.PagedKVCache(c.k_pages.clone(), c.v_pages.clone())
             for c in graphed]
    for seed in (2, 3):
        args = _graph_args(phase, rows, seed, cfg, cuda)
        c0 = llama_decode._counts()
        logits, caches = getattr(llama_decode, phase)(model, cfg, graphed,
                                                      *args)
        c1 = llama_decode._counts()
        want = _eager(phase)(model, cfg, eager, *args)
        c2 = llama_decode._counts()
        torch.cuda.synchronize()
        assert torch.equal(logits, want), seed
        for g, e in zip(graphed, eager):
            assert torch.equal(g.k_pages[:, 1:], e.k_pages[:, 1:]), seed
            assert torch.equal(g.v_pages[:, 1:], e.v_pages[:, 1:]), seed
        grew = [b - a for a, b in zip(c0, c1)]
        assert grew == [b - a for a, b in zip(c1, c2)], seed
        at = llama_decode._COUNTERS.index((grouped_mm, "launches"))
        assert grew[at] == 2 * cfg.n_layer  # two grouped GEMMs a layer
        assert _chain_grew(grew) == _chain_launches(cfg), seed


def test_llama_graphs_capture_anew_for_moved_weights(cuda):
    """Weights moved after a graphed call (new data under every
    parameter, the old freed): the next call captures anew and gives the
    eager body's logits bit for bit."""
    cfg = LlamaConfig(**dict(QWEN_CFG, n_layer=1))
    model = LlamaForCausalLM(
        cfg, device=cuda, generator=torch.Generator(device=cuda).manual_seed(1))
    caches = _qwen_caches(cfg, 8, 4, cuda)
    args = _graph_args("decode_step", 8, 5, cfg, cuda)
    llama_decode.decode_step(model, cfg, caches, *args)
    first = llama_decode._GRAPHS[model]
    with torch.no_grad():
        for p in model.parameters():
            p.data = p.data * 1.5
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    eager = [torch_cache.PagedKVCache(c.k_pages.clone(), c.v_pages.clone())
             for c in caches]
    for seed in (6, 7):
        args = _graph_args("decode_step", 8, seed, cfg, cuda)
        logits, _ = llama_decode.decode_step(model, cfg, caches, *args)
        want = llama_decode._decode_body(model, cfg, eager, *args)
        torch.cuda.synchronize()
        assert torch.equal(logits, want), seed
    assert llama_decode._GRAPHS[model] is not first


# ----------------------------- the serving chain (kernels/llama_chain.py)

# (rows, n) of the residual stream: Mistral-7B's 64-row decode, Qwen3's
# 32-row decode, Mistral's chunk of 8 x 512 tokens
NORM_SHAPES = [(64, 4096), (32, 2048), (8 * 512, 4096)]


@pytest.mark.parametrize("pending", [True, False], ids=["add", "first"])
@pytest.mark.parametrize("rows, n", NORM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_llama_chain_add_rmsnorm_matches_the_twin(cuda, dtype, rows, n,
                                                  pending):
    """Residual add + RMSNorm against the twin in fp32 (2x rule, the twin
    in the same dtype the baseline); the residual sum bit for bit. x is a
    strided view (every other row of a buffer), as a decode step's rows
    can be."""
    rng = np.random.default_rng(rows + n)
    x = _randn(rng, (2 * rows, n), dtype, cuda)[::2]
    d = _randn(rng, (rows, n), dtype, cuda) if pending else None
    w = (0.5 + torch.rand(n, device=cuda)).to(torch.bfloat16)
    with torch.no_grad():
        res, out = llama_chain.add_rmsnorm(x, d, w, 1e-5)
        base_res, base = llama_chain.add_rmsnorm_plain(x, d, w, 1e-5)
    torch.cuda.synchronize()
    assert res.dtype == out.dtype == dtype
    assert torch.equal(res, base_res)
    if not pending:
        assert res is x
    # the oracle: the norm of the rounded sum, in fp32
    want = llama_chain.rms_norm_plain(res.float(), w, 1e-5, torch.float32)
    assert_two_x_bound(out, want, base, label="add_rmsnorm")


# (b, s, n_head, n_kv_head, QK-norm, largest position)
ROPE_SHAPES = [(64, 1, 32, 8, False, 7000), (32, 1, 32, 4, True, 2300),
               (8, 512, 32, 8, False, 7000), (4, 512, 32, 4, True, 2300)]


@pytest.mark.parametrize("b, s, hq, hk, norm, top", ROPE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_llama_chain_qk_rope_matches_the_twin(cuda, dtype, b, s, hq, hk,
                                              norm, top):
    """QK-norm + rotary in place, at positions up to ``top`` (longdoc's
    reach 7,000), against the twin in fp32 under the 2x rule; q and k are
    views of one fused projection."""
    rng = np.random.default_rng(b * s)
    hd = 128
    fused = _randn(rng, (b, s, hq + 2 * hk, hd), dtype, cuda)
    pos0 = rng.integers(0, top - s + 1, b)
    positions = (torch.from_numpy(pos0)[:, None]
                 + torch.arange(s)).to(cuda)
    inv_freq = llama_chain.rope_inv_freq(hd, 1e6 if norm else 1e4, cuda)
    w = [(0.5 + torch.rand(hd, device=cuda)).to(torch.bfloat16)
         if norm else None for _ in range(2)]
    q, k, _ = fused.split([hq, hk, hk], dim=2)
    base = [t.clone() for t in (q, k)]
    want = [t.float() for t in (q, k)]
    with torch.no_grad():
        got = llama_chain.qk_rope(q, k, positions, inv_freq, *w, eps=1e-6)
        llama_chain.qk_rope_plain(*base, positions, inv_freq, *w, eps=1e-6)
        llama_chain.qk_rope_plain(*want, positions, inv_freq, *w, eps=1e-6)
    torch.cuda.synchronize()
    assert got[0] is q and got[1] is k
    for g, w32, b16, name in zip(got, want, base, "qk"):
        assert_two_x_bound(g, w32, b16, label=f"qk_rope {name}")


# (rows, n, fused): Mistral-7B's MLP at the 64-row decode and the 8 x 512
# chunk; the routed experts' halves of (rows, 2 n) at Qwen3's 32 x 8
# decode slots and a 4 x 512-token chunk's 16,384 slots
GLU_SHAPES = [(64, 14336, False), (8 * 512, 14336, False),
              (32 * 8, 768, True), (4 * 512 * 8, 768, True)]


@pytest.mark.parametrize("rows, n, fused", GLU_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_llama_chain_swiglu_matches_the_twin(cuda, dtype, rows, n, fused):
    """silu(gate) * up against the twin in fp32 under the 2x rule, on two
    products or on the two strided halves of the experts' fused one."""
    rng = np.random.default_rng(rows + n)
    if fused:
        gu = _randn(rng, (rows, 2 * n), dtype, cuda)
        gate, up = gu[:, :n], gu[:, n:]
    else:
        gate, up = (_randn(rng, (rows, n), dtype, cuda) for _ in range(2))
    with torch.no_grad():
        got = llama_chain.swiglu(gate, up)
    torch.cuda.synchronize()
    want = llama_chain.swiglu_plain(gate.float(), up.float())
    base = llama_chain.swiglu_plain(gate, up)
    assert got.dtype == dtype and got.is_contiguous()
    assert_two_x_bound(got, want, base, label="swiglu")


def test_llama_chain_refuses_grad_and_misaligned_rows(cuda):
    x = torch.randn(4, 64, device=cuda, requires_grad=True)
    w = torch.ones(64, device=cuda)
    with pytest.raises(RuntimeError, match="forward-only"):
        llama_chain.add_rmsnorm(x, None, w, 1e-5)
    odd = torch.randn(4, 65, device=cuda, dtype=torch.bfloat16)[:, 1:]
    with torch.no_grad(), pytest.raises(RuntimeError, match="fattn_swiglu"):
        llama_chain.swiglu(odd, odd)


# Kernel names that are not the chain's: GEMMs (cuBLAS, CUTLASS, and
# cuBLASLt's split-K reduction of a small-batch product) and the attention
# and cache kernels K5, K6, K7 with their split merge.
NOT_CHAIN = ("gemm", "cutlass", "nvjet", "xmma", "sm90_", "splitkreduce",
             "paged_", "write_pages", "append_")


def chain_kernels_per_layer(model, cfg, caches, args):
    """The kernels of one replayed decode step other than GEMMs and
    K5/K6/K7, by name: those a second layer adds to a one-layer step (the
    replay's input copies, the embedding, the final norm and the head's
    cast cancel)."""
    per = []
    for layers in (1, 2):
        cs = caches[:layers]
        llama_decode.decode_step(model, cfg, cs, *args)  # the capture
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            llama_decode.decode_step(model, cfg, cs, *args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not any(k in e.name.lower() for k in NOT_CHAIN)]
        per.append(names)
    extra = list(per[1])
    for name in per[0]:
        extra.remove(name)
    return extra


@pytest.mark.parametrize("which, rows, limit", [("mistral", 64, 4),
                                                ("qwen", 32, 27)])
def test_llama_chain_kernels_per_layer_of_a_graphed_decode_step(
        cuda, which, rows, limit):
    """A graphed decode step's kernels a layer, other than GEMMs and K5:
    at Mistral-7B's widths the chain's four (two norms, rotary, SwiGLU;
    47 op by op before them); at Qwen3's those and the experts' routing
    and dispatch (softmax, top-k, sort, search, gather, index copy,
    combine: 23; 88 in all before)."""
    cfg, model = _graph_model(cuda) if which == "mistral" \
        else _qwen_model(cuda)
    caches = (_graph_caches if which == "mistral" else _qwen_caches)(
        cfg, rows, 13, cuda)
    extra = chain_kernels_per_layer(model, cfg, caches,
                                    _graph_args("decode_step", rows, 14,
                                                cfg, cuda))
    print(f"{which}: {len(extra)} kernels a layer: {sorted(extra)}")
    assert len(extra) <= limit, sorted(extra)
    assert sum("add_rmsnorm" in n for n in extra) == 2
    assert sum("qk_rope" in n for n in extra) == 1
    assert sum("swiglu" in n for n in extra) == 1
