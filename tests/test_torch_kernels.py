"""The port's CUDA kernels against their plain-torch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode), carries the ``gpu`` marker and skips without a card. This file
imports no JAX, so it runs on a machine that has only PyTorch
(``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py -q

Tolerances: attention, decode and chunk attention are held to the repo's
2x rule (error against the fp32 twin at most twice a plain same-dtype
implementation's, plus 1e-5); cache writes are bitwise equal outside the
scratch page 0 (the span append writes nothing there: all pages). The
backward kernels' gradients (K2, and K8b/K8c of blocksparse attention) are
held to the 2x rule against fp32 autograd through ``attention_ref`` (the
same-dtype ``attention_ref(upcast=False)`` in autograd is the baseline),
plus 1e-4: the fp32 gradients sum hundreds of terms in another order than
the oracle. Blocksparse dropout masks are held bit for bit to
``dropout_mask_dense``, and every kernel to itself over 10 seeded reruns.
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
    paged_chunk_attention,
    paged_chunk_attention_plain,
)
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
from flash_attn_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from flash_attn_tpu_torch.reference import (
    attention_lse_ref,
    attention_ref,
    paged_chunk_ref,
)
from flash_attn_tpu_torch.serving import cache as torch_cache
from flash_attn_tpu_torch.serving.engine import ServingEngine
from flash_attn_tpu_torch.serving.speculative import speculative_decode
from flash_attn_tpu_torch.utils.testing import (
    assert_two_x_bound,
    max_err,
    packed_views,
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
    """K5 and K6 (split-KV merged in split order): out bit for bit, at
    Llama-3-8B's widths (GQA 32/8, d 128) with a long and an empty row."""
    lengths = [300, 4000, 5, 0]
    q, kp, vp, lens, table = _chunk_inputs(np.random.default_rng(9), lengths,
                                           5, 32, 8, 128, 128, 32, dtype,
                                           cuda)
    cl = torch.tensor([5, 5, 5, 0], dtype=torch.int32, device=cuda)
    _reruns_equal(lambda: (
        paged_decode_attention(q[:, 0], kp, vp, lens, table),
        paged_chunk_attention(q, kp, vp, lens, table, chunk_lens=cl)))
