"""The port's CUDA kernels against their plain-torch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode), carries the ``gpu`` marker and skips without a card. This file
imports no JAX, so it runs on a machine that has only PyTorch
(``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py -q

Tolerances: attention and decode are held to the repo's 2x rule (error
against the fp32 twin at most twice a plain same-dtype implementation's,
plus 1e-5); cache writes are bitwise equal outside the scratch page 0. The
backward kernel's gradients are held to the 2x rule against fp32 autograd
through ``attention_ref`` (the same-dtype ``attention_ref(upcast=False)``
in autograd is the baseline), plus 1e-4: the fp32 gradients sum hundreds
of terms in another order than the oracle.
"""

import copy

import numpy as np
import pytest
import torch

from flash_attn_tpu_torch import flash_attention
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
from flash_attn_tpu_torch.models.gpt2 import (
    GPT2Config,
    GPT2LMHeadModel,
    make_train_step,
)
from flash_attn_tpu_torch.reference import attention_lse_ref, attention_ref
from flash_attn_tpu_torch.serving import cache as torch_cache
from flash_attn_tpu_torch.serving.engine import ServingEngine
from flash_attn_tpu_torch.utils.testing import assert_two_x_bound

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
ATTN_CASES = [
    (2, 128, 128, 2, 2, 64, True),
    (2, 128, 128, 2, 2, 64, False),
    (1, 96, 160, 2, 2, 64, True),
    (1, 160, 96, 2, 2, 64, True),
    (1, 80, 200, 2, 2, 64, False),
    (1, 300, 300, 2, 2, 64, True),
    (1, 130, 130, 4, 2, 64, True),
    (1, 200, 200, 2, 1, 128, True),
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


@pytest.mark.parametrize("dropout_p", [0.0, 0.1])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("case", ATTN_CASES, ids=str)
def test_flash_bwd_kernel_matches_twin(cuda, case, dtype, dropout_p):
    """K2's dq, dk, dv against the twin and, by the 2x rule, against fp32
    autograd through attention_ref."""
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
    for name, g, tw, o, n in zip("qkv", grads, twins, oracle, native):
        assert g.dtype == dtype and g.shape == tw.shape
        assert_two_x_bound(g, o, n, atol=1e-4,
                           label=f"d{name} {case} {dtype} p={dropout_p}")
        assert_two_x_bound(g, tw.float(), n, atol=1e-4,
                           label=f"d{name} vs twin {case} {dtype}")


@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_bwd_kernel_neg_inf_lse_rows(cuda, dtype):
    """Rows whose lse is -inf (no visible key) give p = 0, not inf: they
    add nothing to dk/dv and get dq = 0, as in the twin."""
    case = ATTN_CASES[5]
    q, k, v, dout = _qkv(case, dtype, cuda)
    kw = dict(causal=True, softmax_scale=0.125)
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
    """Same-dtype dense attention over each sequence's gathered keys."""
    outs = []
    ps = kp.shape[2]
    for i, n in enumerate(lens.tolist()):
        if n == 0:
            outs.append(torch.zeros_like(q[i]))
            continue
        pages = table[i, : -(-n // ps)].long()
        k = kp[:, pages].flatten(1, 2)[:, :n]
        v = vp[:, pages].flatten(1, 2)[:, :n]
        outs.append(attention_ref(q[i][:, None], k, v, upcast=False)[:, 0])
    return torch.stack(outs)


# (lengths, h, h_kv, d, page_size, pages_max)
DECODE_CASES = [
    ([1, 16, 17, 40], 2, 2, 64, 16, 3),
    ([33, 48, 5], 4, 2, 64, 16, 4),
    ([100, 7], 8, 2, 128, 32, 4),
    ([64, 0, 12], 2, 1, 64, 16, 4),
    ([1000, 1, 513], 12, 12, 64, 128, 8),  # GPT-2 widths, long context
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
