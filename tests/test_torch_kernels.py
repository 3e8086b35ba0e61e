"""The port's CUDA kernels against their plain-torch twins, on the card.

Every test here needs an NVIDIA GPU and nvcc (a CUDA kernel has no CPU
mode), carries the ``gpu`` marker and skips without a card. This file
imports no JAX, so it runs on a machine that has only PyTorch
(``--noconftest`` skips tests/conftest.py, which imports JAX):

    python -m pytest -m gpu --noconftest tests/test_torch_kernels.py -q

Tolerances: attention and decode are held to the repo's 2x rule (error
against the fp32 twin at most twice a plain same-dtype implementation's,
plus 1e-5); cache writes are bitwise equal outside the scratch page 0.
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
from flash_attn_tpu_torch.kernels.flash_fwd import (
    flash_attention_fwd,
    flash_attention_fwd_plain,
)
from flash_attn_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
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


def test_flash_attention_refuses_grad_on_cuda(cuda):
    q = torch.zeros(1, 8, 1, 64, device=cuda, requires_grad=True)
    with pytest.raises(NotImplementedError, match="backward"):
        flash_attention(q, q, q)


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
    model = GPT2LMHeadModel(cfg, generator=torch.Generator().manual_seed(0))
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
