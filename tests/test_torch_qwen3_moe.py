"""Qwen3-MoE in the port (``models/moe.py``, ``LlamaConfig``'s
``head_dim`` / ``qk_norm`` / ``num_experts``) and the benchmark's plain
reference (``portbench/reference/qwen3_moe.py``), on the CPU.

Everything runs in fp32. Against ``transformers``' ``Qwen3MoeForCausalLM``
(random weights, no download) the port and the reference agree to atol
1e-5 on logits of order 1: the same operations summed in other orders
(online softmax against the eager one; the experts' products and their
weighted sum gathered otherwise). The serving phases against the
reference's full forward at atol 1e-4: a paged cache walked in pages and
chunks. The routed layer's twin against the reference's expert loop at
atol 1e-5.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from flash_attn_tpu_torch.models import llama_decode
from flash_attn_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    convert_hf_qwen3_moe_state_dict,
    load_hf_qwen3_moe,
    qwen3_moe_config_from_hf,
)
from flash_attn_tpu_torch.models.moe import MoeMlp, moe_experts
from flash_attn_tpu_torch.serving import cache as torch_cache
from flash_attn_tpu_torch.serving.engine import ServingEngine
from portbench.harness.common import load_file_module, make_weights
from portbench.reference import qwen3_moe as ref

REPO = Path(__file__).resolve().parents[1]
family = load_file_module(REPO / "portbench/families/qwen3_moe.py")
llama_family = load_file_module(REPO / "portbench/families/llama.py")

# Tiny Qwen3-MoE: head_dim 32 where hidden / heads is 16.
TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=96,
            moe_intermediate_size=48, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, head_dim=32,
            num_experts=8, num_experts_per_tok=2, norm_topk_prob=True,
            max_position_embeddings=512, rope_theta=1e6, rms_norm_eps=1e-6,
            decoder_sparse_step=1, mlp_only_layers=[], sliding_window=None,
            torch_dtype="float32")


def tiny_config(**kw):
    c = json.loads((REPO / "portbench/configs/qwen3-30b-a3b.json")
                   .read_text())
    c.update(TINY, **kw)
    return c


@pytest.fixture(scope="module")
def tiny():
    """(c, cfg, weights, model): the family's model on the benchmark's
    weights from a seed, matrices scaled to std 0.2 so that routing is
    decided."""
    c = tiny_config()
    cfg = family.port_config(c, train=False)
    w = make_weights(family.param_spec(c), 5, torch.float32, "cpu")
    for name, t in w.items():
        if t.dim() > 1:
            t.mul_(10.0)
    return c, cfg, w, family.build(cfg, w, "cpu", train=False)


def ref_logits(w, c, ids):
    return ref.served_logits(w, c, [(torch.as_tensor(ids), 0)])[0]


# ------------------------------------------------------------ HF interop

def _hf_model():
    transformers = pytest.importorskip("transformers")
    hc = transformers.Qwen3MoeConfig(
        vocab_size=256, hidden_size=64, intermediate_size=96,
        moe_intermediate_size=48, num_hidden_layers=2, num_attention_heads=4,
        num_key_value_heads=2, head_dim=32, num_experts=8,
        num_experts_per_tok=2, norm_topk_prob=True,
        max_position_embeddings=512, rope_theta=1e6, rms_norm_eps=1e-6,
        mlp_only_layers=[])
    torch.manual_seed(0)
    hf = transformers.Qwen3MoeForCausalLM(hc).eval()
    with torch.no_grad():
        for n, p in hf.named_parameters():
            if "norm" in n:
                p.uniform_(0.5, 1.5)
            else:
                p.normal_(0.0, 0.1)
    return hf


def test_port_and_reference_equal_transformers():
    hf = _hf_model()
    cfg = qwen3_moe_config_from_hf(hf.config, dtype=torch.float32)
    assert (cfg.head_dim, cfg.n_embd // cfg.n_head) == (32, 16)
    assert cfg.window is None and cfg.qk_norm
    model = LlamaForCausalLM(cfg, generator=None, device="cpu")
    model.load_state_dict(convert_hf_qwen3_moe_state_dict(hf.state_dict(),
                                                          cfg))
    ids = torch.from_numpy(np.random.default_rng(0).integers(0, 256,
                                                             (2, 40)))
    with torch.no_grad():
        want = hf(ids).logits
        port = model(ids)
    c = tiny_config()
    weights = {n: p.detach() for n, p in model.named_parameters()}
    got = [ref_logits(weights, c, row) for row in ids]
    torch.testing.assert_close(port, want, atol=1e-5, rtol=0)
    torch.testing.assert_close(torch.stack(got), want, atol=1e-5, rtol=0)
    assert want.abs().max() > 1.0  # the tolerance is a small share


def test_load_hf_qwen3_moe_stacks_the_experts():
    hf = _hf_model()
    cfg, model = load_hf_qwen3_moe(hf, device="cpu")
    sd = hf.state_dict()
    e3 = "model.layers.1.mlp.experts.3."
    gu = model.layers[1].mlp.gate_up_proj[3]
    torch.testing.assert_close(gu[:48], sd[e3 + "gate_proj.weight"])
    torch.testing.assert_close(gu[48:], sd[e3 + "up_proj.weight"])
    torch.testing.assert_close(model.layers[1].mlp.down_proj[3],
                               sd[e3 + "down_proj.weight"])
    torch.testing.assert_close(model.layers[0].mlp.router.weight,
                               sd["model.layers.0.mlp.gate.weight"])
    torch.testing.assert_close(model.layers[0].attn.k_norm.weight,
                               sd["model.layers.0.self_attn.k_norm.weight"])


# ------------------------------------------------------- the routed layer

def _layer(seed=0, E=8, k=2, I=24, e=32):
    g = torch.Generator().manual_seed(seed)
    cfg = LlamaConfig.tiny(n_embd=e, num_experts=E, num_experts_per_tok=k,
                           moe_intermediate_size=I, norm_topk_prob=True)
    mlp = MoeMlp(cfg, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        for p in mlp.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        # Uneven routing (h >= 0): experts 0 and 1 favoured, expert 7
        # never chosen.
        mlp.router.weight[0:2] += 0.05
        mlp.router.weight[7] = -mlp.router.weight[7].abs()
    h = torch.randn(40, e, generator=g).abs()
    return mlp, h


def _reference_layer(mlp, h):
    c = {"num_experts": mlp.config.num_experts,
         "num_experts_per_tok": mlp.config.num_experts_per_tok,
         "moe_intermediate_size": mlp.config.moe_intermediate_size,
         "norm_topk_prob": True}
    w = {"mlp.router.weight": mlp.router.weight.detach(),
         "mlp.gate_up_proj": mlp.gate_up_proj.detach(),
         "mlp.down_proj": mlp.down_proj.detach()}
    return ref.experts(h, w.__getitem__, "", c, "fp32")


def test_routed_layer_matches_the_reference_expert_loop():
    mlp, h = _layer()
    with torch.no_grad():
        idx = torch.topk(mlp.router(h), 2, dim=-1).indices
        counts = torch.bincount(idx.flatten(), minlength=8)
        assert counts[7] == 0  # an expert that receives no token
        assert counts.max() >= 3 * counts[counts > 0].min()  # uneven
        got = mlp(h)
    torch.testing.assert_close(got, _reference_layer(mlp, h), atol=1e-5,
                               rtol=0)


def test_tokens_that_are_not_live_route_nowhere():
    mlp, h = _layer(seed=1)
    live = torch.arange(40) % 3 != 0
    with torch.no_grad():
        got = mlp(h, live)
        alone = mlp(h[live])
    assert torch.equal(got[~live], torch.zeros_like(got[~live]))
    torch.testing.assert_close(got[live], alone, atol=1e-6, rtol=0)


def test_moe_experts_in_bf16_follows_fp32():
    mlp, h = _layer(seed=2)
    with torch.no_grad():
        want = mlp(h)
        p = {n: t.bfloat16() for n, t in mlp.named_parameters()}
        got = moe_experts(h.bfloat16(), p["router.weight"],
                          p["gate_up_proj"], p["down_proj"], 2, True)
    assert got.dtype == torch.bfloat16
    # bf16 may flip a near-tied choice: compare the rows it keeps.
    rows = (torch.topk(mlp.router(h), 2).indices
            == torch.topk(torch.nn.functional.linear(
                h.bfloat16(), p["router.weight"]).float(), 2)
            .indices).all(-1)
    assert rows.sum() >= 30
    torch.testing.assert_close(got[rows].float(), want[rows], atol=0.05,
                               rtol=0.05)


# ------------------------------------------------------ the serving path

def test_meta_construction_allocates_nothing(tiny):
    c, cfg, w, model = tiny
    empty = LlamaForCausalLM(cfg, generator=None, device="meta")
    assert all(p.is_meta for p in empty.parameters())
    names = [n for n, _, _ in family.param_spec(c)]
    assert sorted(names) == sorted(n for n, _ in model.named_parameters())
    assert all(p.data_ptr() == w[n].data_ptr()
               for n, p in model.named_parameters())
    with pytest.raises(ValueError, match="no weights"):
        family.build(cfg, {k: v for k, v in w.items()
                           if k != "norm.weight"}, "cpu", train=False)


def test_phases_match_the_reference_forward(tiny):
    """Chunked prefill in chunks of 16 (two rows, one padded), then decode
    steps, against the reference's logits at every position."""
    c, cfg, w, model = tiny
    PS, P = 16, 6
    rng = np.random.default_rng(3)
    lens, steps = [37, 20], 5
    seqs = [rng.integers(0, 256, n + steps).tolist() for n in lens]
    want = [ref_logits(w, c, s) for s in seqs]
    caches = [torch_cache.init_cache(cfg.n_kv_heads, 1 + 2 * P, PS,
                                     cfg.head_dim, dtype=torch.float32,
                                     device="cpu")
              for _ in range(cfg.n_layer)]
    table = torch.tensor([[1 + j for j in range(P)],
                          [1 + P + j for j in range(P)]], dtype=torch.int32)
    for off in range(0, max(lens), 16):
        cl = [max(0, min(n - off, 16)) for n in lens]
        ids = torch.zeros(2, 16, dtype=torch.int64)
        for i, n in enumerate(cl):
            ids[i, :n] = torch.tensor(seqs[i][off:off + n])
        wtbl = torch.where(torch.tensor(cl)[:, None] > 0,
                           table[:, off // PS:off // PS + 1], 0)
        logits, caches = llama_decode.chunk_prefill_step(
            model, cfg, caches, ids,
            torch.tensor([min(n, off) for n in lens], dtype=torch.int32),
            torch.tensor(cl, dtype=torch.int32), wtbl, table)
        for i, n in enumerate(lens):
            if off < n <= off + 16:
                torch.testing.assert_close(logits[i], want[i][n - 1],
                                           atol=1e-4, rtol=0)
    for t in range(steps):
        pos = torch.tensor([n + t for n in lens], dtype=torch.int32)
        tok = torch.tensor([s[n + t] for s, n in zip(seqs, lens)])
        logits, caches = llama_decode.decode_step(model, cfg, caches, table,
                                                  pos, tok)
        for i, n in enumerate(lens):
            torch.testing.assert_close(logits[i], want[i][n + t], atol=1e-4,
                                       rtol=0)


def test_engine_serves_the_reference_tokens(tiny):
    """``ServingEngine`` + ``llama_decode`` (chunked prefill, padded rows,
    a free decode slot) serves the reference's greedy tokens."""
    c, cfg, w, model = tiny
    engine = ServingEngine(model, cfg, model_fns=llama_decode, max_batch=4,
                           page_size=16, pages_per_seq=8, num_pages=33,
                           prefill_chunk=32, eos_token=None)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, n).tolist() for n in (45, 9, 70)]
    for p in prompts:
        engine.submit(p, max_new_tokens=6)
    done = sorted(engine.run(), key=lambda r: r.seq_id)
    assert [len(r.generated) for r in done] == [6, 6, 6]
    for p, r in zip(prompts, done):
        full = ref_logits(w, c, p + r.generated[:-1])[len(p) - 1:]
        best = full.max(-1).values
        chosen = full.gather(-1, torch.tensor(r.generated)[:, None])[:, 0]
        assert float((best - chosen).max()) < 1e-4


# ------------------------------------------- dense configurations unchanged

@pytest.mark.parametrize("name", ["mistral-7b", "mistral-7b-8l"])
def test_dense_configs_keep_their_parameters(name):
    c = json.loads((REPO / f"portbench/configs/{name}.json").read_text())
    cfg = llama_family.port_config(c, train=False)
    assert (cfg.head_dim, cfg.qk_norm, cfg.num_experts) == (128, False, 0)
    model = LlamaForCausalLM(cfg, generator=None, device="meta")
    assert [n for n, _ in model.named_parameters()] == \
        [n for n, _, _ in llama_family.param_spec(c)]


def test_dense_block_ignores_live_and_matches_its_reference():
    cfg = LlamaConfig.tiny()
    model = LlamaForCausalLM(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    block = model.layers[0]
    x = torch.randn(2, 5, cfg.n_embd)
    ctx = torch.randn(2, 5, cfg.n_head * cfg.head_dim)
    live = torch.rand(2, 5) > 0.5
    with torch.no_grad():
        assert torch.equal(block.finish(x, ctx, live), block.finish(x, ctx))
    llama_ref = load_file_module(REPO / "portbench/reference/llama.py")
    c = {"num_hidden_layers": cfg.n_layer, "num_attention_heads": cfg.n_head,
         "num_key_value_heads": cfg.n_kv_head, "rms_norm_eps": cfg.rms_norm_eps,
         "rope_theta": cfg.rope_theta, "sliding_window": None}
    ids = torch.from_numpy(np.random.default_rng(5).integers(0, 512, 30))
    w = {n: p.detach() for n, p in model.named_parameters()}
    with torch.no_grad():
        got = model(ids[None])[0]
    want = llama_ref.served_logits(w, c, [(ids, 0)])[0]
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
