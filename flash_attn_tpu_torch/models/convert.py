"""Load a flax GPT-2, Llama or BERT parameter tree into the port's
``GPT2LMHeadModel``, ``LlamaForCausalLM`` or ``BertForMaskedLM``.

The tree comes in as numpy arrays (the caller runs
``jax.tree_util.tree_map(np.asarray, params)``), so this module imports no
JAX. Flax ``Dense.kernel`` is (in, out) and ``nn.Linear.weight`` is
(out, in): kernels are transposed.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attn_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from flash_attn_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from flash_attn_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM


def gpt2_from_jax_params(params, cfg: GPT2Config, device="cuda",
                         attn_impl=None) -> GPT2LMHeadModel:
    """``params``: the flax tree ``{"params": {...}}`` (or its inner dict)
    of ``flash_attn_tpu.models.gpt2.GPT2LMHeadModel`` as numpy arrays.
    Returns the port's model on ``device`` with its parameters stored in
    ``cfg.param_dtype`` (fp32 by default, as the flax tree holds them);
    ``cfg`` also carries ``dropout`` and ``remat`` for training, and
    ``attn_impl`` the attention op (the tree is the same with or without
    one)."""
    p = params.get("params", params)
    # Every parameter is overwritten below; the seed only fills the module.
    model = GPT2LMHeadModel(cfg, device=device, attn_impl=attn_impl,
                            generator=torch.Generator().manual_seed(0))

    def norm(ln, tree):
        put(ln.weight, tree["scale"])
        put(ln.bias, tree["bias"])

    with torch.no_grad():
        put(model.wte.weight, p["wte"])
        put(model.wpe.weight, p["wpe"])
        for i, block in enumerate(model.h):
            tree = p[f"h_{i}"]
            norm(block.ln_1, tree["ln_1"])
            norm(block.ln_2, tree["ln_2"])
            mha_from_jax_params(tree["attn"], block.attn)
            dense(block.mlp.c_fc, tree["mlp"]["c_fc"])
            dense(block.mlp.c_proj, tree["mlp"]["c_proj"])
        norm(model.ln_f, p["ln_f"])
    return model


def mha_from_jax_params(params, mha):
    """Carry a flax attention block's ``Wqkv`` and ``out_proj`` (numpy
    leaves) into ``mha``, a ``FlashMHA`` or ``FlashBlocksparseMHA`` (the
    same tree). Returns ``mha``."""
    p = params.get("params", params)
    with torch.no_grad():
        dense(mha.Wqkv, p["Wqkv"])
        dense(mha.out_proj, p["out_proj"])
    return mha


def llama_from_jax_params(params, cfg: LlamaConfig, device="cuda"
                          ) -> LlamaForCausalLM:
    """``params``: the flax tree of ``flash_attn_tpu.models.llama
    .LlamaForCausalLM`` as numpy arrays (``wte``, ``lm_head``,
    ``layers_{i}/{input_layernorm, attn/{q,k,v,o}_proj,
    post_attention_layernorm, mlp/{gate,up,down}_proj}``, ``norm``).
    Returns the port's model on ``device``, parameters in
    ``cfg.param_dtype``."""
    p = params.get("params", params)
    model = LlamaForCausalLM(cfg, device=device,
                             generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        put(model.wte.weight, p["wte"])
        put(model.lm_head.weight, p["lm_head"])  # (vocab, n_embd) both
        put(model.norm.weight, p["norm"]["scale"])
        for i, block in enumerate(model.layers):
            tree = p[f"layers_{i}"]
            put(block.input_layernorm.weight,
                tree["input_layernorm"]["scale"])
            put(block.post_attention_layernorm.weight,
                tree["post_attention_layernorm"]["scale"])
            for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
                put(getattr(block.attn, name).weight,
                    tree["attn"][name]["kernel"], transpose=True)
            for name in ("gate_proj", "up_proj", "down_proj"):
                put(getattr(block.mlp, name).weight,
                    tree["mlp"][name]["kernel"], transpose=True)
    return model


def bert_from_jax_params(params, cfg: BertConfig, device="cuda"
                         ) -> BertForMaskedLM:
    """``params``: the flax tree of ``flash_attn_tpu.models.bert
    .BertForMaskedLM`` as numpy arrays (``bert/{embeddings, layer_{i},
    pooler}``, ``transform``, ``transform_ln``, ``decoder``). Returns the
    port's model on ``device``, parameters in ``cfg.param_dtype``."""
    p = params.get("params", params)
    model = BertForMaskedLM(cfg, device=device,
                            generator=torch.Generator().manual_seed(0))

    def norm(ln, tree):
        put(ln.weight, tree["scale"])
        put(ln.bias, tree["bias"])

    with torch.no_grad():
        emb, tree = model.bert.embeddings, p["bert"]["embeddings"]
        for name in ("word_embeddings", "position_embeddings",
                     "token_type_embeddings"):
            put(getattr(emb, name).weight, tree[name]["embedding"])
        norm(emb.LayerNorm, tree["LayerNorm"])
        for i, layer in enumerate(model.bert.layers()):
            tree = p["bert"][f"layer_{i}"]
            mha_from_jax_params(tree["attention"], layer.attention)
            norm(layer.attention_ln, tree["attention_ln"])
            dense(layer.intermediate, tree["intermediate"])
            dense(layer.output, tree["output"])
            norm(layer.output_ln, tree["output_ln"])
        dense(model.bert.pooler, p["bert"]["pooler"])
        dense(model.transform, p["transform"])
        norm(model.transform_ln, p["transform_ln"])
        dense(model.decoder, p["decoder"])
    return model


def dense(lin, tree):
    """A flax ``Dense`` leaf pair into an ``nn.Linear``."""
    put(lin.weight, tree["kernel"], transpose=True)
    if lin.bias is not None:
        put(lin.bias, tree["bias"])


def put(dst: torch.Tensor, src, transpose=False):
    """Copy a numpy leaf into a parameter, transposed when asked."""
    src = np.array(src)  # a writable copy
    if transpose:
        src = src.T
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"shape {src.shape} for a {tuple(dst.shape)} "
                         "parameter")
    dst.copy_(torch.from_numpy(np.ascontiguousarray(src)))
