"""Load a flax GPT-2, Llama, BERT or ViT parameter tree into the port's
``GPT2LMHeadModel``, ``LlamaForCausalLM``, ``BertForMaskedLM`` or
``ViTClassifier``; and a ``transformers`` GPT-2 checkpoint into the port's
``GPT2LMHeadModel`` (port of ``flash_attn_tpu/models/convert.py``; the
Llama counterparts live in ``models/llama.py``, as there).

A flax tree comes in as numpy arrays (the caller runs
``jax.tree_util.tree_map(np.asarray, params)``), so this module imports no
JAX. Flax ``Dense.kernel`` is (in, out) and ``nn.Linear.weight`` is
(out, in): kernels are transposed. A flax ``Conv.kernel`` is HWIO and
``nn.Conv2d.weight`` OIHW.

HF GPT-2 stores its ``Conv1D`` weights as (in, out), the flax orientation,
so they are transposed too; ``c_attn`` packs its output as [q | k | v],
each head-major, which is the (3, h, d) split of ``Wqkv``; the LM head is
tied to ``wte`` in both; HF's "gelu_new" is the tanh gelu the port uses.
``transformers`` is never imported here: the caller passes a model or a
state dict.
"""

from __future__ import annotations

import numpy as np
import torch

from flash_attn_tpu_torch.models.bert import BertConfig, BertForMaskedLM
from flash_attn_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from flash_attn_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM
from flash_attn_tpu_torch.models.vit import ViTClassifier, ViTConfig


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


def vit_from_jax_params(params, cfg: ViTConfig, device="cuda"
                        ) -> ViTClassifier:
    """``params``: the flax tree of ``flash_attn_tpu.models.vit
    .ViTClassifier`` as numpy arrays (``patch_embed``, ``pos_embed`` when
    ``use_rotary`` is False, ``block_{i}/{ln1, attn, ln2, fc1, fc2}``,
    ``ln_final``, ``head``). Returns the port's model on ``device``,
    parameters in ``cfg.param_dtype``."""
    p = params.get("params", params)
    model = ViTClassifier(cfg, device=device,
                          generator=torch.Generator().manual_seed(0))

    def norm(ln, tree):
        put(ln.weight, tree["scale"])
        put(ln.bias, tree["bias"])

    with torch.no_grad():
        put(model.patch_embed.weight,
            np.transpose(p["patch_embed"]["kernel"], (3, 2, 0, 1)))
        put(model.patch_embed.bias, p["patch_embed"]["bias"])
        if model.pos_embed is not None:
            put(model.pos_embed, p["pos_embed"])
        for i, block in enumerate(model.blocks()):
            tree = p[f"block_{i}"]
            norm(block.ln1, tree["ln1"])
            mha_from_jax_params(tree["attn"], block.attn)
            norm(block.ln2, tree["ln2"])
            dense(block.fc1, tree["fc1"])
            dense(block.fc2, tree["fc2"])
        norm(model.ln_final, p["ln_final"])
        dense(model.head, p["head"])
    return model


# ------------------------------------------------------------ HF GPT-2


def gpt2_config_from_hf(hf_config, **overrides) -> GPT2Config:
    """A ``GPT2Config`` from a ``transformers.GPT2Config``."""
    kw = dict(
        vocab_size=hf_config.vocab_size,
        max_position_embeddings=hf_config.n_positions,
        n_layer=hf_config.n_layer,
        n_head=hf_config.n_head,
        n_embd=hf_config.n_embd,
        layer_norm_epsilon=hf_config.layer_norm_epsilon,
    )
    kw.update(overrides)
    return GPT2Config(**kw)


def convert_hf_gpt2_state_dict(state_dict, cfg: GPT2Config
                               ) -> dict[str, torch.Tensor]:
    """A ``transformers`` ``GPT2LMHeadModel.state_dict()`` (torch tensors
    or numpy arrays; keys with or without the ``transformer.`` prefix) ->
    the state dict of the port's ``GPT2LMHeadModel(cfg)``, every tensor in
    ``cfg.param_dtype`` on the CPU (``model.load_state_dict`` takes it)."""
    sd = {k.removeprefix("transformer."): v for k, v in state_dict.items()}
    missing = [k for k in ("wte.weight", "wpe.weight") if k not in sd]
    if missing:
        raise ValueError(f"state dict missing {missing}; is this a GPT-2?")

    def t(x, transpose=False):
        x = torch.as_tensor(x).detach().to("cpu", torch.float32)
        return (x.T if transpose else x).contiguous().to(cfg.param_dtype)

    out = {"wte.weight": t(sd["wte.weight"][: cfg.vocab_size]),
           "wpe.weight": t(sd["wpe.weight"][: cfg.max_position_embeddings])}
    names = {"ln_1": "ln_1", "ln_2": "ln_2", "attn.c_attn": "attn.Wqkv",
             "attn.c_proj": "attn.out_proj", "mlp.c_fc": "mlp.c_fc",
             "mlp.c_proj": "mlp.c_proj"}
    for i in range(cfg.n_layer):
        if f"h.{i}.ln_1.weight" not in sd:
            raise ValueError(
                f"state dict has no layer {i}; cfg.n_layer={cfg.n_layer}")
        for hf, port in names.items():
            out[f"h.{i}.{port}.weight"] = t(sd[f"h.{i}.{hf}.weight"],
                                            transpose=not hf.startswith("ln"))
            out[f"h.{i}.{port}.bias"] = t(sd[f"h.{i}.{hf}.bias"])
    out["ln_f.weight"], out["ln_f.bias"] = (t(sd["ln_f.weight"]),
                                            t(sd["ln_f.bias"]))
    return out


def load_hf_gpt2(model_or_state_dict, cfg: GPT2Config | None = None,
                 device="cuda") -> tuple[GPT2Config, GPT2LMHeadModel]:
    """A ``transformers`` GPT-2 model (or its state dict with an explicit
    ``cfg``) -> ``(cfg, model)``: the port's ``GPT2LMHeadModel`` on
    ``device`` holding its weights."""
    if hasattr(model_or_state_dict, "state_dict"):
        hf = model_or_state_dict
        if cfg is None:
            cfg = gpt2_config_from_hf(hf.config)
        state_dict = hf.state_dict()
    elif cfg is None:
        raise ValueError("a raw state dict needs an explicit GPT2Config")
    else:
        state_dict = model_or_state_dict
    model = GPT2LMHeadModel(cfg, device=device,
                            generator=torch.Generator().manual_seed(0))
    model.load_state_dict(convert_hf_gpt2_state_dict(state_dict, cfg))
    return cfg, model


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
