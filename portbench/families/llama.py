"""The program under test for configurations of the Llama family (Llama,
Mistral): the port's ``LlamaForCausalLM`` with the benchmark's weights,
its serving phases (``llama_decode``) and its training step.

A configuration file names this family by ``"family": "llama"`` and gives
the model's sizes under the keys of its published ``config.json``.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.models import llama_decode
from flash_attn_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    make_train_step,
)

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
model_fns = llama_decode


def port_config(c: dict, *, train: bool, **overrides) -> LlamaConfig:
    """The port's config of a configuration file: compute in
    ``torch_dtype``; weights stored in it for serving and in
    ``param_dtype`` (default fp32) for training."""
    dtype = DTYPES[c["torch_dtype"]]
    kw = dict(
        vocab_size=c["vocab_size"], n_layer=c["num_hidden_layers"],
        n_head=c["num_attention_heads"], n_kv_head=c["num_key_value_heads"],
        n_embd=c["hidden_size"], intermediate_size=c["intermediate_size"],
        max_position_embeddings=c["max_position_embeddings"],
        rope_theta=float(c["rope_theta"]), rms_norm_eps=c["rms_norm_eps"],
        window=c.get("sliding_window"), dtype=dtype,
        param_dtype=DTYPES[c.get("param_dtype", "float32")] if train
        else dtype)
    kw.update(overrides)
    return LlamaConfig(**kw)


def param_spec(c: dict):
    """[(name, shape, kind)] of every weight, in a fixed order; names are
    the port's parameter names."""
    e, i, v = c["hidden_size"], c["intermediate_size"], c["vocab_size"]
    hd = e // c["num_attention_heads"]
    hq, hkv = c["num_attention_heads"] * hd, c["num_key_value_heads"] * hd
    spec = [("wte.weight", (v, e), "normal")]
    for n in range(c["num_hidden_layers"]):
        p = f"layers.{n}."
        spec += [
            (p + "input_layernorm.weight", (e,), "norm"),
            (p + "attn.q_proj.weight", (hq, e), "normal"),
            (p + "attn.k_proj.weight", (hkv, e), "normal"),
            (p + "attn.v_proj.weight", (hkv, e), "normal"),
            (p + "attn.o_proj.weight", (e, hq), "normal"),
            (p + "post_attention_layernorm.weight", (e,), "norm"),
            (p + "mlp.gate_proj.weight", (i, e), "normal"),
            (p + "mlp.up_proj.weight", (i, e), "normal"),
            (p + "mlp.down_proj.weight", (e, i), "normal"),
        ]
    spec += [("norm.weight", (e,), "norm"), ("lm_head.weight", (v, e),
                                             "normal")]
    return spec


def build(cfg: LlamaConfig, weights: dict, device, *, train: bool):
    """The port's model holding ``weights`` (the tensors themselves, not
    copies) as its parameters."""
    model = LlamaForCausalLM(
        cfg, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    for name, t in weights.items():
        mod_name, leaf = name.rsplit(".", 1)
        model.get_submodule(mod_name)._parameters[leaf] = torch.nn.Parameter(
            t, requires_grad=train)
    return model


def train_step(model, opt_kw: dict, lm_loss_chunk):
    """(step(batch) -> loss, optimizer): the port's training step with
    torch's AdamW."""
    opt = torch.optim.AdamW(model.parameters(), **opt_kw)
    return make_train_step(model, opt, lm_loss_chunk=lm_loss_chunk), opt
