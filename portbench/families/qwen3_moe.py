"""The program under test for configurations of the Qwen3-MoE family: the
port's ``LlamaForCausalLM`` with an explicit ``head_dim``, per-head q/k
RMSNorm and routed experts in every layer, holding the benchmark's
weights, and its serving phases (``llama_decode``). Serving only.

A configuration file names this family by ``"family": "qwen3_moe"`` and
gives the model's sizes under the keys of its published ``config.json``.
"""

from __future__ import annotations

import torch

from flash_attn_tpu_torch.models import llama_decode
from flash_attn_tpu_torch.models.llama import LlamaConfig, LlamaForCausalLM

DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
          "float32": torch.float32}
model_fns = llama_decode


def port_config(c: dict, *, train: bool, **overrides) -> LlamaConfig:
    """The port's config of a configuration file: weights stored and
    computed in ``torch_dtype``. Every layer is sparse; the dense MLP
    width ``intermediate_size`` is not used."""
    if train:
        raise NotImplementedError("qwen3_moe: training is not supported")
    if c["decoder_sparse_step"] != 1 or c["mlp_only_layers"]:
        raise NotImplementedError("qwen3_moe: dense layers among sparse")
    dtype = DTYPES[c["torch_dtype"]]
    kw = dict(
        vocab_size=c["vocab_size"], n_layer=c["num_hidden_layers"],
        n_head=c["num_attention_heads"], n_kv_head=c["num_key_value_heads"],
        n_embd=c["hidden_size"], intermediate_size=c["intermediate_size"],
        head_dim=c["head_dim"], qk_norm=True,
        num_experts=c["num_experts"],
        num_experts_per_tok=c["num_experts_per_tok"],
        moe_intermediate_size=c["moe_intermediate_size"],
        norm_topk_prob=c["norm_topk_prob"],
        max_position_embeddings=c["max_position_embeddings"],
        rope_theta=float(c["rope_theta"]), rms_norm_eps=c["rms_norm_eps"],
        window=c.get("sliding_window"), dtype=dtype, param_dtype=dtype)
    kw.update(overrides)
    return LlamaConfig(**kw)


def param_spec(c: dict):
    """[(name, shape, kind)] of every weight, in a fixed order; names are
    the port's parameter names."""
    e, v, hd = c["hidden_size"], c["vocab_size"], c["head_dim"]
    E, I = c["num_experts"], c["moe_intermediate_size"]
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
            (p + "attn.q_norm.weight", (hd,), "norm"),
            (p + "attn.k_norm.weight", (hd,), "norm"),
            (p + "post_attention_layernorm.weight", (e,), "norm"),
            (p + "mlp.router.weight", (E, e), "normal"),
            (p + "mlp.gate_up_proj", (E, 2 * I, e), "normal"),
            (p + "mlp.down_proj", (E, e, I), "normal"),
        ]
    spec += [("norm.weight", (e,), "norm"), ("lm_head.weight", (v, e),
                                             "normal")]
    return spec


def build(cfg: LlamaConfig, weights: dict, device, *, train: bool):
    """The port's model holding ``weights`` (the tensors themselves, not
    copies) as its parameters: made on the meta device, so that no second
    copy of the weights is ever allocated."""
    model = LlamaForCausalLM(cfg, device="meta", generator=None)
    for name, t in weights.items():
        mod_name, leaf = name.rsplit(".", 1)
        model.get_submodule(mod_name)._parameters[leaf] = torch.nn.Parameter(
            t, requires_grad=train)
    left = [n for n, p in model.named_parameters() if p.is_meta]
    if left:
        raise ValueError(f"no weights for {left}")
    return model


def train_step(model, opt_kw: dict, lm_loss_chunk):
    raise NotImplementedError("qwen3_moe: training is not supported")
