"""Model families on ``FlashMHA`` (BERT, GPT-2, ViT, Llama), their weight
conversion from the JAX package and from ``transformers``, and the
drop-in attention modules."""

from flash_attn_tpu_torch.models.bert import (
    BertConfig,
    BertForMaskedLM,
    BertModel,
)
from flash_attn_tpu_torch.models.convert import (
    convert_hf_gpt2_state_dict,
    gpt2_config_from_hf,
    load_hf_gpt2,
)
from flash_attn_tpu_torch.models.gpt2 import GPT2Config, GPT2LMHeadModel
from flash_attn_tpu_torch.models.llama import (
    LlamaConfig,
    LlamaForCausalLM,
    convert_hf_llama_state_dict,
    convert_hf_qwen3_moe_state_dict,
    llama_config_from_hf,
    load_hf_llama,
    load_hf_qwen3_moe,
    qwen3_moe_config_from_hf,
)
from flash_attn_tpu_torch.models.modules import FlashAttention, FlashMHA
from flash_attn_tpu_torch.models.vit import ViTClassifier, ViTConfig

__all__ = [
    "BertConfig",
    "BertForMaskedLM",
    "BertModel",
    "FlashAttention",
    "FlashMHA",
    "GPT2Config",
    "GPT2LMHeadModel",
    "LlamaConfig",
    "LlamaForCausalLM",
    "ViTClassifier",
    "ViTConfig",
    "convert_hf_gpt2_state_dict",
    "convert_hf_llama_state_dict",
    "convert_hf_qwen3_moe_state_dict",
    "gpt2_config_from_hf",
    "llama_config_from_hf",
    "load_hf_gpt2",
    "load_hf_llama",
    "load_hf_qwen3_moe",
    "qwen3_moe_config_from_hf",
]
