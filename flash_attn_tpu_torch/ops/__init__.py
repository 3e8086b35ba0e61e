"""Public ops over the kernels."""

from flash_attn_tpu_torch.ops.attention import flash_attention

__all__ = ["flash_attention"]
