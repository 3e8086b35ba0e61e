"""Public ops over the kernels."""

from flash_attn_tpu_torch.ops.attention import alibi_slopes, flash_attention

__all__ = ["alibi_slopes", "flash_attention"]
