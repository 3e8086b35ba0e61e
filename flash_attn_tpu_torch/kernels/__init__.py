"""CUDA kernels (csrc/) with their Python wrappers and plain-torch twins."""

from flash_attn_tpu_torch.kernels.chunk import paged_chunk_attention
from flash_attn_tpu_torch.kernels.decode import paged_decode_attention
from flash_attn_tpu_torch.kernels.flash_bwd import flash_attention_bwd
from flash_attn_tpu_torch.kernels.flash_fwd import flash_attention_fwd

__all__ = [
    "flash_attention_bwd",
    "flash_attention_fwd",
    "paged_chunk_attention",
    "paged_decode_attention",
]
