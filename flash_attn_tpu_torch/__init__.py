"""PyTorch + CUDA (Hopper) port of flash_attn_tpu.

Plain tensor code is PyTorch; every Pallas kernel of the JAX package on the
ported path is a CUDA kernel under ``csrc/``, built with ``nvcc`` at first
use. Tensors on the CPU take each kernel's plain-torch twin. Importing this
package imports no JAX.
"""

from flash_attn_tpu_torch.ops.attention import alibi_slopes, flash_attention
from flash_attn_tpu_torch.ops.blocksparse import (
    blocksparse_attention,
    flash_blocksparse_attn_func,
)
from flash_attn_tpu_torch.ops.interface import (
    flash_attn_func,
    flash_attn_unpadded_func,
    flash_attn_unpadded_kvpacked_func,
    flash_attn_unpadded_qkvpacked_func,
    flash_attn_varlen_func,
    flash_attn_varlen_kvpacked_func,
    flash_attn_varlen_qkvpacked_func,
)
from flash_attn_tpu_torch.ops.packing import pad_input, unpad_input

__version__ = "0.1.0"

__all__ = [
    "alibi_slopes",
    "blocksparse_attention",
    "flash_attention",
    "flash_attn_func",
    "flash_attn_unpadded_func",
    "flash_attn_unpadded_kvpacked_func",
    "flash_attn_unpadded_qkvpacked_func",
    "flash_attn_varlen_func",
    "flash_attn_varlen_kvpacked_func",
    "flash_attn_varlen_qkvpacked_func",
    "flash_blocksparse_attn_func",
    "pad_input",
    "unpad_input",
    "__version__",
]
