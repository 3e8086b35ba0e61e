"""Paged KV cache, ``flash_attn_with_kvcache`` and the continuous-batching
engine."""

import importlib

from flash_attn_tpu_torch.serving.cache import (
    PageAllocator,
    PagedKVCache,
    append_span,
    append_token,
    init_cache,
    write_prompt,
)

__all__ = [
    "PageAllocator",
    "PagedKVCache",
    "ServingEngine",
    "append_chunk",
    "append_span",
    "append_token",
    "flash_attn_with_kvcache",
    "init_cache",
    "write_prompt",
]

# Lazy: the paged kernels (kernels/chunk.py, kernels/decode.py) import
# serving.cache, and kvcache and the engine import those kernels, so an
# eager import here would be circular (JAX keeps the engine lazy too).
_LAZY = {"append_chunk": "kvcache", "flash_attn_with_kvcache": "kvcache",
         "ServingEngine": "engine"}


def __getattr__(name):
    if name in _LAZY:
        module = importlib.import_module(f"{__name__}.{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(name)
