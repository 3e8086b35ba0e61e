"""Public ops over the kernels."""
