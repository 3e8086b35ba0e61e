"""CUDA kernels (csrc/) with their Python wrappers and plain-torch twins."""
