"""Paged KV cache and the continuous-batching engine."""
