"""Host spans at the port's layer boundaries: the serving engine's step,
chunk, copies and read-backs, and the Llama serving calls.

``span(name)`` is a context manager around one phase. While a
``torch.profiler`` runs it is a ``record_function`` range of that name, so
the profiler's trace names the program's phase around each gap in the
device's work. Otherwise it is one shared no-op object: it allocates
nothing, reads no clock and records nothing.
"""

from __future__ import annotations

import torch

_profiling = torch._C._autograd._profiler_enabled


class _Off:
    """The span when no profiler runs."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str):
    """A span named ``name`` (``serve.*``, ``llama.*``)."""
    if not _profiling():
        return _OFF
    return torch.profiler.record_function(name)
