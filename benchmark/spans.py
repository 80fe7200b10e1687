"""Spans around the calls into each layer of the program.

With tracing on, a span is a ``torch.profiler.record_function`` range named
``bench.<name>``, so the profiler's trace holds it on the clock of the
device's operations (:mod:`benchmark.trace` reads it back from there); with
tracing off it costs nothing.
"""

from __future__ import annotations

import contextlib

PREFIX = "bench."


def span(name: str, traced: bool):
    """A context manager: the span ``name`` when ``traced``, else nothing."""
    if not traced:
        return contextlib.nullcontext()
    import torch

    return torch.profiler.record_function(PREFIX + name)
