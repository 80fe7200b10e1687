"""Timers and throughput counters (SURVEY §5 "tracing/profiling").

The counterpart of ``epic_tpu.profiling``. The reference returns (wall, cpu)
timing pairs from ``Harmonic.solve`` (harmonic.py:80-98) and derives
per-update time as total/iterations (batch.py:142,154). ``SolveStats`` wraps
a solve with wall/CPU timers and derives sweeps/s and cell-updates/s;
``trace`` records a ``torch.profiler`` trace for deep dives.

On a CUDA tensor ``timed_solve`` waits for the card before it stops the
clock (``torch.cuda.synchronize`` on the state's device) and also records
the solve's CUDA-event time (``device_ms``).

``span`` marks where the program's work happens: while a ``torch.profiler``
records, a ``record_function`` range named ``epic.<name>``, on the clock of
the device's operations in the same trace; otherwise one read of the
profiler's flag and a shared context that does nothing. The first span
opened while a profiler records also hooks Python's collector, so that each
collection is a span of its own, ``epic.gc.gen<N>``, inside whatever span was
open on its thread.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import os
import pathlib
import time

import torch
import torch.autograd.profiler as _autograd_profiler

DEFAULT_TRACE_DIR = pathlib.Path(__file__).resolve().parent.parent / "build" / "epic_tpu_torch" / "trace"


@dataclasses.dataclass
class SolveStats:
    wall_s: float
    cpu_s: float
    iterations: int
    cells: int
    device_ms: float | None = None   # CUDA-event time of the solve, on a card

    @property
    def time_per_update(self) -> float:
        """Seconds per sweep — the reference's 'Time per Update' column."""
        return self.wall_s / max(self.iterations, 1)

    @property
    def sweeps_per_s(self) -> float:
        return self.iterations / self.wall_s if self.wall_s > 0 else float("inf")

    @property
    def cell_updates_per_s(self) -> float:
        """One update = one parity cell per sweep = half the cells."""
        return self.cells / 2 * self.sweeps_per_s


@contextlib.contextmanager
def timed(result: dict):
    """Context manager filling ``result`` with wall/cpu seconds."""
    t0, c0 = time.perf_counter(), time.process_time()
    try:
        yield
    finally:
        result["wall_s"] = time.perf_counter() - t0
        result["cpu_s"] = time.process_time() - c0


def timed_solve(solve_fn, state, **kwargs) -> tuple[object, SolveStats]:
    """Run ``solve_fn(state, **kwargs)``, waiting for the result (on a card,
    for the device), and return (out_state, SolveStats)."""
    cells = 1
    for d in state.u.shape:
        cells *= d
    dev = state.u.device
    cuda = dev.type == "cuda"
    res: dict = {}
    if cuda:
        torch.cuda.synchronize(dev)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
    with timed(res):
        if cuda:
            start.record()
        out = solve_fn(state, **kwargs)
        if cuda:
            end.record()
            torch.cuda.synchronize(dev)
    return out, SolveStats(
        wall_s=res["wall_s"],
        cpu_s=res["cpu_s"],
        iterations=int(out.iteration),
        cells=cells,
        device_ms=start.elapsed_time(end) if cuda else None,
    )


@contextlib.contextmanager
def trace(log_dir: str | pathlib.Path | None = None):
    """A ``torch.profiler`` trace (CPU and, where there is one, CUDA
    activity) around a block, written as a Chrome trace under ``log_dir``
    (by default ``build/epic_tpu_torch/trace`` beside the package). Yields
    the profiler, whose ``key_averages()`` summarise the block."""
    from torch.profiler import ProfilerActivity, profile

    out = pathlib.Path(log_dir) if log_dir is not None else DEFAULT_TRACE_DIR
    out.mkdir(parents=True, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / f"trace-{os.getpid()}-{time.time_ns()}.json"))


def recording() -> bool:
    """Whether a ``torch.profiler`` records on this process: the Python-side
    flag that torch sets when a profiler starts and clears when it stops. A
    test pins it, so a torch that moves the flag fails there, not in a
    trace with no spans."""
    return _autograd_profiler._is_profiler_enabled


class _Off:
    """The shared context of a span while nothing records. Both ends are one
    C call that returns the empty string (``"".format`` ignores the
    arguments it is given), so entering and leaving run no Python frame, and
    an exception raised inside passes through."""

    __slots__ = ()
    __enter__ = __exit__ = "".format


_OFF = _Off()
_GC_NAMES = tuple(f"epic.gc.gen{g}" for g in range(3))
_gc_open: list = []   # the range of the collection in progress, if it is recorded


def span(name: str):
    """A context manager around the work called ``name``: while a profiler
    records, the range ``epic.<name>`` in its trace; otherwise the shared
    context that does nothing (one flag read, nothing allocated). Ranges
    nest on their thread."""
    if not recording():
        return _OFF
    if _gc_span not in gc.callbacks:
        gc.callbacks.append(_gc_span)
    return torch.profiler.record_function("epic." + name)


def _gc_span(phase: str, info: dict) -> None:
    """``gc.callbacks`` hook: a collection's range, opened at its ``start``
    and closed at its ``stop``, while a profiler records."""
    if phase == "start":
        if recording():
            rf = torch.profiler.record_function(_GC_NAMES[info["generation"]])
            rf.__enter__()
            _gc_open.append(rf)
    elif _gc_open:
        _gc_open.pop().__exit__(None, None, None)


def remove_gc_spans() -> None:
    """Take the collector's hook out again (the first span opened while a
    profiler records puts it in, and it stays for the process)."""
    while _gc_span in gc.callbacks:
        gc.callbacks.remove(_gc_span)
