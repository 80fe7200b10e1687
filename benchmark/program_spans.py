"""The program's own spans in a traced run's exported trace.

The program marks its work with ``torch.profiler.record_function`` ranges
named ``epic.<name>`` (``epic_tpu_torch.profiling.span``), and each of
Python's collections with ``epic.gc.gen<N>``. They sit in the same exported
trace as the benchmark's ``bench.*`` spans and the device's operations, on
one clock. :mod:`benchmark.trace` keeps only the ``bench.*`` spans; this
module reads the ``epic.*`` ones from the file a reader names, after
checking that the file is the run's own (its ``bench.window`` is the
window of ``run.trace``). Everything is in seconds on that clock, within
the window.

A span's self time is its length less the part of it that its child spans
(those nested in it on its thread, the collections among them) cover.
"""

from __future__ import annotations

import json
import pathlib

PREFIX = "epic."
WINDOW = "bench.window"
SAME_S = 1e-6   # two readings of one timestamp agree to within this

_cache: dict = {}


class Spans:
    """The program's spans in a window: each ``(name, start_s, end_s,
    self_s)``, and the device's operations as ``(start_s, end_s)``."""

    def __init__(self, window: tuple[float, float], spans: list, device: list):
        self.window = window
        self.spans = spans
        self.device = device

    def self_s(self, name: str) -> list[float]:
        """The self times of the spans called ``name``."""
        return [s for n, _, _, s in self.spans if n == name]

    def collections_s(self) -> float:
        """The collector's seconds in the window: every ``gc.*`` span."""
        return sum(b - a for n, a, b, _ in self.spans if n.startswith("gc."))

    def idle_unspanned_s(self) -> float:
        """Seconds of the window in which no device operation ran and no
        span of the program was open."""
        start, end = self.window
        covered = sorted([(a, b) for _, a, b, _ in self.spans] + self.device)
        total, reach = 0.0, start
        for a, b in covered:
            if b > reach:
                total += b - max(a, reach)
                reach = b
        return (end - start) - total


def self_times(spans: list[tuple[str, float, float]]) -> list[float]:
    """The self time of each of one thread's spans ``(name, start, end)``,
    in their order: the parent of a span is the innermost span open at its
    start that has not ended by then."""
    order = sorted(range(len(spans)), key=lambda i: (spans[i][1], -spans[i][2]))
    covered = [0.0] * len(spans)
    stack: list[int] = []
    for i in order:
        _, a, b = spans[i]
        while stack and spans[stack[-1]][2] <= a:
            stack.pop()
        if stack:
            p = stack[-1]
            covered[p] += max(0.0, min(b, spans[p][2]) - a)
        stack.append(i)
    return [(b - a) - c for (_, a, b), c in zip(spans, covered)]


def parse(chrome: dict) -> Spans | None:
    """The window's program spans and device operations from an exported
    trace; None without a window or without a single program span."""
    window, by_thread, device = None, {}, []
    for e in chrome.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"]) * 1e-6
        b = a + float(e["dur"]) * 1e-6
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            device.append((a, b))
        elif cat == "user_annotation" and name == WINDOW:
            window = (a, b)
        elif cat == "user_annotation" and name.startswith(PREFIX):
            by_thread.setdefault((e.get("pid"), e.get("tid")), []).append(
                (name[len(PREFIX):], a, b))
    if window is None or not by_thread:
        return None
    start, end = window
    spans = []
    for thread in by_thread.values():
        for (name, a, b), own in zip(thread, self_times(thread)):
            if a < end and b > start:
                spans.append((name, max(a, start), min(b, end), own))
    device = [(max(a, start), min(b, end)) for a, b in device if a < end and b > start]
    return Spans(window, spans, device)


def load(path: pathlib.Path) -> Spans | None:
    """:func:`parse` of the trace file at ``path`` (read once a file)."""
    stat = path.stat()
    key = (str(path), stat.st_mtime_ns, stat.st_size)
    if key not in _cache:
        _cache.clear()
        _cache[key] = parse(json.loads(path.read_text()))
    return _cache[key]


def read(run, path: pathlib.Path) -> Spans | None:
    """The program's spans of ``run``'s traced window, from its exported
    trace at ``path``; None for an untraced run, a missing or stale file,
    or a program that records no span."""
    if run.trace is None or not path.is_file():
        return None
    spans = load(path)
    if spans is None:
        return None
    start, end = run.trace.window()
    if abs(spans.window[0] - start) > SAME_S or abs(spans.window[1] - end) > SAME_S:
        return None
    return spans


def per_item_ms(total_s: float, n: int) -> float | None:
    return 1e3 * total_s / n if n else None


def mean_ms(values: list[float]) -> float | None:
    return 1e3 * sum(values) / len(values) if values else None


def idle_unspanned_pct(spans: Spans | None) -> float | None:
    """The share of the window in which the device was idle and the
    program had no span open; None where the trace holds no device
    operation."""
    if spans is None or not spans.device:
        return None
    start, end = spans.window
    return 100.0 * spans.idle_unspanned_s() / (end - start)
