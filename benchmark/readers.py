"""What the metric readers of ``benchmark/metrics`` share.

Each reader is ``read(run) -> float | None`` over a
:class:`benchmark.harness.Run`; ``None`` means it found nothing to read, and
the metric is left out of the result.
"""

from __future__ import annotations

import statistics

import numpy as np

from . import roofline


def p95_ms(run) -> float | None:
    lat = [(i["end"] - i["start"]) * 1e3 for i in run.items]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=20, method="inclusive")[-1]


def ok_per_s(run) -> float | None:
    if not run.items or run.window_s <= 0:
        return None
    return sum(1 for i in run.items if i["ok"]) / run.window_s


def idle_pct(run) -> float | None:
    if run.trace is None or not run.trace.device:
        return None
    start, end = run.trace.window()
    return 100.0 * (1.0 - run.trace.busy(start, end) / (end - start))


def host_ms(run, span: str) -> float | None:
    """The mean of a span's length less the device's busy time inside it."""
    if run.trace is None or not run.trace.device:
        return None
    spans = run.trace.named(span)
    if not spans:
        return None
    return 1e3 * float(np.mean([(b - a) - run.trace.busy(a, b) for _, a, b in spans]))


def span_ms(run, span: str) -> float | None:
    if run.trace is None:
        return None
    spans = run.trace.named(span)
    return 1e3 * float(np.mean([b - a for _, a, b in spans])) if spans else None


def _locked_counts(run) -> tuple[int, int]:
    locked = run.map.obstacle.copy()
    locked[0, :] = locked[-1, :] = locked[:, 0] = locked[:, -1] = True
    return roofline.class_counts(locked)


def least_seconds(run, items: list) -> float:
    """The least time of the solves of ``items``: one lane each, its goal
    cell locked, its own sweep count."""
    even, odd = _locked_counts(run)
    h, w = run.map.shape
    n_updates = 0
    for i in items:
        gx, gy = i["goal"]
        counts = (even - 1, odd) if (gx + gy) % 2 == 0 else (even, odd - 1)
        n_updates += roofline.updates(counts, i["sweeps"])
    return roofline.least_seconds(n_updates, len(items) * h * w)


def roofline_pct(run, span: str, per_span: int) -> float | None:
    """The least time of the solves over the device time of every operation
    inside their spans, each span holding ``per_span`` items in order."""
    if run.trace is None or not run.trace.device:
        return None
    spans = run.trace.named(span)
    if not spans or len(spans) * per_span != len(run.items):
        return None
    taken = sum(run.trace.device_time(a, b) for _, a, b in spans)
    if taken <= 0:
        return None
    return 100.0 * least_seconds(run, run.items) / taken
