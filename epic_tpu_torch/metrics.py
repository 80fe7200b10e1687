"""Lightweight runtime metrics: named counters and latency statistics.

The reference's observability is stderr prints plus commented-out
per-100-iteration delta printfs (harmonic_cpu.cpp:175-180,
harmonic_gpu.cu:284-289) and the `(wall, cpu)` pairs returned by
Harmonic.solve (libepic/python/epic/harmonic.py:80-98). This module is the
framework-grade replacement: a process-local registry the service plane
(services/server.py) feeds per-verb, exposed over the wire via the
``metrics`` verb and programmatically via :meth:`MetricsRegistry.snapshot`.

Deliberately dependency-free and cheap: a counter bump is a dict add; a
latency sample is five scalar updates and a bucket count. Not thread-safe by
design — the server's event loop is single-threaded, and solver-side use is
per-process.
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field

# The latency histogram's fixed buckets: BUCKETS_PER_DECADE log-spaced
# buckets a decade from LOWEST_S to LOWEST_S * 10**DECADES, and one each
# below and above. A bucket is 10**(1 / BUCKETS_PER_DECADE) - 1 = 5.9% wide.
LOWEST_S = 1e-6
BUCKETS_PER_DECADE = 40
DECADES = 10
N_BUCKETS = BUCKETS_PER_DECADE * DECADES + 2


def bucket(seconds: float) -> int:
    """The histogram bucket of a latency: 0 below ``LOWEST_S``, ``k`` for
    ``[LOWEST_S * 10**((k-1)/40), LOWEST_S * 10**(k/40))``, the last above
    the range."""
    if seconds < LOWEST_S:
        return 0
    k = int(math.log10(seconds / LOWEST_S) * BUCKETS_PER_DECADE) + 1
    return min(k, N_BUCKETS - 1)


@dataclass
class LatencyStat:
    """Streaming latency summary (count / total / min / max / last, seconds)
    and percentiles from a histogram of fixed log-spaced buckets
    (:func:`bucket`), so its memory is set by the buckets alone.

    Mean comes out of count+total. A percentile is the geometric middle of
    the bucket that holds it, clamped to [min, max]: within 2.9% of a value
    of that bucket.
    """

    count: int = 0
    total_s: float = 0.0
    min_s: float = math.inf
    max_s: float = 0.0
    last_s: float = 0.0
    buckets: list[int] = field(default_factory=lambda: [0] * N_BUCKETS)

    def observe(self, seconds: float) -> None:
        self.count += 1
        self.total_s += seconds
        self.min_s = min(self.min_s, seconds)
        self.max_s = max(self.max_s, seconds)
        self.last_s = seconds
        self.buckets[bucket(seconds)] += 1

    def quantile(self, q: float) -> float:
        """The ``q``-quantile (0 < q <= 1) of the observed latencies: the
        ``ceil(q * count)``-th smallest, to its bucket; 0.0 before any."""
        if not self.count:
            return 0.0
        rank = max(1, math.ceil(q * self.count))
        seen = 0
        for k, n in enumerate(self.buckets):
            seen += n
            if seen >= rank:
                break
        if k == 0:
            return self.min_s
        if k == N_BUCKETS - 1:
            return self.max_s
        middle = LOWEST_S * 10 ** ((k - 0.5) / BUCKETS_PER_DECADE)
        return min(max(middle, self.min_s), self.max_s)

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "total_s": self.total_s,
            "mean_s": (self.total_s / self.count) if self.count else 0.0,
            "min_s": self.min_s if self.count else 0.0,
            "max_s": self.max_s,
            "last_s": self.last_s,
            "p50_s": self.quantile(0.50),
            "p95_s": self.quantile(0.95),
            "p99_s": self.quantile(0.99),
        }


@dataclass
class MetricsRegistry:
    """Named counters + latency stats with a JSON-friendly snapshot."""

    counters: dict[str, int] = field(default_factory=dict)
    latencies: dict[str, LatencyStat] = field(default_factory=dict)
    started_at: float = field(default_factory=time.time)

    def inc(self, name: str, by: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + by

    def observe(self, name: str, seconds: float) -> None:
        stat = self.latencies.get(name)
        if stat is None:
            stat = self.latencies[name] = LatencyStat()
        stat.observe(seconds)

    def timed(self, name: str):
        """Context manager: observe the block's wall time under ``name``."""
        return _Timer(self, name)

    def snapshot(self) -> dict:
        return {
            "uptime_s": time.time() - self.started_at,
            "counters": dict(sorted(self.counters.items())),
            "latencies": {
                k: v.as_dict() for k, v in sorted(self.latencies.items())
            },
        }


class _Timer:
    def __init__(self, registry: MetricsRegistry, name: str):
        self._r = registry
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb):
        self._r.observe(self._name, time.perf_counter() - self._t0)
        return False


class JsonLogFormatter:
    """logging.Formatter emitting one JSON object per record — structured
    logging for the service plane (``epic_tpu_torch.services.server``).
    Dependency-free stand-in for the reference's fprintf/ROS_INFO convention."""

    def format(self, record) -> str:  # logging.Formatter protocol
        import json as _json
        import logging as _logging

        out = {
            "ts": record.created,
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = _logging.Formatter().formatException(record.exc_info)
        return _json.dumps(out)


def configure_logging(json_lines: bool = False, level: int | None = None) -> None:
    """Install a handler on the ``epic_tpu_torch`` logger tree (idempotent)."""
    import logging as _logging

    root = _logging.getLogger("epic_tpu_torch")
    if level is not None:
        root.setLevel(level)
    elif root.level == _logging.NOTSET:
        root.setLevel(_logging.INFO)
    for h in root.handlers:
        if getattr(h, "_epic_tpu_torch_installed", False):
            root.removeHandler(h)
    handler = _logging.StreamHandler()
    handler._epic_tpu_torch_installed = True
    if json_lines:
        handler.setFormatter(JsonLogFormatter())
    else:
        handler.setFormatter(_logging.Formatter(
            "%(asctime)s %(levelname)s %(name)s: %(message)s"))
    root.addHandler(handler)
