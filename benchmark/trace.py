"""The device trace of a ``--trace 1`` run, and what the metrics read from it.

``torch.profiler`` records the window with CPU and CUDA activities. Its
exported Chrome trace holds every operation that ran on the device (kernels,
copies, sets) and the benchmark's spans (``bench.*`` ranges), all on one
clock. Everything below works in seconds on that clock.
"""

from __future__ import annotations

import json
import pathlib

from .spans import PREFIX

DEVICE_CATEGORIES = {"kernel", "gpu_memcpy", "gpu_memset"}
NAME_CHARS = 160    # a kernel's name in the breakdown, cut to this length


class Trace:
    """Device operations and spans of a traced window, each a list of
    ``(name, start_s, end_s)``, ``device`` sorted by start."""

    def __init__(self, device: list, spans: list):
        self.device = sorted(device, key=lambda e: e[1])
        self.spans = sorted(spans, key=lambda s: s[1])

    def named(self, name: str) -> list[tuple[str, float, float]]:
        return [s for s in self.spans if s[0] == name]

    def window(self) -> tuple[float, float]:
        (_, start, end), = self.named("window")
        return start, end

    def busy(self, start: float, end: float) -> float:
        """Seconds of ``[start, end]`` in which some device operation ran."""
        total, reach = 0.0, start
        for _, a, b in self.device:
            if b <= reach or a >= end:
                if a >= end:
                    break
                continue
            lo, hi = max(a, reach), min(b, end)
            if hi > lo:
                total += hi - lo
                reach = hi
        return total

    def device_time(self, start: float, end: float) -> float:
        """Summed durations of the device operations whose middle lies in
        ``[start, end]``: the work of whatever kernels ran there."""
        return sum(b - a for _, a, b in self.device if start <= (a + b) / 2 <= end)

    def idle_gaps(self) -> list[tuple[float, float]]:
        """The stretches of the window in which no device operation ran."""
        start, end = self.window()
        gaps, reach = [], start
        for _, a, b in self.device:
            if b <= start or a >= end:
                continue
            if a > reach:
                gaps.append((reach, a))
            reach = max(reach, b)
        if end > reach:
            gaps.append((reach, end))
        return gaps

    def open_span(self, at: float) -> str:
        """The innermost span open at ``at``, or ``host`` for none but the
        window."""
        best = None
        for name, a, b in self.spans:
            if name != "window" and a <= at <= b and (best is None or b - a < best[2] - best[1]):
                best = (name, a, b)
        return best[0] if best else "host"


def start():
    import torch

    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                              torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def stop(prof, path: pathlib.Path) -> Trace:
    """End the profile, export it to ``path`` and read it back."""
    prof.__exit__(None, None, None)
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    return parse(json.loads(path.read_text()))


def parse(chrome: dict) -> Trace:
    device, spans = [], []
    for e in chrome.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        start = float(e["ts"]) * 1e-6
        end = start + float(e["dur"]) * 1e-6
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATEGORIES:
            device.append((name, start, end))
        elif cat == "user_annotation" and name.startswith(PREFIX):
            spans.append((name[len(PREFIX):], start, end))
    return Trace(device, spans)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time in the window, and the
    longest idle gaps named by the span that was open in each."""
    start, end = trace.window()
    by_name: dict[str, float] = {}
    for name, a, b in trace.device:
        if a >= start and b <= end:
            by_name[name] = by_name.get(name, 0.0) + (b - a)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace.idle_gaps(), key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops],
            "idle_gaps": [[trace.open_span((a + b) / 2), b - a] for a, b in gaps]}
