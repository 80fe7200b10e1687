"""The ticks' least time on the chip over the device time of their work.

The least time (``benchmark.roofline``) is summed over the window's ticks:
each tick's sweeps from its start iteration, over the cells unlocked on that
cycle's map (the map, its edge, the goal and the live patches, rebuilt from
the cycle's recorded inputs), the larger of the operations and the bytes
bound. The device time is that of every operation launched inside the
program's tick spans (``tick.sweep2d``), whatever its name, matched to its
launch by the profiler's correlation id: a tick's launch returns before its
kernel runs, so the kernel itself lies outside the span.
"""

import bisect
import json
import pathlib

from benchmark import program_spans, reference_anytime, roofline

TRACE = pathlib.Path(__file__).parents[2] / "build/benchmark/trace.json"
SPAN = "epic.tick.sweep2d"
DEVICE = {"kernel", "gpu_memcpy", "gpu_memset"}


def tick_device_s(chrome: dict, window: tuple[float, float]) -> tuple[int, float]:
    """The tick spans that start in ``window`` (seconds on the trace's
    clock), and the device seconds of the operations launched in them."""
    events = [e for e in chrome.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]
    start, end = window
    ticks = sorted((e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6) for e in events
                   if e.get("cat") == "user_annotation" and e.get("name") == SPAN
                   and start <= e["ts"] * 1e-6 < end)
    starts = [a for a, _ in ticks]

    def in_tick(t: float) -> bool:
        i = bisect.bisect_right(starts, t) - 1
        return i >= 0 and t <= ticks[i][1]

    launched = {e["args"]["correlation"] for e in events if e.get("cat") == "cuda_runtime"
                and "correlation" in e.get("args", {}) and in_tick(e["ts"] * 1e-6)}
    busy = sum(e["dur"] * 1e-6 for e in events if e.get("cat") in DEVICE
               and e.get("args", {}).get("correlation") in launched)
    return len(ticks), busy


def least_s(run) -> float:
    m = run.map
    h, w = m.shape
    state = reference_anytime.Replay(m.obstacle, m.resolution, m.origin, "cpu")
    total = 0.0
    for item in run.items:
        c = item["inputs"]
        state.edit(c)
        counts = roofline.class_counts(state.locked.numpy())
        total += roofline.least_seconds(roofline.updates(counts, c.sweeps, state.iteration),
                                        h * w)
        state.iteration += c.sweeps
    return total


def read(run):
    spans = program_spans.read(run, TRACE)
    if spans is None or not run.items:
        return None
    n, busy = tick_device_s(json.loads(TRACE.read_text()), spans.window)
    if n != len(run.items) or busy <= 0:
        return None
    return 100.0 * least_s(run) / busy
