"""One run of one cell: set-up, the measured window, the check, the result.

Everything is found by name. ``BENCHMARK.json`` names the cell's
configuration and traffic mix; the configuration's file and map lie where
its ``file`` says; the mix is ``benchmark/traffic/<mix>.json``, whose
``driver`` names a module of ``benchmark/drivers`` and whose optional
``check`` names a module of ``benchmark/checks`` (without it the comparison
is ``benchmark/check.py``); each metric is read by
``benchmark/metrics/<metric>.py``. A new configuration, mix, comparison or
metric is a new file, and no file here changes for it.

A comparison module exposes ``LIMITS`` (each compared number's limit),
``compare(answers, obstacle, config, traffic, device)`` (the numbers over
the answers the driver kept) and ``verdict(numbers)``.
"""

from __future__ import annotations

import dataclasses
import functools
import gc
import importlib
import importlib.util
import json
import pathlib
import time
from typing import Callable

import numpy as np

from . import check, inputs, spans as spans_mod, trace as trace_mod


@dataclasses.dataclass
class Catalog:
    """Where a checkout keeps the benchmark's files."""

    root: pathlib.Path

    @property
    def bench(self) -> dict:
        return json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, name: str) -> dict:
        cells = {c["name"]: c for c in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        return cells[name]

    def config(self, name: str) -> dict:
        entry, = [c for c in self.bench["configs"] if c["name"] == name]
        return json.loads((self.root / entry["file"]).read_text())

    def traffic(self, name: str) -> dict:
        return json.loads((self.root / "benchmark" / "traffic" / f"{name}.json").read_text())

    def metrics(self, cell: str, traced: bool) -> list[dict]:
        """The cell's end-to-end metrics, or with ``traced`` its per-layer
        ones: each metric that lists the cell, or lists no cells."""
        group = self.bench["per_layer" if traced else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str) -> Callable:
        path = self.root / "benchmark" / "metrics" / f"{metric}.py"
        spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module.read


def driver(name: str):
    return importlib.import_module(f"benchmark.drivers.{name}")


def comparison(traffic: dict):
    """The module that decides ``correct`` for a mix: ``benchmark/checks/
    <name>.py`` where the mix names a ``check``, else ``benchmark/check.py``.
    Raises ``KeyError`` for a name with no such module."""
    name = traffic.get("check")
    if name is None:
        return check
    if not (pathlib.Path(__file__).parent / "checks" / f"{name}.py").is_file():
        raise KeyError(f"no comparison {name!r} in benchmark/checks")
    return importlib.import_module(f"benchmark.checks.{name}")


@dataclasses.dataclass
class Run:
    """What a run recorded, as the metric readers see it."""

    cell: str
    config: dict
    traffic: dict
    map: inputs.Map | None
    setup_s: float = 0.0
    window_start: float = 0.0
    window_end: float = 0.0
    items: list = dataclasses.field(default_factory=list)
    groups: list = dataclasses.field(default_factory=list)
    trace: trace_mod.Trace | None = None
    marks: list = dataclasses.field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window_end - self.window_start


class Context:
    """What a driver is handed: the inputs, the device, the spans, and the
    calls that record items, keep answers and run the window."""

    def __init__(self, run: Run, seed: int, seconds: float, device, traced: bool,
                 started: float, trace_path: pathlib.Path):
        self.run = run
        self.config, self.traffic, self.map = run.config, run.traffic, run.map
        self.seed, self.seconds, self.device, self.traced = seed, seconds, device, traced
        self.spans = functools.partial(spans_mod.span, traced=traced)
        self.started = started
        self.trace_path = trace_path
        self.answers: dict = {}
        self.longest: tuple[int, object] | None = None
        self.kept: list = []
        self._reservoir = inputs.Reservoir(run.traffic["check_sample"], seed)

    def stream(self, warmup: bool = False) -> inputs.Stream:
        """The run's requests, drawn from its seed; with ``warmup`` the
        set-up's, drawn from the mix's fixed ``warmup_seed``."""
        return inputs.Stream(self.map, self.traffic["warmup_seed"] if warmup else self.seed)

    def mark(self, name: str) -> None:
        """End the set-up's phase ``name`` (each phase runs from the mark
        before it, the first from the process's start)."""
        self.run.marks.append((name, time.perf_counter()))

    def record(self, **item) -> None:
        self.run.items.append(item)

    def group(self, **group) -> None:
        self.run.groups.append(group)

    def answer(self, length: int, make: Callable[[], check.Answer]) -> None:
        """Offer a completed request's answer (``make`` builds it) to the
        compared sample, and keep it too if its path is the longest so far."""
        slot = self._reservoir.offer()
        longest = self.longest is None or length > self.longest[0]
        if slot is None and not longest:
            return
        a = make()
        if slot is not None:
            self.answers[slot] = a
        if longest:
            self.longest = (length, a)

    def keep(self, answer) -> None:
        """Compare ``answer`` whatever the sample draws, as the longest
        path's is."""
        self.kept.append(answer)

    def clear(self) -> None:
        self.run.items.clear()
        self.run.groups.clear()
        self.answers.clear()
        self.longest = None
        self.kept.clear()
        self._reservoir = inputs.Reservoir(self.traffic["check_sample"], self.seed)

    def window(self, step: Callable[[int], None]) -> None:
        """Set-up ends; run ``step`` on requests 0, 1, 2, ... until
        ``seconds`` have passed; the step in flight at the close is finished
        and counted."""
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        # The set-up's garbage is collected before the window, so every run
        # starts it with the collector's young generations empty; the
        # collector's settings are the program's and are left alone.
        gc.collect()
        self.mark("collect")
        prof = trace_mod.start() if self.traced else None
        self.run.window_start = time.perf_counter()
        self.run.setup_s = self.run.window_start - self.started
        with self.spans("window"):
            deadline = self.run.window_start + self.seconds
            k = 0
            while time.perf_counter() < deadline:
                step(k)
                k += 1
        self.run.window_end = time.perf_counter()
        if prof is not None:
            self.run.trace = trace_mod.stop(prof, self.trace_path)


def kept_answers(ctx: Context) -> list:
    """The sample's answers, then the longest path's and those the driver
    kept, each once."""
    out = [ctx.answers[k] for k in sorted(ctx.answers)]
    extra = ([ctx.longest[1]] if ctx.longest is not None else []) + ctx.kept
    for a in extra:
        if not any(a is b for b in out):
            out.append(a)
    return out


def setup_parts(marks: list, started: float) -> dict[str, float]:
    """Each set-up phase's seconds, from the marks."""
    out, last = {}, started
    for name, t in marks:
        out[name] = t - last
        last = t
    return out


def _finite(x: float) -> float:
    return float(x) if np.isfinite(x) else 1e30


def drive(cell: str, seed: int, seconds: float, traced: bool, *, catalog: Catalog,
          device, started: float) -> tuple[Run, list, int]:
    """Set up one cell on ``device`` and run its window: returns the run's
    record, the answers kept for the comparison (their fields on the host)
    and the device's memory peak. The program's state is freed."""
    import torch

    entry = catalog.cell(cell)
    config = catalog.config(entry["config"])
    traffic = catalog.traffic(entry["traffic"])
    record = Run(cell=cell, config=config, traffic=traffic,
                 map=None)
    ctx = Context(record, seed, seconds, device, traced, started,
                  catalog.root / "build" / "benchmark" / "trace.json")
    ctx.mark("imports")
    record.map = ctx.map = inputs.load_map(config, catalog.root)
    ctx.mark("map")
    driver(traffic["driver"]).run(ctx)
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    answers = kept_answers(ctx)
    for a in answers:
        if isinstance(a.field, torch.Tensor):
            a.field = a.field.cpu().numpy()
    ctx.answers.clear()
    ctx.longest = None
    ctx.kept.clear()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return record, answers, memory_peak


def run(cell: str, seed: int, seconds: float, traced: bool, *, catalog: Catalog,
        device, started: float) -> dict:
    """Run one cell on ``device`` and return the result line's object (the
    caller adds ``device``). The program's state is freed before the check."""
    entry = catalog.cell(cell)
    config, traffic = catalog.config(entry["config"]), catalog.traffic(entry["traffic"])
    judge = comparison(traffic)     # an unknown name fails here, before set-up
    record, answers, memory_peak = drive(cell, seed, seconds, traced, catalog=catalog,
                                         device=device, started=started)
    metrics = {}
    for m in catalog.metrics(cell, traced):
        value = catalog.reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    numbers = judge.compare(answers, record.map.obstacle, config, traffic, device)
    failed = sum(1 for i in record.items if not i["ok"])
    out = {
        # Every request of the window has to succeed, and every compared
        # answer has to agree with the reference.
        "correct": judge.verdict(numbers) and len(answers) > 0 and failed == 0,
        "attempted": len(record.items),
        "failed": failed,
        "metrics": metrics,
        "memory_peak_bytes": memory_peak,
        "checked": len(answers),
        "setup_parts": setup_parts(record.marks, started),
    }
    if traced and record.trace is not None:
        start, end = record.trace.window()
        out["busy_s"] = record.trace.busy(start, end)
        out["window_s"] = end - start
        out["breakdown"] = trace_mod.breakdown(record.trace)
    out["compared"] = {k: {"value": _finite(numbers[k]), "limit": judge.LIMITS[k]}
                       for k in judge.LIMITS}
    return out
