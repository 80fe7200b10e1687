"""The readers of the program's own spans (``benchmark.program_spans``): self
time and the window's arithmetic on a synthetic trace, the guard against a
stale trace file, a traced CPU run of the small checkout, and on the card
the shared clock of a span and the launch inside it."""

from __future__ import annotations

import json
import re
import types

import pytest

from benchmark import program_spans, trace
from benchmark.tests.epicbench_util import run_cpu, tiny_checkout


def _x(name, ts, dur, cat="user_annotation", tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1, "tid": tid,
            "args": args}


CHROME = {"traceEvents": [
    _x("bench.window", 0, 100),
    _x("bench.request", 10, 80),
    _x("epic.planner.compute_path", 20, 50),
    _x("epic.grid.host_copy", 22, 3),
    _x("epic.path.walk", 30, 10),
    _x("epic.planner.poses", 40, 28),
    _x("epic.gc.gen2", 50, 12),
    _x("epic.gc.gen0", 64, 1),
    _x("epic.gc.gen0", 45, 2, tid=2),          # another thread: a child of nothing
    _x("epic.planner.solve", 80, 20),
    _x("epic.path.walk", 150, 10),             # after the window: not read
    _x("k", 82, 10, cat="kernel"),
    _x("copy", 5, 3, cat="gpu_memcpy"),
    _x("aten::add", 0, 100, cat="cpu_op"),
]}


def _run(chrome, items=2, groups=1):
    return types.SimpleNamespace(trace=trace.parse(chrome), items=[{}] * items,
                                 groups=[{}] * groups)


def test_self_time_and_window_arithmetic():
    s = program_spans.parse(CHROME)
    assert s.window == pytest.approx((0.0, 100e-6))
    ms = {n: [round(v * 1e6, 6) for v in s.self_s(n)] for n in
          ("planner.compute_path", "grid.host_copy", "path.walk", "planner.poses", "gc.gen2",
           "planner.solve")}
    # compute_path 50 less its children 3 + 10 + 28; poses 28 less 12 + 1 of collections.
    assert ms == {"planner.compute_path": [9.0], "grid.host_copy": [3.0], "path.walk": [10.0],
                  "planner.poses": [15.0], "gc.gen2": [12.0], "planner.solve": [20.0]}
    assert s.collections_s() == pytest.approx(15e-6)
    # Covered: the copy 5-8, the spans 20-70 (the other thread's 45-47 inside),
    # 80-100 and the kernel inside it; the rest of the 100 is idle and unspanned.
    assert s.idle_unspanned_s() == pytest.approx(100e-6 - 3e-6 - 50e-6 - 20e-6)
    assert program_spans.idle_unspanned_pct(s) == pytest.approx(27.0)


def test_nesting_with_equal_ends_and_siblings_that_touch():
    spans = [("a", 0.0, 10.0), ("b", 0.0, 4.0), ("c", 4.0, 10.0), ("d", 4.0, 10.0)]
    assert program_spans.self_times(spans) == [0.0, 4.0, 0.0, 6.0]


def test_readers_on_the_synthetic_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(CHROME))
    run = _run(CHROME)
    spans = program_spans.read(run, path)
    assert program_spans.per_item_ms(spans.collections_s(), len(run.items)) == pytest.approx(
        7.5e-3)
    assert program_spans.mean_ms(spans.self_s("path.walk")) == pytest.approx(10e-3)
    assert program_spans.mean_ms(spans.self_s("nothing")) is None


def test_a_stale_or_missing_file_is_not_read(tmp_path):
    path = tmp_path / "trace.json"
    assert program_spans.read(_run(CHROME), path) is None            # no file
    path.write_text(json.dumps(CHROME))
    assert program_spans.read(types.SimpleNamespace(trace=None), path) is None   # untraced
    other = {"traceEvents": [_x("bench.window", 5, 100)]}
    assert program_spans.read(_run(other), path) is None             # another run's window
    assert program_spans.read(_run(CHROME), path) is not None


def test_a_program_with_no_spans_reads_nothing(tmp_path):
    """A program that records no span of its own (the parent of this
    benchmark's program-span metrics) gives no number, not a zero."""
    chrome = {"traceEvents": [e for e in CHROME["traceEvents"]
                              if not e["name"].startswith("epic.")]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(chrome))
    assert program_spans.read(_run(chrome), path) is None


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("bench"))


def test_traced_cpu_run_reports_the_span_metrics(checkout):
    out = run_cpu(checkout, "tiny.goal_solve", traced=True)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["poses_ms_per_plan.goal_solve"] > 0
    assert m["path_walk_ms_per_plan.goal_solve"] > 0
    assert m["gc_ms_per_plan.goal_solve"] >= 0
    # No device operations on the CPU: the device's share finds nothing.
    assert "idle_unspanned_pct.goal_solve" not in m
    fleet = run_cpu(checkout, "tiny.fleet64", traced=True)
    m = {k: v["value"] for k, v in fleet["metrics"].items()}
    assert m["walk_ms_per_batch.fleet64"] > 0 and m["gc_ms_per_batch.fleet64"] >= 0


@pytest.mark.cuda
def test_each_solve_span_holds_one_k2_launch_on_the_cards_clock(tmp_path):
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from epic_tpu_torch import constants as C, maps
    from epic_tpu_torch.planner import Planner, PlannerConfig

    img = maps.open_room(96, 96)
    p = Planner(PlannerConfig(epsilon=1e-3), device="cuda")
    p.update_occupancy(np.where(img == 0, 100, 0).astype(np.int16), 1.0, (0.0, 0.0))
    p.set_cells([(80, 80)], [C.CELL_TYPE_GOAL])
    p.solve()   # builds and warms the kernel
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for goal in ((80, 80), (20, 80), (80, 20)):
            p.reset_free_cells()
            p.set_cells([goal], [C.CELL_TYPE_GOAL])
            p.solve()
            assert bool(p.state.converged)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and "dur" in e]
    spans = [(e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"] == "epic.solve.sweep2d"]
    # K2's kernels, "(anonymous namespace)::solve_kernel(float*, ...)", by the
    # correlation id that ties each to the runtime call that launched it.
    k2 = {e["args"]["correlation"]: e["ts"] for e in events if e.get("cat") == "kernel"
          and re.search(r"(^|::)solve_kernel\(", e["name"])}
    launches = [(e["ts"], k2[e["args"]["correlation"]]) for e in events
                if e.get("cat") == "cuda_runtime" and e.get("args", {}).get("correlation") in k2]
    assert len(spans) == 3 and len(k2) == 3 and len(launches) == 3
    for a, b in spans:
        inside = [(t, kt) for t, kt in launches if a <= t <= b]
        assert len(inside) == 1
        (t, kernel_start), = inside
        # The device's timestamps are mapped onto the host's clock to within
        # a millisecond (PERF.md §6): the kernel starts at its launch.
        assert abs(kernel_start - t) < 1000
