"""The program's spans (epic_tpu_torch.profiling.span): off, a flag read and a
shared context that does nothing; on, ``epic.*`` ranges in the profiler's
trace at the Planner's and the VolumePlanner's verbs, the host copies, the
2D and 3D walks, the pose loops, the route taken, and the collector's
``epic.gc.gen<N>`` ranges.

This file imports neither JAX nor epic_tpu. Its one ``cuda`` test runs on a
host that has only torch:

    python -m pytest --noconftest tests/test_torch_spans.py -q
"""

import gc
import json

import numpy as np
import pytest
import torch

from epic_tpu_torch import constants as C
from epic_tpu_torch import maps, path, profiling
from epic_tpu_torch import path3d
from epic_tpu_torch.planner import Planner, PlannerConfig
from epic_tpu_torch.planner3d import VolumePlanner, VolumePlannerConfig
from epic_tpu_torch.solver import hopper_batched


@pytest.fixture(autouse=True)
def _no_gc_hook_left():
    """The collector's hook is process-wide: take it out after each test."""
    yield
    profiling.remove_gc_spans()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planner(device="cpu") -> Planner:
    img = maps.open_room(24, 24)
    p = Planner(PlannerConfig(epsilon=1e-2, stagger=10), device=device)
    p.update_occupancy(np.where(img == 0, 100, 0).astype(np.int16), 1.0, (0.0, 0.0))
    return p


def _request(p: Planner) -> list:
    """One request as move_base makes it: reset, a new goal, solve, a path."""
    p.reset_free_cells()
    p.set_cells([(18, 18)], [C.CELL_TYPE_GOAL])
    p.solve()
    return p.compute_path((4.0, 4.0), step_size=0.5)


def _spans(trace_dir, collections: bool = False) -> list[tuple[str, float, float]]:
    """The ``epic.*`` ranges of the one trace under ``trace_dir``, as
    ``(name, start_us, end_us)`` with the prefix taken off; the collector's
    ``gc.*`` only with ``collections``."""
    (f,) = trace_dir.glob("trace-*.json")
    out = []
    for e in json.loads(f.read_text())["traceEvents"]:
        name = e.get("name", "")
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and name.startswith("epic."):
            name = name[len("epic."):]
            if collections or not name.startswith("gc."):
                out.append((name, float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return sorted(out, key=lambda s: s[1])


def _inside(spans, outer: str) -> list[str]:
    """Names of the spans that lie within each span named ``outer``."""
    out = []
    for name, a, b in spans:
        if name == outer:
            out += [n for n, c, d in spans if (n, c, d) != (name, a, b) and a <= c and d <= b]
    return out


def test_recording_is_torch_profilers_flag():
    """The one flag read: torch's Python-side flag, set while a profiler
    records and clear otherwise. A torch that moves it fails here."""
    assert isinstance(torch.autograd.profiler._is_profiler_enabled, bool)
    assert profiling.recording() is False
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert profiling.recording() is True
        assert torch.autograd.profiler._is_profiler_enabled is True
    assert profiling.recording() is False


def test_off_creates_no_range_and_installs_no_hook(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function created with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    hooks = list(gc.callbacks)
    p = _planner()
    poses = _request(p)
    gc.collect()
    assert len(poses) > 2 and p.state.converged
    assert gc.callbacks == hooks
    assert profiling.span("a") is profiling.span("b")   # one shared context
    with pytest.raises(KeyError):
        with profiling.span("a"):
            raise KeyError("passes through")


def test_on_names_the_request_and_nests_the_walk(tmp_path):
    p = _planner()
    with profiling.trace(tmp_path):
        _request(p)
    spans = _spans(tmp_path)
    names = {s[0] for s in spans}
    assert {"planner.reset_free_cells", "planner.set_cells", "planner.solve",
            "planner.compute_path", "grid.host_copy", "path.walk", "planner.poses"} <= names
    assert sorted(_inside(spans, "planner.compute_path")) == [
        "grid.host_copy", "grid.host_copy", "path.walk", "planner.poses"]


def test_solve_encloses_the_plain_route_on_the_cpu(tmp_path):
    p = _planner()
    p.set_cells([(18, 18)], [C.CELL_TYPE_GOAL])
    with profiling.trace(tmp_path):
        p.solve()
        p.update(5)
    spans = _spans(tmp_path)
    assert _inside(spans, "planner.solve") == ["solve.core"]
    assert _inside(spans, "planner.update") == ["tick.core"]


def test_collection_is_a_span_inside_the_open_span(tmp_path):
    with profiling.trace(tmp_path):
        with profiling.span("outer"):
            gc.collect()
    assert "gc.gen2" in _inside(_spans(tmp_path, collections=True), "outer")
    assert profiling._gc_span in gc.callbacks   # installed by the first span


def test_hook_returns_at_once_with_no_profiler(tmp_path):
    with profiling.trace(tmp_path):
        with profiling.span("outer"):
            pass
    assert profiling._gc_span in gc.callbacks
    gc.collect()   # no profiler: the hook opens nothing
    assert profiling._gc_open == []


def test_walk_alone_is_a_span(tmp_path):
    u = np.full((16, 16), -1e6, np.float32)
    locked = np.zeros((16, 16), bool)
    locked[0, :] = locked[-1, :] = locked[:, 0] = locked[:, -1] = True
    u[1:-1, 1:-1] = -np.linspace(5, 1, 14, dtype=np.float32)[None, :]
    u[8, 14], locked[8, 14] = 0.0, True
    with profiling.trace(tmp_path):
        pts = path.compute_path(u, locked, 2.0, 8.0, step_size=0.5, impl="numpy")
    assert len(pts) > 2
    assert [s[0] for s in _spans(tmp_path)] == ["path.walk"]


def test_goal_batch_spans_on_the_cpu(tmp_path):
    img = maps.open_room(16, 16)
    base_u = np.full(img.shape, -1e6, np.float32)
    goals = np.array([[[12, 12]], [[3, 12]]])
    with profiling.trace(tmp_path):
        hopper_batched.solve_batch_goals(base_u, img == 0, goals, epsilon=1e-2, stagger=10,
                                         max_iterations=200, device="cpu")
    names = [s[0] for s in _spans(tmp_path)]
    assert names == ["batch.make_goals", "solve.batched.core"]


def _volume_planner(device="cpu") -> VolumePlanner:
    p = VolumePlanner(VolumePlannerConfig(epsilon=1e-2, stagger=10), device=device)
    occ = np.zeros((8, 12, 14), np.int16)
    occ[:, 5, 3:9] = 100
    p.update_occupancy(occ, 1.0, (0.0, 0.0, 0.0))
    return p


def _volume_request(p: VolumePlanner):
    """One request as a 3D planner makes it: reset, a new goal, solve, a path."""
    p.reset_free_cells()
    p.set_cells([(10, 9, 4)], [C.CELL_TYPE_GOAL])
    p.solve()
    return p.compute_path((3.0, 2.0, 3.0), step_size=0.5)


def test_volume_request_off_creates_no_range(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function created with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    hooks = list(gc.callbacks)
    p = _volume_planner()
    poses = _volume_request(p)
    p.update(3)
    assert len(poses) > 2 and gc.callbacks == hooks


def test_volume_request_names_the_verbs_and_nests_the_walk(tmp_path):
    p = _volume_planner()
    with profiling.trace(tmp_path):
        _volume_request(p)
        p.update(3)
    spans = _spans(tmp_path)
    names = [s[0] for s in spans]
    assert names[:3] == ["planner3d.reset_free_cells", "planner3d.set_cells", "planner3d.solve"]
    assert sorted(_inside(spans, "planner3d.compute_path")) == [
        "grid.host_copy", "grid.host_copy", "path3d.walk", "planner3d.poses"]
    assert _inside(spans, "planner3d.solve") == ["solve.core"]
    assert _inside(spans, "planner3d.update") == ["tick.core"]


def test_volume_walk_alone_is_a_span(tmp_path):
    u = np.broadcast_to(-np.linspace(5, 1, 14, dtype=np.float32), (8, 12, 14)).copy()
    locked = np.zeros(u.shape, bool)
    u[4, 6, 12], locked[4, 6, 12] = 0.0, True
    with profiling.trace(tmp_path):
        for impl in ("numpy", "native"):
            assert len(path3d.compute_path(u, locked, 2.0, 6.0, 4.0, 0.5, impl=impl)) > 2
    assert [s[0] for s in _spans(tmp_path)] == ["path3d.walk", "path3d.walk"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_batched_route_span_names_the_counted_route(card, tmp_path):
    img = maps.open_room(64, 64)
    base_u = np.full(img.shape, -1e6, np.float32)
    goals = np.array([[[40, 40]], [[20, 44]]])
    before = dict(hopper_batched.routes)
    with profiling.trace(tmp_path):
        hopper_batched.solve_batch_goals(base_u, img == 0, goals, epsilon=1e-2, stagger=10,
                                         max_iterations=500, device=card)
        torch.cuda.synchronize(card)
    (route,) = [r for r, n in hopper_batched.routes.items() if n != before[r]]
    names = [s[0] for s in _spans(tmp_path)]
    assert names == ["batch.make_goals", f"solve.batched.{route}"]


@pytest.mark.cuda
def test_volume_solve_and_tick_spans_name_k7(card, tmp_path):
    p = _volume_planner(card)
    with profiling.trace(tmp_path):
        _volume_request(p)
        p.update(3)
        torch.cuda.synchronize(card)
    spans = _spans(tmp_path)
    assert _inside(spans, "planner3d.solve") == ["solve.sweep3d"]
    assert _inside(spans, "planner3d.update") == ["tick.sweep3d"]
