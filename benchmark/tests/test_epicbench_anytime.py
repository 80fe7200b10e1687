"""The anytime mix and the comparison it names (``benchmark/checks/
anytime.py``), on the CPU: the replay of the node's inputs agrees with the
port exactly, a sound loop reads correct, each planted fault and the
bfloat16 control read not correct, the mixes that name no comparison keep
``benchmark/check.py``, and an unknown comparison fails before set-up."""

from __future__ import annotations

import importlib.util
import json
import pathlib
import shutil
import time
import types

import numpy as np
import pytest
import torch

from benchmark import check, control, harness, inputs, reference_anytime, trace
from benchmark.checks import anytime as chk
from benchmark.drivers import anytime_loop
from benchmark.tests.epicbench_util import REPO, run_cpu, tiny_checkout

# The tiny map's mix: small patches, short lives and a new episode every
# few cycles, so that one second at 10 Hz holds goal changes and restores.
TINY = {"goal_every_cycles": 5, "patch_cells": [2, 6], "patch_radius": 2,
        "patch_life_cycles": 3, "warmup_cycles": 4, "check_sample": 4}
SEED = 12345678901


# The anytime cell's metrics, as a cell of the mix lists them: the latency
# from each cycle's due time under ``plan_ms_p95``, and five readers of their
# own. No cell of BENCHMARK.json runs the mix yet.
PER_LAYER = {"edit_ms_per_cycle.anytime": ("ms", "lower", "program_span", "planner"),
             "copy_ms_per_cycle.anytime": ("ms", "lower", "program_span", "walker"),
             "path_walk_ms_per_cycle.anytime": ("ms", "lower", "program_span", "walker"),
             "overrun_pct.anytime": ("%", "lower", "host_clock", "walker"),
             "tick_roofline_pct.anytime": ("%", "higher", "device_trace", "kernels")}


def anytime_checkout(root: pathlib.Path) -> pathlib.Path:
    """The small checkout with the cell ``tiny.anytime``, and the maze demo's
    configuration and map."""
    tiny_checkout(root)
    mix = root / "benchmark/traffic/anytime.json"
    mix.write_text(json.dumps(json.loads(mix.read_text()) | TINY))
    for f in ("configs/maze_demo.json", "data/maze_demo.npz"):
        shutil.copy(REPO / "benchmark" / f, root / "benchmark" / f)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.anytime", "config": "tiny", "traffic": "anytime",
                               "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"]:
        if m["name"] == "plan_ms_p95":
            m["workloads"].append("tiny.anytime")
    for name, (unit, better, source, layer) in PER_LAYER.items():
        bench["per_layer"].append({"name": name, "unit": unit, "better": better,
                                   "source": source, "layer": layer, "moves": "plan_ms_p95",
                                   "workloads": ["tiny.anytime"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return anytime_checkout(tmp_path_factory.mktemp("bench"))


def run_anytime(checkout, seed=SEED, traced=False):
    return run_cpu(checkout, "tiny.anytime", seed=seed, seconds=1.0, traced=traced)


def metric_module(name: str):
    spec = importlib.util.spec_from_file_location(
        f"metric_{name}", REPO / "benchmark" / "metrics" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_replay_agrees_with_the_port_cycle_by_cycle_on_the_maze(checkout):
    """36 cycles on the maze demo's map, every one compared: episodes (a
    new start and goal on the warm field) at cycles 0, 12 and 24, and each
    patch cleared 5 cycles after it was set, or sooner where a new start
    or goal lands near it."""
    torch.set_num_threads(1)
    cat = harness.Catalog(checkout)
    config = cat.config("maze_demo")
    mix = cat.traffic("anytime") | {"goal_every_cycles": 12, "patch_life_cycles": 5,
                                    "patch_cells": [8, 64],
                                    "patch_radius": 6, "check_sample": 36}
    record = harness.Run(cell="maze_demo.anytime", config=config, traffic=mix, map=None)
    ctx = harness.Context(record, SEED, 0.0, torch.device("cpu"), False, time.perf_counter(),
                          checkout / "trace.json")
    record.map = ctx.map = inputs.load_map(config, checkout)
    session = anytime_loop.Session(ctx, anytime_loop.make_planner(ctx), SEED)
    for k in range(36):
        session.cycle(k, time.perf_counter())
    answers = [ctx.answers[k] for k in sorted(ctx.answers)]
    assert [a.cycle for a in answers] == list(range(36))
    restores = [i for i, c in enumerate(session.cycles)
                if (c.types == reference_anytime.FREE).any()]
    assert restores[0] == 5
    assert [i for i, c in enumerate(session.cycles) if c.remove_goals] == [12, 24]
    assert [i for i, c in enumerate(session.cycles) if c.add_goals] == [0, 12, 24]
    assert all(i["ok"] for i in record.items)
    assert any(a.points is not None for a in answers)
    for a in answers:
        a.field = a.field.cpu().numpy()
    numbers = chk.compare(answers, record.map.obstacle, config, mix, torch.device("cpu"))
    # The CPU's plain tick and the reference run the same operations in the
    # same order: every number is exactly 0.
    assert numbers == {"field_gap": 0.0, "sweeps_gap": 0, "path_gap": 0.0}


def test_set_up_leaves_the_maps_initial_field(checkout):
    torch.set_num_threads(1)
    cat = harness.Catalog(checkout)
    config, mix = cat.config("tiny"), cat.traffic("anytime")
    record = harness.Run(cell="tiny.anytime", config=config, traffic=mix, map=None)
    ctx = harness.Context(record, SEED, 0.0, torch.device("cpu"), False, time.perf_counter(),
                          checkout / "trace.json")
    record.map = ctx.map = inputs.load_map(config, checkout)
    planner = anytime_loop.make_planner(ctx)
    fresh = {k: getattr(planner.state, k).clone() for k in ("u", "locked", "iteration")}
    warm = anytime_loop.Session(ctx, planner, mix["warmup_seed"])
    for k in range(9):
        warm.cycle(k, time.perf_counter())
    warm.clear()
    for k, v in fresh.items():
        assert torch.equal(getattr(planner.state, k), v), k


def test_sound_loop_reads_correct(checkout):
    out = run_anytime(checkout)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 8
    assert {k: v["value"] for k, v in out["compared"].items()} == {
        "field_gap": 0.0, "sweeps_gap": 0.0, "path_gap": 0.0}
    assert {k: v["limit"] for k, v in out["compared"].items()} == chk.LIMITS
    assert set(out["metrics"]) == {"plan_ms_p95", "setup_s"}
    # The sample, the longest path and the window's last cycle.
    assert out["checked"] >= 5


def test_overrun_reader_counts_cycles_past_their_period():
    reader = metric_module("overrun_pct.anytime")
    items = [{"start": 0.0, "end": e} for e in (0.01, 0.099, 0.1001, 2.0)]
    run = types.SimpleNamespace(config={"update_rate_hz": 10.0}, items=items)
    assert reader.read(run) == pytest.approx(50.0)
    assert reader.read(types.SimpleNamespace(config={"update_rate_hz": 10.0}, items=[])) is None


def test_traced_run_reads_the_span_metrics(checkout):
    out = run_anytime(checkout, traced=True)
    assert out["correct"]
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["edit_ms_per_cycle.anytime"] > 0 and m["copy_ms_per_cycle.anytime"] > 0
    assert m["path_walk_ms_per_cycle.anytime"] >= 0
    assert 0 <= m["overrun_pct.anytime"] <= 100
    # The CPU runs no tick on a device: the roofline finds nothing to read.
    assert "tick_roofline_pct.anytime" not in m


def _nth_call(monkeypatch, owner, name, n, replace):
    """Patch ``owner.name`` so that its ``n``-th call, set-up's counted,
    runs ``replace(original, self, *args)``. Set-up's calls: ``update`` and
    ``set_cells`` one a warm cycle and ``set_cells`` one more to clear,
    ``add_goals`` one, ``remove_goals`` one (the clear)."""
    original = getattr(owner, name)
    calls = []

    def patched(self, *args, **kwargs):
        calls.append(1)
        if len(calls) == n:
            return replace(original, self, *args, **kwargs)
        return original(self, *args, **kwargs)

    monkeypatch.setattr(owner, name, patched)


WARM = TINY["warmup_cycles"]


def test_a_tick_of_one_sweep_fewer(checkout, monkeypatch):
    from epic_tpu_torch.planner import Planner

    # The window's cycle 6, in its last episode.
    _nth_call(monkeypatch, Planner, "update", WARM + 7, lambda f, self, n: f(self, n - 1))
    out = run_anytime(checkout)
    assert not out["correct"] and out["compared"]["sweeps_gap"]["value"] == 1


def test_a_tick_that_leaves_the_state_unchanged(checkout, monkeypatch):
    from epic_tpu_torch.planner import Planner

    monkeypatch.setattr(Planner, "update", lambda self, n=None: None)
    out = run_anytime(checkout)
    assert not out["correct"]


def test_one_cycles_edit_dropped(checkout, monkeypatch):
    from epic_tpu_torch.planner import Planner

    # The window's cycle 5, which starts its last episode: left out, its
    # expired patch stays an obstacle and its new patch stays free.
    _nth_call(monkeypatch, Planner, "set_cells", WARM + 1 + 6, lambda f, self, xy, types: True)
    out = run_anytime(checkout)
    assert not out["correct"]
    assert out["compared"]["field_gap"]["value"] > chk.LIMITS["field_gap"]


def test_a_goal_change_ignored(checkout, monkeypatch):
    from epic_tpu_torch.planner import Planner

    # The window's second goal change, at cycle 5: its remove and its add.
    _nth_call(monkeypatch, Planner, "remove_goals", 1 + 1, lambda f, self, pts: True)
    _nth_call(monkeypatch, Planner, "add_goals", 1 + 2, lambda f, self, pts: True)
    out = run_anytime(checkout)
    assert not out["correct"]
    assert out["compared"]["field_gap"]["value"] > chk.LIMITS["field_gap"]


def test_a_path_walked_on_the_field_before_the_tick(checkout, monkeypatch):
    from epic_tpu_torch.planner import Planner

    update, walk = Planner.update, Planner.compute_path

    def deferred(self, n=None):
        self._deferred = n

    def stale_walk(self, *args, **kwargs):
        try:
            return walk(self, *args, **kwargs)
        finally:
            update(self, self._deferred)

    monkeypatch.setattr(Planner, "update", deferred)
    monkeypatch.setattr(Planner, "compute_path", stale_walk)
    out = run_anytime(checkout)
    assert not out["correct"]
    assert out["compared"]["path_gap"]["value"] > chk.LIMITS["path_gap"]
    assert out["compared"]["sweeps_gap"]["value"] == 0


def test_a_free_restore_written_as_obstacle(checkout, monkeypatch):
    from epic_tpu_torch import constants as C
    from epic_tpu_torch.planner import Planner

    set_cells = Planner.set_cells

    def obstacle_for_free(self, xy, types):
        types = np.where(np.asarray(types) == C.CELL_TYPE_FREE, C.CELL_TYPE_OBSTACLE, types)
        return set_cells(self, xy, types)

    monkeypatch.setattr(Planner, "set_cells", obstacle_for_free)
    out = run_anytime(checkout)
    assert not out["correct"]
    assert out["compared"]["field_gap"]["value"] > chk.LIMITS["field_gap"]


def test_an_answer_altered_where_it_is_produced(checkout, monkeypatch):
    from epic_tpu_torch import planner

    walk = planner.compute_path

    def altered(*a, **k):
        pts = walk(*a, **k).copy()
        pts[len(pts) // 2, 1] += 0.02
        return pts

    monkeypatch.setattr(planner, "compute_path", altered)
    out = run_anytime(checkout)
    assert not out["correct"]
    assert out["compared"]["path_gap"]["value"] > chk.LIMITS["path_gap"]


def test_bfloat16_control_fails(checkout):
    torch.set_num_threads(1)
    for seed in (1, 2, 3):
        out = control.mix_control_numbers(harness.Catalog(checkout), "tiny.anytime", seed,
                                          torch.device("cpu"), seconds=1.0)
        assert out["program_passes"] and out["failed"] == 0, out
        assert out["fails"], out


def test_mixes_without_a_check_keep_check_py(checkout):
    cat = harness.Catalog(REPO)
    for mix in ("goal_solve", "fleet64"):
        assert "check" not in cat.traffic(mix)
        assert harness.comparison(cat.traffic(mix)) is check
    assert harness.comparison(cat.traffic("anytime")) is chk
    assert check.LIMITS == {"field_gap": 0.01, "sweeps_gap": 1000, "path_gap": 0.005}
    out = run_cpu(checkout, "tiny.goal_solve")
    assert {k: v["limit"] for k, v in out["compared"].items()} == check.LIMITS


def test_an_unknown_check_fails_before_set_up(checkout, monkeypatch):
    mixes = checkout / "benchmark" / "traffic"
    (mixes / "no_check.json").write_text(json.dumps(
        json.loads((mixes / "anytime.json").read_text()) | {"check": "no_such_check"}))
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.no_check", "config": "tiny",
                               "traffic": "no_check", "chips": 1, "why": "x"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    driven = []
    monkeypatch.setattr(harness, "drive", lambda *a, **k: driven.append(1))
    with pytest.raises(KeyError, match="no_such_check"):
        run_cpu(checkout, "tiny.no_check")
    assert not driven


def test_tick_roofline_reads_the_launched_operations():
    """A tick's launch returns before its kernel runs: the reader takes the
    operations launched inside the tick spans, by correlation id, wherever
    they ran, and nothing launched outside them."""
    def x(name, ts, dur, cat, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}

    reader = metric_module("tick_roofline_pct.anytime")
    chrome = {"traceEvents": [
        x("bench.window", 0, 1000, "user_annotation"),
        x("epic.tick.sweep2d", 100, 20, "user_annotation"),
        x("cudaLaunchKernel", 105, 5, "cuda_runtime", correlation=7),
        x("chunk_kernel", 130, 50, "kernel", correlation=7),       # after the span
        x("epic.tick.sweep2d", 500, 20, "user_annotation"),
        x("cudaMemcpyAsync", 510, 2, "cuda_runtime", correlation=9),
        x("Memcpy DtoD", 515, 4, "gpu_memcpy", correlation=9),
        x("cudaLaunchKernel", 300, 5, "cuda_runtime", correlation=8),   # no tick
        x("other_kernel", 302, 40, "kernel", correlation=8),
        x("epic.tick.sweep2d", 2000, 20, "user_annotation"),            # after the window
    ]}
    n, busy = reader.tick_device_s(chrome, (0.0, 1000e-6))
    assert n == 2 and busy == pytest.approx(54e-6)


def test_tick_roofline_counts_each_ticks_unlocked_cells():
    obstacle = np.zeros((6, 7), bool)
    obstacle[2, 3] = True
    cycles = [reference_anytime.Cycle(cells=np.array([[4, 3]]), types=np.array([1]),
                                      remove_goals=[], add_goals=[(1.25, 1.25)], sweeps=3),
              reference_anytime.Cycle(cells=np.array([[4, 3]]), types=np.array([2]),
                                      remove_goals=[], add_goals=[], sweeps=2)]
    m = inputs.Map(obstacle=obstacle, cells=np.zeros((0, 2), int), resolution=1.0,
                   origin=(0.0, 0.0))
    run = type("Run", (), {"map": m, "items": [{"inputs": c} for c in cycles]})()
    reader = metric_module("tick_roofline_pct.anytime")
    # Interior 4 x 5 = 20 cells, 10 of each class ((y + x) even, odd).
    # Cycle 0: the obstacle (3, 2), odd; the goal (1, 1), even; the patch
    # (4, 3), odd: 9 even and 8 odd unlocked. Sweeps at t = 0, 1, 2 relax the
    # odd, even, odd classes: 8 + 9 + 8 updates.
    # Cycle 1: the patch cleared, 9 and 9; t = 3, 4: 9 + 9 updates.
    ops = [(8 + 9 + 8) * 17, (9 + 9) * 17]
    expect = sum(max(o / 67e12, 42 * 9 / 3.35e12) for o in ops)
    assert reader.least_s(run) == pytest.approx(expect)


def test_the_anytime_yardstick_loads_nothing_of_the_program():
    import subprocess
    import sys

    proc = subprocess.run(
        [sys.executable, "-c", "import sys, benchmark.reference_anytime, benchmark.checks.anytime;"
         "print(' '.join(sorted({m.partition('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, timeout=600, check=True)
    found = set(proc.stdout.split())
    assert "benchmark" in found
    assert not found & {"epic_tpu_torch", "epic_tpu", "jax", "jaxlib", "flax"}


def test_edit_reader_sums_the_verbs_spans(tmp_path):
    def x(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur,
                "pid": 1, "tid": 1}

    chrome = {"traceEvents": [
        x("bench.window", 0, 1000), x("epic.planner.set_cells", 100, 100),
        x("epic.planner.add_goals", 300, 50), x("epic.grid.host_copy", 310, 30),
        x("epic.planner.remove_goals", 400, 10), x("epic.planner.reset_free_cells", 450, 20),
        x("epic.planner.update", 500, 100)]}
    path = tmp_path / "trace.json"
    path.write_text(json.dumps(chrome))
    reader = metric_module("edit_ms_per_cycle.anytime")
    reader.TRACE = path
    run = types.SimpleNamespace(trace=trace.parse(chrome), items=[{}] * 4)
    assert reader.read(run) == pytest.approx(1e3 * 180e-6 / 4)
    copies = metric_module("copy_ms_per_cycle.anytime")
    copies.TRACE = path
    assert copies.read(run) == pytest.approx(1e3 * 30e-6 / 4)
