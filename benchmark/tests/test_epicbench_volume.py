"""The volume cell's pieces on the CPU: the volume the driver hands the
program is the one the check rebuilds; the program's plain core equals the
plain reference on a small storey, bit for bit; planted faults come out not
correct and the bfloat16 control fails; the 3D roofline counts what a hand
count gives; and a short run of the driver and the check through the
harness is correct."""

from __future__ import annotations

import json
import pathlib
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark import control, harness, inputs, reference_volume, roofline3d, volume
from benchmark.checks import volume as vcheck
from benchmark.tests.epicbench_util import REPO

CELL = "tiny3d.volume_goal_solve"


def tiny_volume_checkout(root: pathlib.Path) -> pathlib.Path:
    """A small checkout with the cell ``tiny3d.volume_goal_solve``: a 40 x
    120 crop of the umass plan, extruded through 12 planes (goals and starts
    on planes 2 to 9), under the repository's volume mix, check and
    readers."""
    (root / "benchmark").mkdir(parents=True)
    for d in ("metrics", "traffic"):
        shutil.copytree(REPO / "benchmark" / d, root / "benchmark" / d)
    for d in ("configs", "data"):
        (root / "benchmark" / d).mkdir()
    with np.load(REPO / "benchmark/data/umass_demo.npz") as data:
        img = data["img"][100:140, 300:420].copy()
    np.savez_compressed(root / "benchmark/data/tiny3d.npz", img=img)
    cfg = json.loads((REPO / "benchmark/configs/umass_storey.json").read_text())
    cfg.update(name="tiny3d", clearance_m=0.1,
               map=dict(file="benchmark/data/tiny3d.npz", key="img", height=40, width=120,
                        sha256=inputs.image_sha256(img)))
    cfg["volume"].update(depth=12, z_band=[2, 9])
    (root / "benchmark/configs/tiny3d.json").write_text(json.dumps(cfg))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny3d", "source": "a cut of umass_storey",
                             "file": "benchmark/configs/tiny3d.json", "reduced": [],
                             "why": "CPU tests"})
    bench["workloads"].append({"name": CELL, "config": "tiny3d",
                               "traffic": "volume_goal_solve", "chips": 1, "why": "CPU tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "umass_storey.volume_goal_solve" in m.get("workloads", []):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cpu(root, seed: int = 3_624_000_001_234, seconds: float = 1.0,
            traced: bool = False) -> dict:
    torch.set_num_threads(1)
    return harness.run(CELL, seed, seconds, traced, catalog=harness.Catalog(root),
                       device=torch.device("cpu"), started=time.perf_counter())


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_volume_checkout(tmp_path_factory.mktemp("bench3d"))


@pytest.fixture(scope="module")
def tiny(checkout):
    cat = harness.Catalog(checkout)
    config = cat.config("tiny3d")
    return config, inputs.load_map(config, checkout)


def test_the_volume_handed_to_the_program_is_the_checks(tiny):
    """``update_occupancy`` of the driver's occupancy volume locks exactly
    the check's voxels; after a request's edits the program's state is the
    reference's initial field."""
    from epic_tpu_torch.planner3d import VolumePlanner, VolumePlannerConfig

    config, m = tiny
    occ = volume.occupancy(m.obstacle, config)
    assert occ.dtype == np.int16 and occ.shape == volume.shape(m.obstacle, config) == (12, 40, 120)
    p = VolumePlanner(VolumePlannerConfig(epsilon=1e-3), device="cpu")
    p.update_occupancy(occ, m.resolution, (0.0, 0.0, 0.0))
    base = volume.locked(m.obstacle, config)
    np.testing.assert_array_equal(p.state.locked.numpy(), base)
    (goal,), _ = volume.Stream(m, 5, config["volume"]["z_band"]).take(3)
    p.reset_free_cells()
    p.set_cells([tuple(goal)], [0])
    u, locked = reference_volume.initial_field(base, goal, "cpu")
    np.testing.assert_array_equal(p.state.locked.numpy(), locked.numpy())
    np.testing.assert_array_equal(p.state.u.numpy(), u.numpy())


def test_stream_depends_on_the_seed_and_index_alone(tiny):
    config, m = tiny
    band = config["volume"]["z_band"]
    a = volume.Stream(m, 2**40 + 7, band)
    g, s = a.take(1500, 3)
    b = volume.Stream(m, 2**40 + 7, band)
    np.testing.assert_array_equal(b.take(1500, 3)[0], g)
    assert g.shape == s.shape == (3, 3)
    gz, sz = a.take(0, 1024)[0][:, 2], a.take(0, 1024)[1][:, 2]
    assert gz.min() == sz.min() == band[0] and gz.max() == sz.max() == band[1]
    plane = inputs.Stream(m, 2**40 + 7).take(1500, 3)
    np.testing.assert_array_equal(g[:, :2], plane[0])
    np.testing.assert_array_equal(s[:, :2], plane[1])
    assert not np.array_equal(volume.Stream(m, 2**40 + 8, band).take(0, 50)[0], a.take(0, 50)[0])


def test_plain_core_equals_the_reference(tiny):
    """The VolumePlanner on the CPU (the port's plain core) and the plain
    reference: the same field bits and sweep count; the program's walk reads
    0 on the reference's field."""
    from epic_tpu_torch.planner3d import VolumePlanner, VolumePlannerConfig

    torch.set_num_threads(1)
    config, m = tiny
    p = VolumePlanner(VolumePlannerConfig(epsilon=config["epsilon"], stagger=config["stagger"],
                                          resolution=m.resolution), device="cpu")
    p.update_occupancy(volume.occupancy(m.obstacle, config), m.resolution, (0.0, 0.0, 0.0))
    stream = volume.Stream(m, 9, config["volume"]["z_band"])
    base = volume.locked(m.obstacle, config)
    for k in range(2):
        (goal,), (start,) = stream.take(k)
        p.reset_free_cells()
        p.set_cells([tuple(goal)], [0]) if k == 0 else p.set_cells(
            [tuple(prev), tuple(goal)], [2, 0])
        prev = goal
        p.solve()
        u, locked = reference_volume.initial_field(base, goal, "cpu")
        u, sweeps, converged = reference_volume.solve(u, locked, config["epsilon"],
                                                      config["stagger"])
        assert converged and bool(p.state.converged)
        assert sweeps == int(p.state.iteration) and sweeps % config["stagger"] == 1
        assert np.array_equal(p.state.u.numpy().view(np.uint32), u.numpy().view(np.uint32))
        d, h, w = u.shape
        world = p.map_to_world(*map(float, start))
        poses = p.compute_path(world, 0.05, 0.5)
        pts = np.stack([poses.x, poses.y, poses.z], axis=1) / m.resolution
        gap = reference_volume.step_gap(u.numpy(), locked.numpy(), p.world_to_map(*world), pts,
                                        0.05, 0.5, int(w * h * d / 0.05))
        assert gap == 0.0
        outcome, ref_pts = reference_volume.walk(u.numpy(), locked.numpy(),
                                                 p.world_to_map(*world), 0.05, 0.5,
                                                 int(w * h * d / 0.05))
        assert outcome == reference_volume.OK
        np.testing.assert_array_equal(ref_pts, pts.astype(np.float32))


def test_reference_by_hand():
    """One free voxel between the shell and a goal: log(1/6) after the
    sweep of its class; the exit comes at the first passing check from
    iteration max(D, H, W) on."""
    locked = np.ones((3, 3, 3), bool)
    locked[1, 1, 1] = False
    u, lk = reference_volume.initial_field(locked, (2, 1, 1), "cpu")
    u, sweeps, converged = reference_volume.solve(u, lk, 1e-3, 1)
    assert abs(float(u[1, 1, 1]) - np.log(1 / 6)) < 1e-6
    # The centre, (1 + 1 + 1) odd, is relaxed at odd iterations: sweep 1
    # moves it, sweep 2 relaxes the empty even class, and its check passes
    # at iteration 3 = max(D, H, W).
    assert (sweeps, converged) == (3, True)


def test_reference_walk_rule_by_hand():
    """A field rising along x: the walk steps +x by the step size, in
    float32, and ends on the goal plane's locked voxels."""
    u = np.broadcast_to(np.linspace(-9, 0, 10, dtype=np.float32), (5, 6, 10)).copy()
    locked = np.zeros(u.shape, bool)
    locked[:, :, 9] = True
    outcome, pts = reference_volume.walk(u, locked, (2.0, 2.5, 2.0), 0.5, 0.25, 10_000)
    assert outcome == reference_volume.OK
    np.testing.assert_array_equal(pts[:, 1:], np.tile(np.float32([2.5, 2.0]), (len(pts), 1)))
    np.testing.assert_allclose(np.diff(pts[:, 0]), 0.5)
    assert int(pts[-1, 0] + 0.5) == 9 and int(pts[-2, 0] + 0.5) < 9
    assert reference_volume.step_gap(u, locked, (2.0, 2.5, 2.0), pts, 0.5, 0.25, 10_000) == 0
    assert reference_volume.step_gap(u, locked, (2.0, 2.5, 2.0), pts[:-1], 0.5, 0.25,
                                     10_000) == np.inf


def test_sound_run_is_correct_and_reports_its_metrics(checkout):
    out = run_cpu(checkout, seconds=3.0, traced=True)
    assert out["correct"], out["compared"]
    assert out["attempted"] >= 2 and out["failed"] == 0 and out["checked"] >= 1
    assert all(v["value"] == 0 for v in out["compared"].values())
    assert {"sweeps_per_plan.volume_goal_solve", "walk_ms_per_plan.volume_goal_solve",
            "copy_ms_per_plan.volume_goal_solve",
            "path_walk_ms_per_plan.volume_goal_solve"} <= set(out["metrics"])
    assert out["metrics"]["sweeps_per_plan.volume_goal_solve"]["value"] % 100 == 1
    untraced = run_cpu(checkout, seed=17)
    assert untraced["correct"] and set(untraced["metrics"]) == {"setup_s", "plans_per_s"}


def test_a_program_without_pose_arrays_fails_at_once(checkout, monkeypatch):
    """A program without ``PathPoses3D`` cannot run this mix: the driver
    stops before its set-up."""
    from epic_tpu_torch import planner3d

    monkeypatch.delattr(planner3d, "PathPoses3D")
    t0 = time.perf_counter()
    with pytest.raises(ImportError):
        run_cpu(checkout)
    assert time.perf_counter() - t0 < 30


def _solve_short_by_a_sweep(state, stagger=None, max_iterations=1_000_000, *a, **k):
    from epic_tpu_torch.solver import core

    sound = core.solve(state, stagger, max_iterations)
    return core.solve(state, stagger, int(sound.iteration) - 1)


def _solve_on_the_2d_class(state, stagger=None, max_iterations=1_000_000, *a, **k):
    """The solve protocol with each sweep relaxing the other class (the 2D
    rule's ``(z + y + x) % 2 != t % 2``)."""
    import dataclasses

    from epic_tpu_torch.solver import core

    u, it = state.u, 0
    while it < max_iterations:
        u, delta = core.sweep(u, state.locked, it + 1)
        it += 1
        if it >= max(u.shape) and bool(delta < state.epsilon):
            break
        for s in range(stagger - 1):
            u, _ = core.sweep(u, state.locked, it + s + 1)
        it += stagger - 1
    return dataclasses.replace(state, u=u, iteration=torch.tensor(it, dtype=torch.int32),
                               converged=torch.tensor(True))


def _lse4_in_place_of_lse6(zm, zp, ym, yp, xm, xp):
    from epic_tpu_torch.solver import _sweep_body

    return _sweep_body.lse4(ym, yp, xm, xp)


@pytest.mark.parametrize("fault", ["short_by_a_sweep", "lse4", "path_step"])
def test_planted_fault_is_not_correct(checkout, monkeypatch, fault):
    from epic_tpu_torch import planner3d, solver
    from epic_tpu_torch.solver import core

    if fault == "short_by_a_sweep":
        monkeypatch.setattr(solver, "solve_volume", _solve_short_by_a_sweep)
    elif fault == "lse4":
        monkeypatch.setattr(core, "lse6", _lse4_in_place_of_lse6)
    else:
        walk = planner3d.compute_path

        def altered(*a, **k):
            pts = walk(*a, **k).copy()
            pts[len(pts) // 2, 2] += 0.02
            return pts

        monkeypatch.setattr(planner3d, "compute_path", altered)
    out = run_cpu(checkout)
    assert not out["correct"], out
    if fault == "short_by_a_sweep":
        assert out["failed"] == out["attempted"] > 0
    elif fault == "path_step":
        assert out["compared"]["path_gap"]["value"] > vcheck.LIMITS["path_gap"]
    else:
        assert any(v["value"] > v["limit"] for v in out["compared"].values()), out["compared"]


def test_the_2d_class_order_stays_within_epsilon(checkout, monkeypatch):
    """A solve that relaxes the classes in the 2D rule's order reaches the
    same fixed point, and exits with it to within epsilon: the check sees
    the difference (``field_gap`` above the sound runs' 0) and, by its
    limits, accepts it. Pinned here so that a change of the limits or of
    the definitions shows."""
    from epic_tpu_torch import solver

    monkeypatch.setattr(solver, "solve_volume", _solve_on_the_2d_class)
    out = run_cpu(checkout)
    numbers = {k: v["value"] for k, v in out["compared"].items()}
    assert 0 < numbers["field_gap"] < 1e-3, numbers
    assert out["correct"] and out["failed"] == 0


def test_bfloat16_control_fails(checkout):
    torch.set_num_threads(1)
    for seed in (1, 2):
        out = control.mix_control_numbers(harness.Catalog(checkout), CELL, seed,
                                          torch.device("cpu"), 1.0)
        assert out["program_passes"] and out["failed"] == 0, out
        assert out["fails"], out
        assert np.isfinite(out["numbers"]["field_gap"])


def test_roofline3d_against_a_hand_count():
    locked = np.zeros((4, 5, 6), bool)
    locked[[0, -1]] = True
    locked[:, [0, -1]] = True
    locked[:, :, [0, -1]] = True
    locked[1, 2, 3] = locked[2, 1, 2] = True      # one even, one odd
    even = odd = 0
    for z in range(1, 3):
        for y in range(1, 4):
            for x in range(1, 5):
                if not locked[z, y, x]:
                    if (z + y + x) % 2:
                        odd += 1
                    else:
                        even += 1
    assert roofline3d.class_counts(locked) == (even, odd) == (11, 11)
    # Sweeps 0..4 from t0 = 0 relax even, odd, even, odd, even.
    assert roofline3d.updates((even, odd), 5) == 3 * even + 2 * odd
    assert roofline3d.updates((even, odd), 5, t0=1) == 2 * even + 3 * odd
    n = roofline3d.updates((7, 9), 1001)
    assert n == 501 * 7 + 500 * 9
    assert roofline3d.least_seconds(n, 10) == n * 25 / 67e12
    assert roofline3d.least_seconds(1, 10**9) == 9e9 / 3.35e12
    # Goals (x, y, z) on (1, 1, 2), even, and (2, 2, 1), odd: each goal's
    # class loses a voxel.
    items = [{"goal": (1, 1, 2), "sweeps": 5}, {"goal": (2, 2, 1), "sweeps": 3}]
    want = (3 * (even - 1) + 2 * odd) + (2 * even + 1 * (odd - 1))
    assert roofline3d.solves_least_seconds(locked, items) == max(want * 25 / 67e12,
                                                                 2 * locked.size * 9 / 3.35e12)


def test_reference_loads_nothing_of_the_program():
    """The volume reference, its check, the volume builder and the 3D
    roofline import torch and NumPy only: no JAX, nothing of the program."""
    import subprocess
    import sys

    from benchmark import run as run_mod

    code = ("import benchmark.reference_volume, benchmark.checks.volume, benchmark.volume, "
            "benchmark.roofline3d, sys; "
            "print(' '.join(sorted({m.partition('.')[0] for m in sys.modules})))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600, check=True)
    found = set(proc.stdout.split())
    assert "benchmark" in found and "torch" in found
    assert not found & ({"epic_tpu_torch"} | set(run_mod.FORBIDDEN))
