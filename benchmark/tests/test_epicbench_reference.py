"""The frozen plain reference against answers known by hand, and against the
port's own plain solver and walkers on the CPU (the reference imports
neither)."""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from benchmark import reference


def lanes(obstacle, goals):
    return reference.initial_lanes(np.asarray(obstacle, bool), goals, "cpu")


def crop_field(size: int = 64):
    """A solved cut of the maze demo's map, its goal, and cells of the goal's
    free component at least two cells from a wall, as ``(x, y)``."""
    from scipy import ndimage

    with np.load("benchmark/data/maze_demo.npz") as data:
        obstacle = data["img"][100:100 + size, 100:100 + size] == 0
    free = ~obstacle
    free[0, :] = free[-1, :] = free[:, 0] = free[:, -1] = False
    labels, _ = ndimage.label(free)
    big = (labels == np.bincount(labels.ravel())[1:].argmax() + 1)
    ys, xs = np.nonzero(big & (ndimage.distance_transform_edt(free) >= 2))
    goal = (int(xs[0]), int(ys[0]))
    u, locked = lanes(obstacle, [goal])
    u, _, _ = reference.solve(u, locked, 1e-3, 100)
    cells = [(float(x), float(y)) for x, y in zip(xs[1::97], ys[1::97])]
    return u[0].numpy(), locked[0].numpy(), goal, cells


def test_one_free_cell_by_hand():
    # A 3 x 3 map: the centre is the only free cell; its west neighbour
    # would be the ring. Put the goal on the ring's east side: the centre's
    # neighbours are -1e6, -1e6, -1e6 and 0, so it becomes log(1/4).
    obstacle = np.zeros((3, 3), bool)
    u, locked = lanes(obstacle, [(2, 1)])
    u, sweeps, converged = reference.solve(u, locked, 1e-3, 1)
    assert math.isclose(float(u[0, 1, 1]), math.log(0.25), rel_tol=1e-6)
    # The centre, (1 + 1) even, is relaxed at odd iterations. With a check a
    # sweep and m_max = 3, sweep 1 moves it; sweep 2, which relaxes the empty
    # odd class, changes nothing, and its check passes at iteration 3.
    assert sweeps.tolist() == [3] and converged.tolist() == [True]


def test_corridor_is_harmonic_in_probability_space():
    # A 1-cell corridor of n free cells between a goal and a wall: in
    # probability space p(k) is linear, p = (n + 1 - k) / (n + 1) with the
    # random walk's step split 1/4 each way and the side walls absorbing.
    # Solve it to a tight epsilon and compare with numpy's linear solve.
    n = 6
    obstacle = np.ones((3, n + 2), bool)
    obstacle[1, 1:n + 1] = False
    u, locked = lanes(obstacle, [(1, 1)])
    u, _, converged = reference.solve(u, locked, 1e-7, 1, max_iterations=100_000)
    assert converged[0]
    free = list(range(2, n + 1))
    a = np.eye(len(free)) * 4.0
    b = np.zeros(len(free))
    for i, x in enumerate(free):
        for nx in (x - 1, x + 1):
            if nx == 1:
                b[i] += 1.0
            elif nx in free:
                a[i, free.index(nx)] -= 1.0
    p = np.linalg.solve(a, b)
    assert np.allclose(np.exp(u[0, 1, 2:n + 1].double().numpy()), p, rtol=1e-4)


def test_solve_is_the_ports_core_bit_for_bit():
    from epic_tpu_torch import grid
    from epic_tpu_torch.solver import core

    with np.load("benchmark/data/maze_demo.npz") as data:
        obstacle = data["img"][100:164, 100:164] == 0
    goals = [(10, 12), (40, 30), (50, 55)]
    free = ~obstacle
    goals = [g for g in goals if free[g[1], g[0]]]
    u, locked = lanes(obstacle, goals)
    u, sweeps, _ = reference.solve(u, locked, 1e-3, 100)
    for i, (gx, gy) in enumerate(goals):
        u0, l0 = reference.initial_lanes(obstacle, [(gx, gy)], "cpu")
        st = grid.make_state(u0[0].numpy(), l0[0].numpy(), 1e-3, device="cpu")
        out = core.solve(st, 100)
        assert int(out.iteration) == sweeps[i]
        assert torch.equal(out.u, u[i])


def test_walk_is_the_ports_walker_point_for_point():
    from epic_tpu_torch import path

    u, locked, goal, cells = crop_field()
    starts = cells[:6] + [(0.0, 0.0)]
    for mode in ("reference", "bilinear"):
        walks = reference.walk(u, locked, starts, 0.05, 0.5, 10**6, mode)
        for (x, y), (outcome, pts) in zip(starts[:-1], walks):
            ref = path.compute_path(u, locked, x, y, 0.05, 0.5, 10**6, mode, impl="numpy")
            assert outcome == reference.OK and np.array_equal(ref, pts)
            assert tuple(np.floor(pts[-1] + np.float32(0.5)).astype(int)) == goal
            assert reference.step_gap(u, locked, (x, y), pts, 0.05, 0.5, 10**6, mode) == 0.0
        assert walks[-1][0] == reference.LOCATION


def test_step_gap_reads_a_broken_walk():
    u, locked, _, cells = crop_field()
    start = cells[0]
    (outcome, pts), = reference.walk(u, locked, [start], 0.05, 0.5, 10**6)
    assert outcome == reference.OK and len(pts) > 10
    args = (0.05, 0.5, 10**6)
    moved = pts.copy()
    moved[len(pts) // 2, 0] += 0.01
    assert reference.step_gap(u, locked, start, moved, *args) == pytest.approx(0.01, rel=0.1)
    assert reference.step_gap(u, locked, start, pts[:-3], *args) == math.inf
    assert reference.step_gap(u, locked, (start[0] + 0.5, start[1]), pts, *args) == math.inf
    assert reference.step_gap(u, locked, start, pts[:2], *args) == math.inf


def test_bfloat16_solve_runs_and_differs():
    with np.load("benchmark/data/maze_demo.npz") as data:
        obstacle = data["img"][100:132, 100:132] == 0
    u32, locked = lanes(obstacle, [(10, 10)])
    u16 = u32.to(torch.bfloat16)
    u32, s32, _ = reference.solve(u32, locked, 1e-3, 100)
    u16, s16, _ = reference.solve(u16, locked, 1e-3, 100, max_iterations=20_000)
    assert u16.dtype == torch.bfloat16
    free = ~locked[0]
    gap = ((u16[0].float() - u32[0]).abs() / u32[0].abs().clamp(min=1))[free].max()
    assert float(gap) > 0.01
