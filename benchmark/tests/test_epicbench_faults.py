"""The check catches a broken program: a run on the CPU, past the look for a
card, with the timed path broken underneath, comes out not correct; and the
control, the reference in bfloat16, fails the limits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import check, control, harness
from benchmark.tests.epicbench_util import run_cpu, tiny_checkout


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("bench"))


def test_sound_runs_are_correct(checkout):
    for cell in ("tiny.goal_solve", "tiny.fleet64"):
        out = run_cpu(checkout, cell)
        assert out["correct"] and out["checked"] > 0, out["compared"]


def test_solve_returning_its_state_unchanged(checkout, monkeypatch):
    from epic_tpu_torch import solver

    monkeypatch.setattr(solver, "solve_grid", lambda state, *a, **k: state)
    out = run_cpu(checkout, "tiny.goal_solve")
    assert not out["correct"] and out["failed"] == out["attempted"]


def test_field_altered_where_it_is_produced(checkout, monkeypatch):
    from epic_tpu_torch import solver

    solve = solver.solve_grid

    def altered(state, *a, **k):
        out = solve(state, *a, **k)
        free = (~out.locked).nonzero()
        y, x = free[len(free) // 2].tolist()
        out.u[y, x] *= 1.05
        return out

    monkeypatch.setattr(solver, "solve_grid", altered)
    out = run_cpu(checkout, "tiny.goal_solve")
    assert not out["correct"] and out["compared"]["field_gap"]["value"] > check.LIMITS["field_gap"]


def test_path_altered_where_it_is_produced(checkout, monkeypatch):
    from epic_tpu_torch import planner

    walk = planner.compute_path

    def altered(*a, **k):
        pts = walk(*a, **k).copy()
        pts[len(pts) // 2, 1] += 0.02
        return pts

    monkeypatch.setattr(planner, "compute_path", altered)
    out = run_cpu(checkout, "tiny.goal_solve")
    assert not out["correct"] and out["compared"]["path_gap"]["value"] > check.LIMITS["path_gap"]


def test_batch_returning_its_state_unchanged(checkout, monkeypatch):
    from epic_tpu_torch.solver import hopper_batched

    def unchanged(u, locked, epsilon, stagger, max_iterations):
        b = u.shape[0]
        return u, torch.full((b,), max_iterations, dtype=torch.int32), \
            torch.zeros(b), torch.ones(b, dtype=torch.bool)

    monkeypatch.setattr(hopper_batched, "solve_batch_device", unchanged)
    out = run_cpu(checkout, "tiny.fleet64")
    assert not out["correct"]


def test_half_the_batch_left_out(checkout, monkeypatch):
    from epic_tpu_torch.solver import hopper_batched

    solve = hopper_batched.solve_batch_device

    def half(u, locked, epsilon, stagger, max_iterations):
        b = u.shape[0] // 2
        u1, it, d, c = solve(u[:b].clone(), locked[:b].clone(), epsilon, stagger,
                             max_iterations)
        u[:b] = u1
        # The rest is reported as the mean of the solved half.
        return (u, torch.cat([it, it.float().mean().int().repeat(u.shape[0] - b)]),
                torch.cat([d, d.mean().repeat(u.shape[0] - b)]),
                torch.cat([c, c.all().repeat(u.shape[0] - b)]))

    monkeypatch.setattr(hopper_batched, "solve_batch_device", half)
    out = run_cpu(checkout, "tiny.fleet64")
    assert not out["correct"]


def test_one_lane_reported_unconverged(checkout, monkeypatch):
    """A lane whose field is sound but that did not converge fails its
    request; the compared sample cannot see it, ``failed`` does."""
    from epic_tpu_torch.solver import hopper_batched

    solve = hopper_batched.solve_batch_device
    calls = []

    def one_lane(u, locked, epsilon, stagger, max_iterations):
        u1, it, d, c = solve(u, locked, epsilon, stagger, max_iterations)
        calls.append(1)
        if len(calls) == 2:     # the window's first batch
            c = c.clone()
            c[1] = False
        return u1, it, d, c

    monkeypatch.setattr(hopper_batched, "solve_batch_device", one_lane)
    out = run_cpu(checkout, "tiny.fleet64")
    assert out["failed"] == 1 and out["attempted"] > 4
    assert all(v["value"] <= v["limit"] for v in out["compared"].values())
    assert not out["correct"]


def test_lane_path_altered_where_it_is_produced(checkout, monkeypatch):
    from epic_tpu_torch import path

    walk = path.compute_path

    def altered(*a, **k):
        pts = walk(*a, **k).copy()
        pts[-2, 0] += 0.02
        return pts

    monkeypatch.setattr(path, "compute_path", altered)
    out = run_cpu(checkout, "tiny.fleet64")
    assert not out["correct"]


@pytest.mark.parametrize("cell", ["tiny.goal_solve", "tiny.fleet64"])
def test_bfloat16_control_fails(checkout, cell):
    torch.set_num_threads(1)
    for seed in (1, 2, 3):
        out = control.control_numbers(harness.Catalog(checkout), cell, seed,
                                      torch.device("cpu"), cap=5000)
        assert out["fails"], out
        assert np.isfinite(out["numbers"]["field_gap"])
