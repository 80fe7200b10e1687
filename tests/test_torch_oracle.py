"""The port's NumPy oracle (epic_tpu_torch.solver.reference_np, exported as
``solver_oracle``) and host-driven solve (``core.solve_py``): the oracle
against epic_tpu's bit for bit, the port's core against the oracle with
tests/test_oracle.py's tolerances, and solve_py against core.solve bit for
bit, with its sweep hook."""

import numpy as np
import pytest
import torch

import epic_tpu_torch as T
from epic_tpu import maps
from epic_tpu.solver import reference_np as jref
from epic_tpu_torch.grid import make_state
from epic_tpu_torch.solver import core, reference_np


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ingest(img):
    goal = img == 255
    u = np.where(goal, 0.0, -1e6).astype(np.float32)
    return u, goal | (img == 0)


def _state(u, locked, eps):
    return make_state(u, locked, eps, device="cpu")


@pytest.fixture(scope="module")
def small_map():
    return _ingest(maps.random_obstacles(24, 20, density=0.2, seed=3))


def test_exported_as_solver_oracle():
    assert T.solver_oracle is reference_np


@pytest.mark.parametrize("fn", ["sweep_scalar", "sweep", "sweep_nd", "sweep_scalar_nd"])
def test_oracle_sweeps_match_epic_tpu(small_map, fn):
    u, locked = small_map
    a = b = u
    for it in range(4):
        a, da = getattr(reference_np, fn)(a, locked, it)
        b, db = getattr(jref, fn)(b, locked, it)
        np.testing.assert_array_equal(a, b)
        assert float(da) == float(db)


def test_oracle_3d_and_solve_match_epic_tpu():
    rng = np.random.default_rng(0)
    u = (rng.normal(size=(8, 9, 10)) * 5 - 10).astype(np.float32)
    locked = rng.random((8, 9, 10)) < 0.2
    a, da = reference_np.sweep_3d(u, locked, 1)
    b, db = jref.sweep_3d(u, locked, 1)
    np.testing.assert_array_equal(a, b)
    assert float(da) == float(db)
    u, locked = _ingest(maps.random_obstacles(20, 18, density=0.15, seed=1))
    ra = reference_np.solve(u, locked, epsilon=1e-2, stagger=10)
    rb = jref.solve(u, locked, epsilon=1e-2, stagger=10)
    np.testing.assert_array_equal(ra[0], rb[0])
    assert ra[1:] == rb[1:]


def test_scalar_vs_vectorized_sweep(small_map):
    u, locked = small_map
    for it in range(6):
        u_s, d_s = reference_np.sweep_scalar(u, locked, it)
        u_v, d_v = reference_np.sweep(u, locked, it)
        np.testing.assert_array_equal(u_s, u_v)
        assert d_s == d_v
        u = u_v


def test_torch_sweep_matches_oracle(small_map):
    u, locked = small_map
    ut, lt = torch.from_numpy(u), torch.from_numpy(locked)
    for it in range(4):
        u_np, d_np = reference_np.sweep(ut.numpy(), locked, it)
        ut, dt = core.sweep(ut, lt, it)
        np.testing.assert_allclose(ut.numpy(), u_np, rtol=2e-6, atol=1e-4)
        np.testing.assert_allclose(float(dt), d_np, rtol=1e-6, atol=0)


def test_solve_matches_oracle_iterations_and_field():
    """Iterations by tests/test_torch_solver.py's stagger rule (torch's and
    NumPy's exp differ by an ulp on some inputs, so a threshold-marginal
    check may pass a cycle apart); the field against the oracle run to the
    same iteration."""
    u, locked = _ingest(maps.random_obstacles(20, 18, density=0.15, seed=1))
    u_ref, iters_ref, delta_ref = reference_np.solve(u, locked, epsilon=1e-2, stagger=10)
    out = core.solve(_state(u, locked, 1e-2), stagger=10)
    iters = int(out.iteration)
    assert iters % 10 == 1 and iters_ref % 10 == 1 and bool(out.converged)
    if iters != iters_ref:
        assert abs(float(out.delta) - 1e-2) <= 5e-4 or abs(float(delta_ref) - 1e-2) <= 5e-4
        u_ref, _, delta_ref = reference_np.solve(u, locked, epsilon=1e-2, stagger=10,
                                                 max_iterations=iters)
    np.testing.assert_allclose(out.u.numpy(), u_ref, rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(float(out.delta), delta_ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("stagger,eps", [(10, 1e-2), (1, 1e-2), (100, 1e-3)])
def test_solve_py_matches_solve(stagger, eps):
    """solve_py (host-driven, the delta read at every check) has solve's
    bits, iterations, delta and verdict."""
    u, locked = _ingest(maps.recursive_maze(32, 32, seed=2))
    a = core.solve(_state(u, locked, eps), stagger=stagger)
    b = core.solve_py(_state(u, locked, eps), stagger=stagger)
    assert torch.equal(a.u, b.u)
    assert int(a.iteration) == int(b.iteration)
    assert float(a.delta) == float(b.delta)
    assert bool(a.converged) == bool(b.converged)
    assert b.iteration.dtype == torch.int32 and b.delta.dtype == torch.float32


def test_solve_py_cap_and_sweep_hook():
    """max_iterations caps solve_py as it caps solve; sweep_fn does every
    checked sweep (here the NumPy oracle's, watched)."""
    u, locked = _ingest(maps.random_obstacles(24, 24, density=0.1, seed=5))
    capped = core.solve_py(_state(u, locked, 1e-6), stagger=10, max_iterations=35)
    ref = core.solve(_state(u, locked, 1e-6), stagger=10, max_iterations=35)
    assert int(capped.iteration) == int(ref.iteration) == 40 and not bool(capped.converged)
    assert torch.equal(capped.u, ref.u)
    seen = []

    def oracle_sweep(ut, lt, it):
        seen.append(it)
        u_new, d = reference_np.sweep(ut.numpy(), lt.numpy(), it)
        return torch.from_numpy(u_new), torch.tensor(d)

    out = core.solve_py(_state(u, locked, 1e-2), stagger=10, sweep_fn=oracle_sweep)
    assert seen == list(range(0, int(out.iteration), 10))
    u_ref, iters_ref, _ = reference_np.solve(u, locked, epsilon=1e-2, stagger=10)
    assert int(out.iteration) == iters_ref
    np.testing.assert_allclose(out.u.numpy(), u_ref, rtol=2e-6, atol=1e-3)


def test_huge_epsilon_still_respects_propagation_guard():
    u, locked = _ingest(maps.open_room(16, 24))
    for solve in (core.solve, core.solve_py):
        out = solve(_state(u, locked, 1e9), stagger=10)
        assert int(out.iteration) == 31 and bool(out.converged)
