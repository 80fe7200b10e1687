"""Grids of any rank on the port: ``grid.empty_grid_nd``, the plain core's
sweeps and solve at rank 4 and 5 (the route ``solver.solve_grid`` takes for
them on every device), and ``path_nd``. The cases of tests/test_nd.py and
tests/test_path_nd.py, at their sizes, held to epic_tpu (its XLA core and
path_nd) and to the NumPy oracle."""

import numpy as np
import pytest
import torch

import epic_tpu
import jax.numpy as jnp
from epic_tpu import path_nd as jpath_nd
from epic_tpu.solver import core as jcore
import epic_tpu_torch as T
import epic_tpu_torch.solver as TS
from epic_tpu_torch import path3d, path_nd
from epic_tpu_torch.errors import InvalidGradientError, InvalidLocationError, InvalidPathError
from epic_tpu_torch.solver import core, reference_np

FIELD = dict(rtol=2e-6, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_grid(shape, density=0.15, seed=0):
    rng = np.random.default_rng(seed)
    u = np.full(shape, -1e6, dtype=np.float32)
    shell = np.ones(shape, dtype=bool)
    shell[(slice(1, -1),) * len(shape)] = False
    locked = shell | (rng.random(shape) < density)
    goal = tuple(s // 2 for s in shape)
    u[goal] = 0.0
    locked[goal] = True
    return u, locked


def _with_goal(shape, goal, eps):
    """empty_grid_nd's shell, a cold interior and one locked goal."""
    st = T.empty_grid_nd(shape, eps, device="cpu")
    u = st.u.numpy().copy()
    locked = st.locked.numpy().copy()
    u[(slice(1, -1),) * len(shape)] = -1e6
    u[goal] = 0.0
    locked[goal] = True
    return u, locked


def test_empty_grid_nd_matches_epic_tpu():
    for shape in ((5, 5, 6, 7), (3, 4, 3), (6, 5)):
        a = T.empty_grid_nd(shape, 1e-2, device="cpu")
        b = epic_tpu.empty_grid_nd(shape, 1e-2)
        np.testing.assert_array_equal(a.u.numpy(), np.asarray(b.u))
        np.testing.assert_array_equal(a.locked.numpy(), np.asarray(b.locked))
        assert float(a.epsilon) == float(b.epsilon) and int(a.iteration) == 0
    with pytest.raises(ValueError):
        T.empty_grid_nd((5,), device="cpu")
    with pytest.raises(ValueError):
        T.empty_grid_nd((5, 2, 5), device="cpu")


@pytest.mark.parametrize("shape", [(6, 7, 6, 8), (5, 5, 6, 5, 7)])
def test_core_sweep_matches_nd_oracle(shape):
    u, locked = _random_grid(shape, seed=2)
    ut, lt = torch.from_numpy(u), torch.from_numpy(locked)
    cur = u.copy()
    for t in range(4):
        ut, dt = core.sweep(ut, lt, t)
        cur, dn = reference_np.sweep_nd(cur, locked, t)
        np.testing.assert_allclose(ut.numpy(), cur, atol=2e-6)
        assert float(dt) == pytest.approx(float(dn), abs=1e-5)


def test_core_sweep_matches_epic_tpu_4d():
    u, locked = _random_grid((6, 8, 7, 9), seed=3)
    ut, lt = torch.from_numpy(u), torch.from_numpy(locked)
    uj, lj = jnp.asarray(u), jnp.asarray(locked)
    for t in range(6):
        ut, dt = core.sweep(ut, lt, t)
        uj, dj = jcore.sweep(uj, lj, jnp.int32(t))
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=2e-6)
        assert float(dt) == pytest.approx(float(dj), abs=1e-5)


def test_solve_protocol_4d_matches_oracle_and_epic_tpu():
    """The whole protocol on a 4D hypergrid through solver.solve_grid (the
    plain core at rank 4): iterations equal the oracle's and epic_tpu's."""
    u, locked = _with_goal((5, 6, 6, 7), (2, 3, 3, 3), 1e-2)
    solved = TS.solve_grid(T.make_state(u, locked, 1e-2, device="cpu"), 10)
    u_ref, iters_ref, delta_ref = reference_np.solve(u, locked, epsilon=1e-2, stagger=10)
    jsolved = jcore.solve(epic_tpu.make_state(u, locked, epsilon=1e-2), stagger=10)
    assert int(solved.iteration) == iters_ref == int(jsolved.iteration)
    assert iters_ref % 10 == 1 and bool(solved.converged)
    np.testing.assert_allclose(solved.u.numpy(), u_ref, atol=5e-6)
    np.testing.assert_allclose(solved.u.numpy(), np.asarray(jsolved.u), **FIELD)
    assert float(solved.delta) == pytest.approx(float(delta_ref), abs=1e-6)


def test_update_grid_4d():
    u, locked = _with_goal((5, 5, 6, 7), (2, 2, 3, 3), 1e-2)
    st = T.make_state(u, locked, 1e-2, device="cpu")
    out = TS.update_grid(st, 5)
    ref = jcore.update_n(epic_tpu.make_state(u, locked, epsilon=1e-2), 5)
    assert int(out.iteration) == 5 and float(out.delta) > 0.0
    assert float(out.u[2, 2, 3, 4]) > -1e6
    np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), **FIELD)


def test_make_state_rejects_rank1():
    with pytest.raises(ValueError):
        T.make_state(np.zeros(5, np.float32), np.zeros(5, bool), 1e-2, device="cpu")


def _solved_volume():
    u, locked = _with_goal((10, 14, 18), (5, 7, 9), 1e-3)
    out = core.solve(T.make_state(u, locked, 1e-3, device="cpu"))
    return out.u.numpy(), out.locked.numpy()


def test_nd_walker_matches_trilinear_walker_in_3d():
    """On a volume the rank-generic walker tracks path3d ((z, y, x) against
    (x, y, z)), and equals epic_tpu's path_nd point for point."""
    u, locked = _solved_volume()
    p3 = path3d.compute_path(u, locked, 2.0, 3.0, 2.0, step_size=0.2, cd_precision=0.4)
    pn = path_nd.compute_path(u, locked, (2.0, 3.0, 2.0), step_size=0.2, cd_precision=0.4)
    assert len(p3) == len(pn)
    np.testing.assert_allclose(pn[:, ::-1], p3, atol=1e-5)
    assert path_nd.path_reaches_goal(u, locked, pn)
    np.testing.assert_array_equal(
        pn, jpath_nd.compute_path(u, locked, (2.0, 3.0, 2.0), step_size=0.2, cd_precision=0.4))
    pot3 = path3d.compute_potential(u, locked, 4.2, 5.1, 3.3)
    assert path_nd.compute_potential(u, locked, (3.3, 5.1, 4.2)) == pytest.approx(pot3, abs=1e-6)
    g3 = path3d.compute_gradient(u, locked, 4.2, 5.1, 3.3, 0.4)
    gn = path_nd.compute_gradient(u, locked, (3.3, 5.1, 4.2), 0.4)
    np.testing.assert_allclose(gn[::-1], g3, atol=1e-6)


def test_nd_walker_4d_end_to_end():
    """4D: solve a hypergrid through solver.solve_grid and walk from a corner
    to the goal; the same walk as epic_tpu's path_nd on the same field."""
    u, locked = _with_goal((7, 8, 9, 10), (3, 4, 4, 5), 1e-3)
    out = TS.solve_grid(T.make_state(u, locked, 1e-3, device="cpu"))
    assert bool(out.converged)
    uu, ll = out.u.numpy(), out.locked.numpy()
    p = path_nd.compute_path(uu, ll, (1.5, 1.5, 1.5, 1.5), step_size=0.2, cd_precision=0.4)
    assert path_nd.path_reaches_goal(uu, ll, p)
    np.testing.assert_array_equal(
        p, jpath_nd.compute_path(uu, ll, (1.5, 1.5, 1.5, 1.5), step_size=0.2, cd_precision=0.4))


def test_nd_walker_contracts():
    u, locked = _solved_volume()
    with pytest.raises(InvalidLocationError):
        path_nd.compute_path(u, locked, (-3.0, 1.0, 1.0))
    with pytest.raises(InvalidLocationError):
        path_nd.compute_path(u, locked, (0.0, 0.0, 0.0))   # boundary obstacle
    st = T.empty_grid_nd((6, 6, 6), 1e-2, device="cpu")
    uu, ll = st.u.numpy().copy(), st.locked.numpy().copy()
    uu[3, 3, 3] = 0.0
    ll[3, 3, 3] = True
    with pytest.raises((InvalidPathError, InvalidGradientError)):
        path_nd.compute_path(uu, ll, (1.2, 1.2, 1.2))
    with pytest.raises(ValueError):
        path_nd.compute_path(u, locked, (1.0, 1.0))
