"""epic_tpu_torch's 3D volume path against epic_tpu: the volume constructors
and voxel edits bit for bit, and the plain 3D solver against the XLA core and
the Pallas kernel it stands in for (pallas_sweep3d, K7, in interpret mode as
the JAX package's own CPU tests run it), on the shapes of
tests/test_pallas3d.py, plus the reference binary's fuzz3d golden.

Tolerances: fields rtol=2e-6, atol=1e-3, deltas rtol=1e-5, atol=1e-5 (the
2D rule of tests/test_torch_solver.py: the two packages' CPU exp differ by
an ulp). Iteration counts equal. The golden's rules are
tests/test_goldens.py's. On the card the kernels must give the plain
version's bits exactly: tests/test_torch_cuda.py.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epic_tpu import grid as JG
from epic_tpu.solver import core as jcore
from epic_tpu.solver import pallas_sweep3d
import epic_tpu_torch.solver as TS
from epic_tpu_torch import constants as C
from epic_tpu_torch import grid as TG
from epic_tpu_torch.solver import core, hopper_sweep, hopper_sweep3d

GOLDENS = pathlib.Path(__file__).parent / "goldens"
FIELDS = ("u", "locked", "iteration", "delta", "converged", "epsilon")
FIELD = dict(rtol=2e-6, atol=1e-3)
DELTA = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and torch's default of one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_same_state(jax_state, torch_state):
    """All six fields, same dtype and the same bits."""
    ours = TG.state_to_numpy(torch_state)
    theirs = TG.state_to_numpy(jax_state)
    for f in FIELDS:
        assert ours[f].dtype == theirs[f].dtype, f
        np.testing.assert_array_equal(ours[f], theirs[f], err_msg=f)


def _volume(d, h, w, density=0.0, seed=0):
    """Boundary-locked volume with one goal voxel and optional random
    obstacles, as tests/test_pallas3d.py builds them."""
    rng = np.random.default_rng(seed)
    u = np.full((d, h, w), -1e6, dtype=np.float32)
    locked = np.zeros((d, h, w), dtype=bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    if density:
        locked |= rng.random((d, h, w)) < density
    gz, gy, gx = d // 2, h // 2, w // 2
    u[gz, gy, gx] = 0.0
    locked[gz, gy, gx] = True
    return u, locked


# (shape, density, seed) of tests/test_pallas3d.py.
VOLUMES = {
    "7x9x21": ((7, 9, 21), 0.15, 3),
    "6x8x17": ((6, 8, 17), 0.1, 1),
    "10x12x14": ((10, 12, 14), 0.1, 2),
    "5x9x131": ((5, 9, 131), 0.0, 0),
}


def _states(name, iteration=0, eps=1e-2):
    shape, density, seed = VOLUMES[name]
    u, locked = _volume(*shape, density, seed)
    j = dataclasses.replace(JG.make_state(u, locked, eps), iteration=jnp.int32(iteration))
    return j, TG.state_from_numpy(TG.state_to_numpy(j), device="cpu")


@pytest.mark.parametrize("eps", [1e-2, 1e-3])
def test_empty_volume_matches_jax(eps):
    assert_same_state(JG.empty_volume(6, 7, 9, eps), TG.empty_volume(6, 7, 9, eps, device="cpu"))


def test_from_occupancy_volume_matches_jax():
    rng = np.random.default_rng(4)
    vol = rng.choice(np.array([0, 128, 200, 255], np.uint8), size=(6, 7, 8), p=[.2, .5, .2, .1])
    assert_same_state(JG.from_occupancy_volume(vol, 1e-3),
                      TG.from_occupancy_volume(vol, 1e-3, device="cpu"))
    with pytest.raises(ValueError):
        TG.from_occupancy_volume(vol[0], device="cpu")


@pytest.mark.parametrize("case", ["duplicates", "out_of_bounds", "unknown_types", "empty"])
def test_set_cells_3d_matches_jax(case):
    edits = {
        # Last duplicate wins: obstacle, then goal, then free on one voxel.
        "duplicates": ([(3, 2, 1), (3, 2, 1), (4, 4, 4), (3, 2, 1), (1, 1, 1)],
                       [C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_GOAL, C.CELL_TYPE_GOAL,
                        C.CELL_TYPE_FREE, C.CELL_TYPE_OBSTACLE]),
        "out_of_bounds": ([(8, 1, 1), (1, 7, 1), (1, 1, 6), (-1, 2, 2), (2, 2, 2)],
                          [C.CELL_TYPE_GOAL] * 5),
        "unknown_types": ([(2, 3, 4), (3, 3, 3), (4, 3, 2)], [7, -1, C.CELL_TYPE_GOAL]),
        "empty": (np.zeros((0, 3), np.int64), []),
    }[case]
    rng = np.random.default_rng(1)
    u = rng.uniform(-30, 0, (6, 7, 8)).astype(np.float32)
    locked = rng.random((6, 7, 8)) < 0.2
    j = JG.set_cells_3d(JG.make_state(u, locked, 1e-2), *edits)
    t0 = TG.make_state(u, locked, 1e-2, device="cpu")
    t = TG.set_cells_3d(t0, *edits)
    assert_same_state(j, t)
    if case != "empty":
        np.testing.assert_array_equal(t0.u.numpy(), u)   # the input is left intact
    with pytest.raises(ValueError):
        TG.set_cells_3d(TG.empty_state(5, 5, device="cpu"), [(1, 1, 1)], [0])


def test_volume_round_trip_and_reset_free_cells():
    """A JAX volume state crosses to the port and back with the same bits;
    reset_free_cells keeps the six faces and the locked voxels."""
    j, t = _states("7x9x21", iteration=11)
    j = jcore.update_n(j, 5)
    t = TG.state_from_numpy(TG.state_to_numpy(j), device="cpu")
    assert_same_state(j, t)
    assert tuple(t.u.shape) == (7, 9, 21) and int(t.iteration) == 16
    assert_same_state(JG.reset_free_cells(j), TG.reset_free_cells(t))


@pytest.mark.parametrize("num_steps", [1, 7])
@pytest.mark.parametrize("t0", [0, 7])
@pytest.mark.parametrize("name", list(VOLUMES))
def test_update_n_matches_jax_core_and_k7(name, t0, num_steps):
    j, t = _states(name, t0)
    k7 = pallas_sweep3d.update_n(j, num_steps, interpret=True)
    jc = jcore.update_n(_states(name, t0)[0], num_steps)
    out = core.update_n(t, num_steps)
    for ref in (jc, k7):
        np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), **FIELD)
        np.testing.assert_allclose(float(out.delta), float(ref.delta), **DELTA)
        assert bool(out.converged) == bool(ref.converged)
    assert int(out.iteration) == t0 + num_steps


@pytest.mark.parametrize("name,stagger", [("7x9x21", 100), ("6x8x17", 100),
                                          ("10x12x14", 10), ("5x9x131", 100)])
def test_solve_matches_jax_core_and_k7(name, stagger):
    j, t = _states(name)
    k7 = pallas_sweep3d.solve(j, stagger, interpret=True)
    jc = jcore.solve(_states(name)[0], stagger)
    out = TS.solve_volume(t, stagger)
    assert bool(out.converged)
    assert int(out.iteration) % stagger == 1 % stagger
    assert int(out.iteration) >= max(t.u.shape)
    for ref in (jc, k7):
        assert int(out.iteration) == int(ref.iteration)
        np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), **FIELD)
        np.testing.assert_allclose(float(out.delta), float(ref.delta), **DELTA)


@pytest.mark.parametrize("stagger,cap", [(1, 1_000_000), (7, 1_000_000), (100, 250), (10, 95)])
def test_solve_protocol_matches_jax_core(stagger, cap):
    j, t = _states("7x9x21")
    jc = jcore.solve(j, stagger, cap)
    out = core.solve(t, stagger, cap)
    assert int(out.iteration) == int(jc.iteration)
    assert bool(out.converged) == bool(jc.converged)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(jc.u), **FIELD)
    np.testing.assert_allclose(float(out.delta), float(jc.delta), **DELTA)


@pytest.mark.parametrize("t0", [0, 1])
def test_single_sweep_updates_the_flipped_class(t0):
    """One 3D sweep updates (z + y + x) % 2 == t % 2 only: the other class
    than 2D."""
    rng = np.random.default_rng(t0)
    u, locked = _volume(6, 7, 9, 0.1, 2)
    u = np.where(locked, u, rng.uniform(-30, -1, u.shape)).astype(np.float32)
    st = dataclasses.replace(TG.make_state(u, locked, 1e-2, device="cpu"),
                             iteration=torch.tensor(t0, dtype=torch.int32))
    out = core.update_n(st, 1)
    zz, yy, xx = np.nonzero(out.u.numpy() != u)
    assert len(zz) and np.all((zz + yy + xx) % 2 == t0 % 2)


def test_fuzz3d_golden_through_the_plain_version():
    """tests/test_goldens.py's rules: 60 single sweeps, each delta within
    1e-6 + 1e-4 |d_ref| of the reference binary's, the field within 1e-3."""
    g = np.load(GOLDENS / "fuzz3d_seed0.npz")
    st = TG.make_state(g["u0"], g["locked"], 1e-2, device="cpu")
    for d_ref in g["deltas"]:
        st = TS.update_volume(st, 1)
        assert abs(float(st.delta) - d_ref) <= 1e-6 + 1e-4 * abs(d_ref)
    np.testing.assert_allclose(st.u.numpy(), g["ref_u"], rtol=0, atol=1e-3)


def test_hopper_sweep3d_routes_cpu_volumes_to_the_plain_version():
    _, t = _states("6x8x17", 3)
    before_calls, before_launches = dict(core.calls), dict(hopper_sweep3d.launches)
    a = hopper_sweep3d.update_n(t, 20)
    np.testing.assert_array_equal(a.u.numpy(), core.update_n(t, 20).u.numpy())
    assert int(a.iteration) == 23
    s = hopper_sweep3d.solve(t, 100)
    np.testing.assert_array_equal(s.u.numpy(), core.solve(t, 100).u.numpy())
    assert core.calls["update_n"] == before_calls["update_n"] + 2
    assert core.calls["solve"] == before_calls["solve"] + 2
    assert hopper_sweep3d.launches == before_launches
    with pytest.raises(ValueError):
        hopper_sweep3d.update_n(TG.empty_state(6, 6, device="cpu"), 1)
    with pytest.raises(ValueError):
        hopper_sweep3d.update_n(t, 0)
    with pytest.raises(ValueError):
        hopper_sweep3d.solve(t, stagger=0)


def test_solver_entry_points_route_rank_3():
    """solve_grid/update_grid send a volume to the 3D entries; a grid of
    rank 4 or more goes to the plain core on whatever device holds it (on
    the card too: no kernel exists for it; tests/test_torch_cuda.py)."""
    _, t = _states("6x8x17")
    np.testing.assert_array_equal(TS.update_grid(t, 9).u.numpy(), core.update_n(t, 9).u.numpy())
    s = TS.solve_grid(t)
    assert bool(s.converged) and int(s.iteration) == int(core.solve(t).iteration)
    with pytest.raises(ValueError):
        TS.solve_volume(TG.empty_state(6, 6, device="cpu"))
    st4 = TG.empty_grid_nd((4, 5, 4, 6), 1e-2, device="cpu")
    st4 = TG.make_state(torch.where(st4.locked, st4.u, -1e6).index_put_(
        (torch.tensor(2),) * 3 + (torch.tensor(3),), torch.tensor(0.0)),
        st4.locked.index_put_((torch.tensor(2),) * 3 + (torch.tensor(3),), torch.tensor(True)),
        1e-2, device="cpu")
    calls = dict(core.calls)
    np.testing.assert_array_equal(TS.update_grid(st4, 3).u.numpy(), core.update_n(st4, 3).u.numpy())
    s4, c4 = TS.solve_grid(st4, 10), core.solve(st4, 10)
    np.testing.assert_array_equal(s4.u.numpy(), c4.u.numpy())
    assert int(s4.iteration) == int(c4.iteration)
    assert core.calls["update_n"] == calls["update_n"] + 2
    assert core.calls["solve"] == calls["solve"] + 2
    # The wrappers check the device first: a CPU volume is not a CUDA one.
    with pytest.raises(ValueError):
        hopper_sweep._check_cuda_state(t, 3)
