"""epic_tpu_torch.grid against epic_tpu.grid: constructors, edits and the
NumPy bridge, bit for bit, plus the set_cells golden. Inputs come from
NumPy seeds and goldens and go to both packages."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from epic_tpu import grid as JG
from epic_tpu import maps
from epic_tpu_torch import constants as C
from epic_tpu_torch import grid as TG

GOLDENS = pathlib.Path(__file__).parent / "goldens"
FIELDS = ("u", "locked", "iteration", "delta", "converged", "epsilon")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and torch's default of one OpenMP thread per core oversubscribes them
    (spin-waiting threads slowed this file about 30-fold)."""
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
    assert torch_state.iteration.dtype == torch.int32
    assert torch_state.iteration.ndim == 0 and torch_state.epsilon.ndim == 0


@pytest.mark.parametrize("eps", [1e-2, 1e-3])
def test_from_occupancy_image_matches_jax(eps):
    img = maps.random_obstacles(24, 40, density=0.2, seed=3)
    assert_same_state(JG.from_occupancy_image(img, eps),
                      TG.from_occupancy_image(img, eps, device="cpu"))


def test_empty_state_matches_jax():
    assert_same_state(JG.empty_state(17, 23, 1e-3), TG.empty_state(17, 23, 1e-3, device="cpu"))


def test_make_state_copies_and_validates():
    rng = np.random.default_rng(5)
    u = rng.normal(size=(9, 11)).astype(np.float32)
    locked = rng.random((9, 11)) < 0.3
    st = TG.make_state(u, locked, 1e-2, device="cpu")
    assert_same_state(JG.make_state(u, locked, 1e-2), st)
    u[0, 0] = 123.0  # the state holds a copy, not a view of the caller's array
    assert float(st.u[0, 0]) != 123.0
    with pytest.raises(ValueError):
        TG.make_state(u, locked, 0.0, device="cpu")
    with pytest.raises(ValueError):
        TG.make_state(u, locked[:, :5], 1e-2, device="cpu")
    with pytest.raises(ValueError):
        TG.make_state(u[0], locked[0], 1e-2, device="cpu")


def test_set_cells_matches_golden():
    """Duplicate-coordinate SetCells batch: sequential last-wins parity with
    the reference binary (goldens/set_cells.npz)."""
    g = np.load(GOLDENS / "set_cells.npz")
    st = TG.make_state(g["u0"], g["locked"], 1e-2, device="cpu")
    out = TG.set_cells(st, g["xy"], g["types"])
    np.testing.assert_array_equal(out.u.numpy(), g["ref_u"])
    np.testing.assert_array_equal(out.locked.numpy().astype(np.uint32), g["ref_locked"])
    # The input state is untouched.
    np.testing.assert_array_equal(st.u.numpy(), g["u0"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_set_cells_matches_jax(seed):
    """Random batches with out-of-bounds coordinates, unknown types and
    duplicates: same skip-invalid, last-wins result as epic_tpu."""
    rng = np.random.default_rng(seed)
    img = maps.random_obstacles(20, 30, density=0.2, seed=seed)
    xy = np.stack([rng.integers(-3, 33, 60), rng.integers(-3, 23, 60)], axis=1)
    xy[30:40] = xy[:10]  # duplicates
    types = rng.integers(-1, 4, 60)
    j = JG.set_cells(JG.from_occupancy_image(img, 1e-2), xy, types)
    t = TG.set_cells(TG.from_occupancy_image(img, 1e-2, device="cpu"), xy, types)
    assert_same_state(j, t)
    assert not bool(t.converged)


def test_set_cells_empty_batch_returns_state():
    st = TG.empty_state(8, 8, device="cpu")
    assert TG.set_cells(st, [(-1, 2)], [C.CELL_TYPE_GOAL]) is st


def test_reset_free_cells_matches_jax():
    rng = np.random.default_rng(4)
    img = maps.random_obstacles(18, 26, density=0.2, seed=4)
    u = np.where(img == 255, 0.0, rng.uniform(-50, -1, img.shape)).astype(np.float32)
    locked = (img == 0) | (img == 255)
    j = JG.reset_free_cells(JG.make_state(u, locked, 1e-2))
    t = TG.reset_free_cells(TG.make_state(u, locked, 1e-2, device="cpu"))
    assert_same_state(j, t)


def test_numpy_bridge_round_trips_jax_states():
    """A JAX GridState crosses to torch and back with the same bits."""
    rng = np.random.default_rng(9)
    u = rng.normal(size=(12, 15)).astype(np.float32)
    locked = rng.random((12, 15)) < 0.25
    import dataclasses

    import jax.numpy as jnp

    js = dataclasses.replace(JG.make_state(u, locked, 1e-3), iteration=jnp.int32(301),
                             delta=jnp.float32(0.25), converged=jnp.asarray(True))
    ts = TG.state_from_numpy(TG.state_to_numpy(js), device="cpu")
    assert_same_state(js, ts)
    back = TG.state_to_numpy(TG.state_from_numpy(TG.state_to_numpy(ts), device="cpu"))
    for f in FIELDS:
        np.testing.assert_array_equal(back[f], TG.state_to_numpy(js)[f])
    bad = TG.state_to_numpy(ts)
    bad["delta"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError):
        TG.state_from_numpy(bad, device="cpu")


def test_cell_queries_match_jax():
    img = maps.random_obstacles(16, 21, density=0.25, seed=2)
    j = JG.from_occupancy_image(img, 1e-2)
    t = TG.from_occupancy_image(img, 1e-2, device="cpu")
    for y in range(-1, 17):
        for x in range(-1, 22):
            assert TG.is_cell_obstacle(t, x, y) == JG.is_cell_obstacle(j, x, y)
            assert TG.is_cell_goal(t, x, y) == JG.is_cell_goal(j, x, y)
    np.testing.assert_array_equal(TG.host_u(t), JG.host_u(j))
    np.testing.assert_array_equal(TG.host_locked(t), JG.host_locked(j))


def test_sanitize_cell_edits_matches_jax():
    rng = np.random.default_rng(11)
    xy = np.stack([rng.integers(-2, 12, 40), rng.integers(-2, 9, 40)], axis=1)
    types = rng.integers(-1, 4, 40)
    for a, b in zip(TG.sanitize_cell_edits(xy, types, 10, 7),
                    JG.sanitize_cell_edits(xy, types, 10, 7)):
        np.testing.assert_array_equal(a, b)


def test_type_lookup_arrays_hold_the_dicts_values():
    """The indexed lookups of the 3D ingest give each type constant the
    value and lock of the type maps, and nothing else is a type."""
    assert sorted(TG._TYPE_TO_U) == list(range(len(TG._U_OF_TYPE)))
    for t in (C.CELL_TYPE_GOAL, C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_FREE):
        assert TG._U_OF_TYPE[t] == np.float32(TG._TYPE_TO_U[t])
        assert bool(TG._LOCKED_OF_TYPE[t]) is TG._TYPE_TO_LOCKED[t]
    assert TG._U_OF_TYPE.dtype == np.float32 and TG._LOCKED_OF_TYPE.dtype == bool


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sanitize_cell_edits_3d_matches_the_dicts_and_jax(seed):
    """Random 3D edits, out of bounds, unknown types and duplicates among
    them: the same voxels, values and locks as the per-voxel dict lookups
    and as epic_tpu's."""
    rng = np.random.default_rng(seed)
    n = 400
    xyz = np.stack([rng.integers(-2, 12, n), rng.integers(-2, 9, n), rng.integers(-2, 7, n)],
                   axis=1)
    types = rng.integers(-1, 4, n)
    ours = TG.sanitize_cell_edits_3d(xyz, types, 10, 7, 5)
    kept = ours[0]
    assert 0 < len(kept) < n
    # The dicts, voxel by voxel, on the kept edits' types (last wins).
    last = {}
    for (x, y, z), t in zip(xyz.tolist(), types.tolist()):
        if 0 <= x < 10 and 0 <= y < 7 and 0 <= z < 5 and t in TG._TYPE_TO_U:
            last[(x, y, z)] = t
    want_t = [last[tuple(v)] for v in kept.tolist()]
    np.testing.assert_array_equal(
        ours[1], np.array([TG._TYPE_TO_U[t] for t in want_t], dtype=np.float32))
    np.testing.assert_array_equal(
        ours[2], np.array([TG._TYPE_TO_LOCKED[t] for t in want_t], dtype=bool))
    assert ours[1].dtype == np.float32 and ours[2].dtype == bool
    for a, b in zip(ours, JG.sanitize_cell_edits_3d(xyz, types, 10, 7, 5)):
        np.testing.assert_array_equal(a, b)
    empty = TG.sanitize_cell_edits_3d(np.zeros((0, 3), int), [], 10, 7, 5)
    assert [len(a) for a in empty] == [0, 0, 0]
    assert empty[1].dtype == np.float32 and empty[2].dtype == bool


def test_import_leaves_jax_out():
    """The port imports torch and NumPy, never JAX or epic_tpu."""
    code = ("import sys, epic_tpu_torch, epic_tpu_torch.services.server, "
            "epic_tpu_torch.solver.hopper_sweep; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'epic_tpu.'))"
            " or m == 'epic_tpu']; assert not bad, bad")
    root = pathlib.Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
