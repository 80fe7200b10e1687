"""The port's legacy SOR twins (epic_tpu_torch.solver.legacy) against
epic_tpu's on the CPU: tests/test_legacy.py's cases on the port, the NumPy
SOR and the legacy walker held to epic_tpu's bit for bit, the torch
red-black SOR to epic_tpu's sor_red_black_jax and to the row-major oracle
(atol 1e-4, tests/test_legacy.py's tolerance), and the goldens of
tests/goldens/legacy.npz."""

import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epic_tpu_torch as T
from epic_tpu import maps
from epic_tpu.solver import legacy as jlegacy
from epic_tpu_torch import analysis
from epic_tpu_torch.errors import InvalidLocationError
from epic_tpu_torch.solver import core, legacy

GOLDENS = pathlib.Path(__file__).parent / "goldens"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_from_image_conventions():
    img = maps.open_room(8, 8, goal=(4, 4))
    u, locked = legacy.from_image(img)
    assert u[4, 4] == 0.0 and locked[4, 4]
    assert u[2, 2] == 1.0 and not locked[2, 2]
    assert u[0, 0] == 1.0 and locked[0, 0]
    uf, _ = legacy.from_image(img, flipped=True)
    assert uf[4, 4] == 1.0 and uf[2, 2] == 0.0
    for flipped in (False, True):
        for dtype in (np.float32, np.float64):
            a, la = legacy.from_image(img, flipped, dtype)
            b, lb = jlegacy.from_image(img, flipped, dtype)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(la, lb)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sor_numpy_matches_epic_tpu(dtype):
    img = maps.random_obstacles(16, 14, density=0.15, seed=4)
    u, locked = legacy.from_image(img, dtype=dtype)
    a, ia = legacy.sor_numpy(u, locked, epsilon=1e-5, min_iterations=50, max_iterations=400)
    b, ib = jlegacy.sor_numpy(u, locked, epsilon=1e-5, min_iterations=50, max_iterations=400)
    assert ia == ib
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_red_black_matches_epic_tpu(dtype):
    """The torch red-black SOR against sor_red_black_jax: the same iteration
    count, fields within 1e-4 (XLA may fuse multiply-adds)."""
    img = maps.open_room(24, 24)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    u, locked = legacy.from_image(img, dtype=np_dtype)
    ut, it, delta = legacy.sor_red_black(torch.from_numpy(u.copy()), torch.from_numpy(locked),
                                         1e-6, min_iterations=200, max_iterations=600)
    uj, itj, dj = jlegacy.sor_red_black_jax(jnp.asarray(u), jnp.asarray(locked), 1e-6,
                                            min_iterations=200, max_iterations=600)
    assert ut.dtype == dtype
    assert it == int(itj)
    np.testing.assert_allclose(ut.numpy(), np.asarray(uj), atol=1e-4)
    np.testing.assert_allclose(float(delta), float(dj), atol=1e-4)


def test_red_black_reaches_same_fixed_point():
    img = maps.open_room(24, 24)
    u, locked = legacy.from_image(img, dtype=np.float32)
    u_ref, _ = legacy.sor_numpy(u.copy(), locked, epsilon=1e-6, min_iterations=2000,
                                max_iterations=4000)
    u_t, _, _ = legacy.sor_red_black(torch.from_numpy(u), torch.from_numpy(locked), 1e-6,
                                     min_iterations=2000, max_iterations=4000)
    np.testing.assert_allclose(u_t.numpy(), u_ref, atol=1e-4)


def test_red_black_loop_condition():
    """(delta >= eps or it < min_iterations) and it < max_iterations: a loose
    epsilon still runs min_iterations; the cap ends the loop; arrays are
    taken (on the CPU) as well as tensors."""
    img = maps.open_room(16, 16)
    u, locked = legacy.from_image(img, dtype=np.float64)
    _, it, delta = legacy.sor_red_black(u, locked, 10.0, min_iterations=7)
    assert it == 7 and float(delta) < 10.0
    _, it, _ = legacy.sor_red_black(u, locked, 1e-30, min_iterations=3, max_iterations=11)
    assert it == 11
    _, it, delta = legacy.sor_red_black(u, locked, 1e-8, min_iterations=0, max_iterations=0)
    assert it == 0 and float(delta) == pytest.approx(1.0 + 1e-8)


@pytest.mark.parametrize("flipped", [False, True])
def test_legacy_path_matches_epic_tpu(flipped):
    img = maps.open_room(32, 32, goal=(24, 16))
    u, locked = legacy.from_image(img, flipped=flipped)
    u_solved, _ = legacy.sor(u, locked, epsilon=1e-6, min_iterations=3000)
    pts = legacy.compute_path(u_solved, locked, 5.0, 5.0, 0.2, 0.4, flipped=flipped,
                              mode="bilinear")
    ex, ey = pts[-1]
    assert abs(ex - 24) < 2 and abs(ey - 16) < 2
    jpts = jlegacy.compute_path(u_solved, locked, 5.0, 5.0, 0.2, 0.4, flipped=flipped,
                                mode="bilinear")
    np.testing.assert_array_equal(pts, jpts)
    for x, y in ((7.3, 20.1), (12.6, 3.4)):
        for mode in ("reference", "bilinear"):
            assert legacy.compute_potential(u_solved, locked, x, y, mode) == \
                jlegacy.compute_potential(u_solved, locked, x, y, mode)
            assert legacy.compute_gradient(u_solved, locked, x, y, 0.4, mode) == \
                jlegacy.compute_gradient(u_solved, locked, x, y, 0.4, mode)


def test_legacy_path_start_in_obstacle_rejected():
    img = maps.open_room(16, 16)
    u, locked = legacy.from_image(img)
    with pytest.raises(InvalidLocationError):
        legacy.compute_path(u, locked, 0.0, 0.0)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_legacy_sor_matches_golden(dtype):
    """tests/goldens/legacy.npz, the reference binary's legacy SOR, by
    tests/test_goldens.py's rules, through the port's sor (the native
    library, as epic_tpu's sor when built)."""
    g = np.load(GOLDENS / "legacy.npz")
    key = "f32" if dtype == np.float32 else "f64"
    ours, it_ours = legacy.sor(np.array(g["u0"], dtype=dtype), g["locked"].astype(bool),
                               epsilon=1e-4, omega=1.5, min_iterations=10000, dtype=dtype)
    assert it_ours == int(g[f"iters_{key}"])
    atol = 2e-4 if dtype == np.float32 else 1e-10
    np.testing.assert_allclose(ours, g[f"u_{key}"], rtol=0, atol=atol)


def test_legacy_paths_match_golden():
    g = np.load(GOLDENS / "legacy.npz")
    locked = g["locked"].astype(bool)
    compared, off = 0, 0
    for (x, y), n in zip(g["starts"], g["path_lens"]):
        ref_path = g["paths_concat"][off:off + int(n)]
        off += int(n)
        if n == 0:
            continue
        ours = legacy.compute_path(g["u_f64"], locked, float(x), float(y), step_size=0.2,
                                   cd_precision=0.4, max_length=100000, flipped=False)
        m = min(len(ours), len(ref_path))
        assert m > 2
        np.testing.assert_allclose(ours[:m], ref_path[:m], rtol=0, atol=1e-9)
        compared += 1
    assert compared >= 2


def test_log_space_keeps_validity_where_float_sor_collapses():
    """The IROS paper's claim on the port: on the same maze, f32 linear SOR
    loses a large share of valid cells and the log-space solver keeps
    them."""
    img = maps.recursive_maze(128, 128, seed=1, corridor=8)
    goal = img == 255
    u32, locked = legacy.from_image(img, dtype=np.float32)
    sor32, _ = legacy.sor(u32, locked, epsilon=1e-4, min_iterations=20000, dtype=np.float32)
    pv_sor32 = analysis.percent_valid(sor32, locked, goal)
    out = core.solve(T.from_occupancy_image(img, 1e-4, device="cpu"))
    pv_log = analysis.percent_valid(out.u.numpy(), out.locked.numpy(), goal)
    assert pv_log > 0.99, pv_log
    assert pv_log > pv_sor32 + 0.2, (pv_log, pv_sor32)
