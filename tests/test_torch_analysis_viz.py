"""The port's analysis, viz and profiling modules, and the top-level exports:
tests/test_analysis_viz.py's cases on the port, with the analysis and the
renders held to epic_tpu's on the same fields (the same numbers, the same
pixels). epic_tpu's walks here are its NumPy walker's (no test calls
epic_tpu.native)."""

import functools
import json

import numpy as np
import pytest
import torch

import epic_tpu
import epic_tpu.path as jpath
from epic_tpu import analysis as janalysis
from epic_tpu import viz as jviz
import epic_tpu_torch as T
from epic_tpu_torch import analysis, maps, path, path3d, profiling, viz
from epic_tpu_torch.solver import core


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jnumpy_walk(monkeypatch):
    monkeypatch.setattr(jpath, "compute_path",
                        functools.partial(jpath.compute_path, impl="numpy"))


def _solved(img, eps):
    out = core.solve(T.from_occupancy_image(img, eps, device="cpu"))
    return out.u.numpy(), out.locked.numpy()


def test_every_epic_tpu_export_is_in_the_port():
    assert set(epic_tpu.__all__) <= set(T.__all__)
    for name in T.__all__:
        assert hasattr(T, name), name


def test_percent_valid_log_space_near_one_and_matches_epic_tpu():
    img = maps.recursive_maze(96, 96, seed=5)
    u, locked = _solved(img, 1e-3)
    pv = analysis.percent_valid(u, locked, img == 255)
    assert pv > 0.99
    assert pv == janalysis.percent_valid(u, locked, img == 255)
    np.testing.assert_array_equal(analysis.gradient_norms(u), janalysis.gradient_norms(u))


def test_reachability_respects_walls():
    passable = np.zeros((5, 5), dtype=bool)
    passable[1:4, 1] = True
    passable[1, 1:4] = True  # L-shape
    seed = np.zeros((5, 5), dtype=bool)
    seed[3, 1] = True
    reached = analysis.reachable_from(seed, passable)
    assert reached[1, 3] and reached[1, 1]
    assert not reached[3, 3]


def test_reachable_from_3d_respects_walls():
    passable = np.zeros((4, 5, 5), dtype=bool)
    passable[1, 1:4, 1] = True
    passable[2, 3, 1] = True
    seed = np.zeros((4, 5, 5), dtype=bool)
    seed[1, 1, 1] = True
    reached = analysis.reachable_from(seed, passable)
    assert reached[1, 3, 1] and reached[2, 3, 1]
    assert not reached[3, 3, 3]


def test_render_overlay_and_png(tmp_path):
    img = maps.open_room(40, 40)
    u, locked = _solved(img, 1e-2)
    p = path.compute_path(u, locked, 5.0, 5.0, 0.2, 0.4, mode="bilinear")
    rgb = viz.render(u, locked, [p])
    assert rgb.shape == (40, 40, 3)
    assert tuple(rgb[5, 5]) == (0, 255, 0)
    assert (rgb[..., 0] == 255).sum() > (rgb[..., 2] == 255).sum()
    assert tuple(rgb[0, 0]) == (0, 0, 0)
    np.testing.assert_array_equal(rgb, jviz.render(u, locked, [p]))
    f = tmp_path / "overlay.png"
    viz.save_png(str(f), rgb)
    assert maps.load_png(f).shape == (40, 40)


def test_streamline_success_rate_metric(jnumpy_walk):
    img = maps.open_room(48, 48)
    u, locked = _solved(img, 1e-3)
    rate = analysis.streamline_success_rate(u, locked, img == 255, n_samples=40)
    assert rate > 0.9
    assert rate == janalysis.streamline_success_rate(u, locked, img == 255, n_samples=40)


def test_percent_valid_3d_volume():
    d, h, w = 10, 14, 18
    u0 = np.full((d, h, w), np.float32(-1e6))
    lk = np.zeros((d, h, w), bool)
    lk[0] = lk[-1] = lk[:, 0] = lk[:, -1] = lk[:, :, 0] = lk[:, :, -1] = True
    goal = np.zeros((d, h, w), bool)
    goal[5, 7, 9] = True
    u0[goal] = 0.0
    lk |= goal
    out = core.solve(T.make_state(u0, lk, 1e-3, device="cpu"))
    assert analysis.percent_valid(out.u.numpy(), out.locked.numpy(), goal) > 0.99


def test_render_volume_slice_marks_path():
    d, h, w = 8, 12, 16
    u0 = np.full((d, h, w), np.float32(-1e6))
    lk = np.zeros((d, h, w), bool)
    lk[0] = lk[-1] = lk[:, 0] = lk[:, -1] = lk[:, :, 0] = lk[:, :, -1] = True
    u0[4, 6, 8] = 0.0
    lk[4, 6, 8] = True
    out = core.solve(T.make_state(u0, lk, 1e-2, device="cpu"))
    u, locked = out.u.numpy(), out.locked.numpy()
    p = path3d.compute_path(u, locked, 3.0, 3.0, 4.0, 0.2, 0.4)
    rgb = viz.render_volume_slice(u, locked, z=4, paths=[p])
    assert rgb.shape == (h, w, 3)
    assert ((rgb[:, :, 0] > 100) & (rgb[:, :, 1] == 0)).any()
    np.testing.assert_array_equal(rgb, jviz.render_volume_slice(u, locked, z=4, paths=[p]))


def test_click_streamline_gui_free(jnumpy_walk):
    img = maps.recursive_maze(64, 64, seed=4)
    u, locked = _solved(img, 1e-3)
    base = viz.render(u, locked)
    free = np.argwhere(~locked)
    fy, fx = free[len(free) // 3]
    overlay = viz.click_streamline(u, locked, float(fx), float(fy), mode="bilinear")
    assert overlay is not None and overlay.shape == base.shape
    assert (overlay != base).any()
    np.testing.assert_array_equal(
        overlay, jviz.click_streamline(u, locked, float(fx), float(fy), mode="bilinear"))
    oy, ox = map(int, np.argwhere(locked & (u <= -1e5))[0])
    assert viz.click_streamline(u, locked, float(ox), float(oy), mode="bilinear") is None


def test_profiling_timed_solve():
    img = maps.open_room(24, 24)
    st = T.from_occupancy_image(img, 1e-2, device="cpu")
    out, stats = profiling.timed_solve(core.solve, st, stagger=10)
    assert stats.iterations == int(out.iteration) > 0
    assert stats.wall_s > 0 and stats.cells == 24 * 24
    assert stats.sweeps_per_s > 0 and stats.cell_updates_per_s > 0
    assert stats.time_per_update == stats.wall_s / stats.iterations
    assert stats.device_ms is None   # a CPU state: no CUDA events


def test_profiling_trace(tmp_path):
    """trace records a torch.profiler Chrome trace of the block."""
    st = T.from_occupancy_image(maps.open_room(16, 16), 1e-2, device="cpu")
    with profiling.trace(tmp_path) as prof:
        core.update_n(st, 3)
    assert prof.key_averages()
    (f,) = tmp_path.glob("trace-*.json")
    assert json.loads(f.read_text())["traceEvents"]
