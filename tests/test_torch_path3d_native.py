"""The native 3D walker (``native.compute_path_3d``, ``epic_path3d_f32`` in
the port's own part of ``epic_native.cc``) against the NumPy walker
(``path3d.compute_path(impl="numpy")``) point for point: on the 3D fuzz
golden's converged field, on a small storey extruded from a crop of the
umass plan, and on walks that end stuck, leave the volume, start off it or
in an obstacle, or make fewer than three points. This file imports neither
JAX nor epic_tpu."""

import pathlib

import numpy as np
import pytest
import torch

from epic_tpu_torch import grid as G
from epic_tpu_torch import native, path3d
from epic_tpu_torch.errors import (EpicError, InvalidGradientError, InvalidLocationError,
                                   InvalidPathError)
from epic_tpu_torch.solver import core

GOLDENS = pathlib.Path(__file__).parent / "goldens"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(impl, *args, **kw):
    try:
        return path3d.compute_path(*args, impl=impl, **kw)
    except EpicError as e:  # the error's type is part of the contract
        return type(e).__name__


def _same(*args, **kw):
    """Both walkers from one start: the same points, or the same error.
    Returns the points (or the error's name)."""
    a = _walk("native", *args, **kw)
    b = _walk("numpy", *args, **kw)
    if isinstance(a, str) or isinstance(b, str):
        assert a == b, (args[2:], a if isinstance(a, str) else len(a),
                        b if isinstance(b, str) else len(b))
        return a
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    assert np.array_equal(a, b)
    return a


@pytest.fixture(scope="module")
def fuzz():
    g = np.load(GOLDENS / "fuzz3d_seed0.npz")
    return g["ref_u"], g["locked"]


@pytest.fixture(scope="module")
def storey():
    """A converged field on a 10 x 32 x 96 storey: a crop of the umass
    plan's walls through every plane, a goal voxel mid-height."""
    img = np.load(GOLDENS / "umass.npz")["img"][110:142, 320:416]
    d = 10
    occ = np.broadcast_to(np.where(img == 0, 100, 0).astype(np.int16), (d,) + img.shape)
    st = G.empty_volume(d, *img.shape, 1e-3, device="cpu")
    zs, ys, xs = np.nonzero(np.ones(occ.shape, bool)[1:-1, 1:-1, 1:-1])
    zs, ys, xs = zs + 1, ys + 1, xs + 1
    types = np.where(occ[zs, ys, xs] >= 50, 1, 2)
    st = G.set_cells_3d(st, np.stack([xs, ys, zs], axis=1), types)
    fy, fx = np.nonzero(img[1:-1, 1:-1] != 0)
    goal = (int(fx[len(fx) // 2]) + 1, int(fy[len(fy) // 2]) + 1, d // 2)
    st = G.set_cells_3d(st, [goal], [0])
    out = core.solve(st, 100)
    assert bool(out.converged)
    return out.u.numpy(), out.locked.numpy(), goal


@pytest.mark.parametrize("part", range(4))
def test_fuzz_golden_walks_match(fuzz, part):
    u, locked = fuzz
    zs, ys, xs = np.nonzero(~locked)
    rng = np.random.default_rng(part)
    walked = 0
    for i in rng.choice(len(zs), 12, replace=False):
        for off in ((0.0, 0.0, 0.0), (0.3, -0.2, 0.1), (-0.45, 0.45, -0.3)):
            got = _same(u, locked, xs[i] + off[0], ys[i] + off[1], zs[i] + off[2], 0.05, 0.5,
                        100_000)
            walked += not isinstance(got, str)
    assert walked >= 8


@pytest.mark.parametrize("step,cd", [(0.05, 0.5), (0.2, 0.4), (0.1, 0.3)])
def test_storey_walks_match_and_reach_the_goal(storey, step, cd):
    u, locked, goal = storey
    d, h, w = u.shape
    fz, fy, fx = np.nonzero(~locked)
    rng = np.random.default_rng(7)
    reached = 0
    for i in rng.choice(len(fz), 10, replace=False):
        pts = _same(u, locked, float(fx[i]), float(fy[i]), float(fz[i]), step, cd,
                    int(w * h * d / step))
        if not isinstance(pts, str):
            reached += path3d.path_reaches_goal(u, locked, pts)
    assert reached >= 6


def test_stuck_walk():
    """A field with a free maximum and no goal: the walk climbs to it and
    ends stuck, not locked, on both walkers."""
    d, h, w = 9, 11, 13
    z, y, x = np.meshgrid(np.arange(d), np.arange(h), np.arange(w), indexing="ij")
    u = -((x - 6.2) ** 2 + (y - 5.1) ** 2 + (z - 3.7) ** 2).astype(np.float32)
    locked = np.zeros(u.shape, bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1], locked[:, :, 0], locked[:, :, -1] = True, True, True, True
    u[locked] = -1e6
    pts = _same(u, locked, 2.0, 3.0, 2.0, 0.2, 0.4, 100_000)
    assert not isinstance(pts, str) and 10 < len(pts) < 100_000
    end = tuple(int(v + 0.5) for v in pts[-1])
    assert not locked[end[2], end[1], end[0]]


def test_walk_off_the_volume():
    """No locked voxel: the walk climbs toward +x until a sample or a step
    leaves the volume; both walkers raise InvalidGradientError."""
    u = np.broadcast_to(np.arange(12, dtype=np.float32), (6, 7, 12)).copy()
    locked = np.zeros(u.shape, bool)
    assert _same(u, locked, 3.0, 3.0, 3.0, 0.2, 0.4, 100_000) == "InvalidGradientError"


def test_short_walks_and_bad_starts(storey):
    u, locked, (gx, gy, gz) = storey
    # On the goal voxel: one point.
    assert _same(u, locked, float(gx), float(gy), float(gz), 0.05, 0.5, 10_000) == \
        "InvalidPathError"
    # A budget of two points.
    fz, fy, fx = np.nonzero(~locked)
    assert _same(u, locked, float(fx[0]), float(fy[0]), float(fz[0]), 0.05, 0.5, 2) == \
        "InvalidPathError"
    # Off the volume and inside an obstacle (the shell).
    assert _same(u, locked, -3.0, 2.0, 2.0, 0.05, 0.5, 10_000) == "InvalidLocationError"
    assert _same(u, locked, 1.0, 1.0, 0.0, 0.05, 0.5, 10_000) == "InvalidLocationError"
    with pytest.raises(InvalidLocationError):
        native.compute_path_3d(u, locked, 5.0, 5.0, 99.0)
    with pytest.raises(InvalidPathError):
        native.compute_path_3d(u, locked, float(gx), float(gy), float(gz))
    with pytest.raises(InvalidGradientError):
        native.compute_path_3d(np.broadcast_to(np.arange(12, dtype=np.float32),
                                               (6, 7, 12)).copy(),
                               np.zeros((6, 7, 12), bool), 3.0, 3.0, 3.0)


def test_truncation_retry_and_budget(storey):
    """A walk longer than the output buffer is rerun into an exact-size one;
    a budget cuts the walk where the NumPy walker's does."""
    u, locked, _ = storey
    fz, fy, fx = np.nonzero(~locked)
    start = None
    for i in range(0, len(fz), 31):
        args = (u, locked, float(fx[i]), float(fy[i]), float(fz[i]), 0.05, 0.5, 10**6)
        full = _walk("native", *args)
        if not isinstance(full, str) and len(full) > 200:
            start = args
            break
    assert start is not None
    np.testing.assert_array_equal(native.compute_path_3d(*start, _cap=7), full)
    cut = start[:-1] + (len(full) - 50,)
    np.testing.assert_array_equal(native.compute_path_3d(*cut, _cap=7), full[:len(full) - 50])
    np.testing.assert_array_equal(_same(*cut), full[:len(full) - 50])


def test_locked_is_read_in_place_or_converted(storey):
    """A boolean ``locked`` is read as bytes in place; any other dtype is
    converted, with the same points."""
    u, locked, _ = storey
    fz, fy, fx = np.nonzero(~locked)
    args = (float(fx[5]), float(fy[5]), float(fz[5]), 0.05, 0.5, 10**6)
    a = native.compute_path_3d(u, locked, *args)
    np.testing.assert_array_equal(native.compute_path_3d(u, locked.astype(np.uint8) * 3, *args),
                                  a)
    np.testing.assert_array_equal(native.compute_path_3d(u.astype(np.float64), locked, *args), a)
    with pytest.raises(ValueError):
        native.compute_path_3d(u, locked[:, :, 1:], *args)


def test_impl_switch(storey, monkeypatch):
    """"auto" walks natively when the library is built and in NumPy when it
    is not; "native" then raises; an unknown impl and a 2D field are
    refused."""
    u, locked, _ = storey
    fz, fy, fx = np.nonzero(~locked)
    args = (u, locked, float(fx[9]), float(fy[9]), float(fz[9]), 0.05, 0.5, 10**6)
    calls = []
    walk = native.compute_path_3d
    monkeypatch.setattr(native, "compute_path_3d", lambda *a, **k: calls.append(1) or walk(*a, **k))
    want = path3d.compute_path(*args)
    assert calls == [1]
    monkeypatch.setattr(native, "available", lambda: False)
    np.testing.assert_array_equal(path3d.compute_path(*args), want)
    assert calls == [1]
    with pytest.raises(RuntimeError, match="native library unavailable"):
        path3d.compute_path(*args, impl="native")
    with pytest.raises(ValueError):
        path3d.compute_path(*args, impl="cuda")
    with pytest.raises(ValueError):
        path3d.compute_path(u[0], locked[0], 2.0, 2.0, 2.0)
