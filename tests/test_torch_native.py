"""epic_tpu_torch.native (the port's g++-built C++ helpers) against the
port's NumPy oracles and epic_tpu's NumPy ones: tests/test_native.py's cases
on the port, with the walks held to epic_tpu's ``path.compute_path(
impl="numpy")`` point for point and the sweep to ``reference_np``'s scalar
loop bit for bit. No test here calls ``epic_tpu.native``: the port builds
its own copy of the source, into build/epic_tpu_torch/."""

import pathlib

import numpy as np
import pytest
import torch

import epic_tpu_torch as T
from epic_tpu import path as jpath
from epic_tpu.solver import reference_np as jref
from epic_tpu_torch import maps, native, path
from epic_tpu_torch.errors import InvalidGradientError, InvalidLocationError, InvalidPathError
from epic_tpu_torch.solver import core, legacy, reference_np

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def solved_maze():
    img = maps.recursive_maze(64, 64, seed=3)
    out = core.solve(T.from_occupancy_image(img, 1e-3, device="cpu"))
    return img, out.u.numpy(), out.locked.numpy()


def _walk(fn, *args, **kw):
    try:
        return fn(*args, **kw)
    except Exception as e:  # the error's type is part of the contract
        return type(e).__name__


def test_source_is_the_port_copy():
    """The port compiles its own copy: below the header comment, the same
    bytes as epic_tpu/native/epic_native.cc, then the port's own 3D walker
    and nothing else."""
    def body(p):
        text = p.read_text()
        return text[text.index("#include"):]

    assert native.SOURCE == ROOT / "epic_tpu_torch" / "native" / "epic_native.cc"
    ours, theirs = body(native.SOURCE), body(ROOT / "epic_tpu" / "native" / "epic_native.cc")
    assert ours.startswith(theirs)
    added = ours[len(theirs):]
    assert added.lstrip("\n").startswith("// ---")
    assert "epic_path3d_f32" in added and "epic_path2d_f32" not in added


def test_builds_into_the_build_directory():
    assert native.available()
    lib = native.library_path()
    assert lib.parent == ROOT / "build" / "epic_tpu_torch" and lib.exists()
    assert lib.name.startswith("libepic_native-") and lib.suffix == ".so"
    assert native.FLAGS == ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-fopenmp",
                            "-shared")
    assert "-ffast-math" not in native.FLAGS


def test_sweep_bitmatches_scalar_oracles():
    img = maps.random_obstacles(24, 20, density=0.2, seed=3)
    st = T.from_occupancy_image(img, device="cpu")
    u, locked = st.u.numpy(), st.locked.numpy()
    for it in range(4):
        u_n, d_n = native.sweep_2d(u, locked, it)
        u_p, d_p = reference_np.sweep_scalar(u, locked, it)
        u_j, d_j = jref.sweep_scalar(u, locked, it)
        np.testing.assert_array_equal(u_n, u_p)
        np.testing.assert_array_equal(u_p, u_j)
        assert d_n == float(d_p) == float(d_j)
        u = u_p


def test_sweep_openmp_thread_invariant():
    """The OpenMP row-parallel sweep gives the same bits at any thread
    count: red-black parity makes a sweep's writes disjoint, and the delta
    is an order-free max."""
    import ctypes

    try:
        gomp = ctypes.CDLL("libgomp.so.1", mode=ctypes.RTLD_GLOBAL)
    except OSError:
        pytest.fail("libgomp.so.1 not found, though the library links it (-fopenmp)")
    st = T.from_occupancy_image(maps.recursive_maze(96, 128, seed=5), device="cpu")
    u0, locked = st.u.numpy(), st.locked.numpy()
    default_threads = gomp.omp_get_max_threads()
    results = []
    try:
        for nthreads in (1, 4):
            gomp.omp_set_num_threads(ctypes.c_int(nthreads))
            u, deltas = u0.copy(), []
            for it in range(6):
                u, d = native.sweep_2d(u, locked, it)
                deltas.append(d)
            results.append((u, deltas))
    finally:
        gomp.omp_set_num_threads(ctypes.c_int(default_threads))
    np.testing.assert_array_equal(results[0][0], results[1][0])
    assert results[0][1] == results[1][1]


@pytest.mark.parametrize("mode", ["reference", "bilinear"])
def test_path_matches_numpy(solved_maze, mode):
    """The native walker, the port's NumPy walker and epic_tpu's NumPy
    walker: the same points, or the same error."""
    img, u, locked = solved_maze
    ys, xs = np.nonzero(img == 128)
    rng = np.random.default_rng(0)
    walked = 0
    for i in rng.choice(len(ys), 15):
        x, y = float(xs[i]), float(ys[i])
        a = _walk(native.compute_path, u, locked, x, y, 0.2, 0.4, mode=mode)
        b = _walk(path.compute_path, u, locked, x, y, 0.2, 0.4, mode=mode, impl="numpy")
        c = _walk(jpath.compute_path, u, locked, x, y, 0.2, 0.4, mode=mode, impl="numpy")
        if isinstance(a, str):
            assert a == b == c, (x, y)
            continue
        walked += 1
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(path.compute_path(u, locked, x, y, 0.2, 0.4, mode=mode,
                                                        impl="native"), a)
    assert walked >= 5


def test_compute_path_impl(solved_maze):
    """impl="auto" takes the native walker when it is built; an unknown impl
    is refused."""
    img, u, locked = solved_maze
    y, x = np.argwhere(img == 128)[7]
    np.testing.assert_array_equal(
        path.compute_path(u, locked, float(x), float(y), mode="bilinear"),
        native.compute_path(u, locked, float(x), float(y), 0.2, 0.4, mode="bilinear"))
    with pytest.raises(ValueError):
        path.compute_path(u, locked, float(x), float(y), impl="cuda")


def test_path_error_codes(solved_maze):
    img, u, locked = solved_maze
    with pytest.raises(InvalidLocationError):
        native.compute_path(u, locked, -4.0, 2.0)
    oy, ox = np.argwhere(img == 0)[0]
    with pytest.raises(InvalidLocationError):
        native.compute_path(u, locked, float(ox), float(oy))
    st = T.from_occupancy_image(img, device="cpu")
    with pytest.raises((InvalidPathError, InvalidGradientError)):
        native.compute_path(st.u.numpy(), locked, 2.0, 2.0)


def test_path_truncation_retry(solved_maze):
    """A walk longer than the output buffer is rerun into an exact-size one
    (code 100), so the result does not depend on the buffer's capacity."""
    img, u, locked = solved_maze
    free_ys, free_xs = np.nonzero(~locked)
    full = None
    for i in range(0, len(free_ys), 17):
        x, y = float(free_xs[i]), float(free_ys[i])
        cand = _walk(native.compute_path, u, locked, x, y, 0.2, 0.4, 100000)
        if not isinstance(cand, str) and len(cand) > 20:
            full = cand
            break
    assert full is not None, "no start produced a >20-point walk"
    np.testing.assert_array_equal(native.compute_path(u, locked, x, y, 0.2, 0.4, 100000, _cap=4),
                                  full)
    budget = native.compute_path(u, locked, x, y, 0.2, 0.4, len(full) - 2, _cap=4)
    np.testing.assert_array_equal(budget, full[: len(full) - 2])


@pytest.mark.parametrize("seed,shape", [(0, (48, 64)), (7, (65, 41))])
def test_solve_matches_core_protocol(seed, shape):
    """The whole protocol on the host: iterations equal the port's
    core.solve (1 mod stagger), fields to float32 tolerance, the
    non-sticky post-check verdict."""
    img = maps.random_obstacles(*shape, density=0.12, seed=seed)
    st = T.from_occupancy_image(img, 1e-3, device="cpu")
    out = core.solve(st)
    u_nat, iters, delta, converged = native.solve_2d(st.u.numpy(), st.locked.numpy(),
                                                     epsilon=1e-3)
    assert iters == int(out.iteration) and iters % 100 == 1
    assert converged == bool(out.converged) and delta < 1e-3
    np.testing.assert_allclose(u_nat, out.u.numpy(), rtol=0, atol=2e-5)


def test_solve_max_iterations_cap():
    st = T.from_occupancy_image(maps.recursive_maze(64, 64, seed=1), 1e-12, device="cpu")
    _, iters, _, converged = native.solve_2d(st.u.numpy(), st.locked.numpy(), epsilon=1e-12,
                                             max_iterations=500)
    assert not converged and iters == 500


@pytest.mark.parametrize("dtype,atol", [(np.float64, 1e-12), (np.longdouble, 1e-15),
                                        (np.float32, 1e-6)])
def test_sor_matches_numpy_sor(dtype, atol):
    """The legacy SOR in each precision against the scalar NumPy oracle."""
    img = maps.open_room(20, 20)
    u, locked = legacy.from_image(img, dtype=dtype)
    u_n, it_n = native.legacy_sor_2d(u, locked, epsilon=1e-4, omega=1.5, min_iterations=100,
                                     dtype=dtype)
    assert u_n.dtype == dtype
    u_p, it_p = legacy.sor_numpy(u.copy(), locked, epsilon=1e-4, omega=1.5, min_iterations=100)
    assert it_n == it_p
    np.testing.assert_allclose(np.float64(u_n), np.float64(u_p), rtol=0, atol=atol)


def test_failed_build_is_not_silent(monkeypatch, tmp_path):
    """A source that does not compile: available() is False, build_info
    keeps g++'s output, impl="auto" walks in NumPy and impl="native"
    raises."""
    bad = tmp_path / "broken.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "build_info", {})
    assert not native.available()
    assert native.build_info["error"] and "broken.cc" in native.build_info["log"]
    assert not list((tmp_path / "build").glob("*.so"))
    img = maps.open_room(32, 32)
    st = core.solve(T.from_occupancy_image(img, 1e-2, device="cpu"))
    u, locked = st.u.numpy(), st.locked.numpy()
    pts = path.compute_path(u, locked, 5.0, 5.0, mode="bilinear")
    np.testing.assert_array_equal(pts, path.compute_path(u, locked, 5.0, 5.0, mode="bilinear",
                                                         impl="numpy"))
    with pytest.raises(RuntimeError, match="native library unavailable"):
        path.compute_path(u, locked, 5.0, 5.0, impl="native")
    with pytest.raises(RuntimeError):
        native.solve_2d(u, locked)


def test_builds_without_openmp_where_no_compiler_links_it(monkeypatch, tmp_path):
    """A host whose g++ cannot link OpenMP (no libgomp spec) gets the library
    built without -fopenmp, says so in build_info, and gives the same bits."""
    cxx = tmp_path / "g++-without-openmp"
    cxx.write_text('#!/bin/sh\ncase " $* " in *" -fopenmp "*)\n'
                   '  echo "cannot read spec file libgomp.spec" >&2; exit 1;;\nesac\n'
                   'exec g++ "$@"\n')
    cxx.chmod(0o755)
    img = maps.recursive_maze(40, 48, seed=2)
    st = T.from_occupancy_image(img, device="cpu")
    u, locked = st.u.numpy(), st.locked.numpy()
    want = native.sweep_2d(u, locked, 1)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_compilers", lambda: [str(cxx)])
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_failed", False)
    monkeypatch.setattr(native, "build_info", {})
    assert native.available()
    assert native.build_info["openmp"] is False
    assert "libgomp.spec" in native.build_info["log"]
    assert native.build_info["library"] != str(native.library_path())
    got = native.sweep_2d(u, locked, 1)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
