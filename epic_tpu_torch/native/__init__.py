"""ctypes bindings to the port's native C++ helpers (``epic_native.cc``).

The counterpart of ``epic_tpu.native``: a host-side streamline walker, a
scalar red-black sweep (an independent oracle), the whole log-space solve
protocol on the host (the cascade's coarse levels), and the legacy non-log
SOR in float, double and long double. ``epic_native.cc`` here is the port's
own copy of the JAX package's source, with one entry of the port's own at
its end: the 3D walker of :mod:`epic_tpu_torch.path3d`
(:func:`compute_path_3d`).

The library is compiled at first use with g++ and the reference Makefile's
flags (``-O3 -std=c++17 -fPIC -Wall -Wextra -fopenmp -shared``, no fast
math) into ``build/epic_tpu_torch/`` beside the package, named by a hash of
the source and the flags; a build writes a temporary file there and moves it
into place, so concurrent processes never load a half-written library. A
host whose compilers cannot link OpenMP gets the same library without
``-fopenmp`` (single-threaded, the same results), and ``build_info`` says
so.

A failed build is not silent: ``available()`` turns False, ``build_info``
keeps g++'s output (``chip_smoke.py`` prints it and requires the library),
and callers with ``impl="auto"`` walk in NumPy, as the reference degrades.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

import numpy as np

from ..errors import (
    EpicError,
    InvalidGradientError,
    InvalidLocationError,
    InvalidPathError,
    Result,
)

SOURCE = pathlib.Path(__file__).resolve().parent / "epic_native.cc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "epic_tpu_torch"
FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-fopenmp", "-shared")

# What the build in this process did: seconds, compiler, whether with
# OpenMP, every attempt's output, and the error when nothing built.
build_info: dict = {}
_lib = None
_build_failed = False

_PATH_ERRORS = {
    int(Result.ERROR_INVALID_LOCATION): InvalidLocationError,
    int(Result.ERROR_INVALID_GRADIENT): InvalidGradientError,
    int(Result.ERROR_INVALID_PATH): InvalidPathError,
}


def library_path(flags: tuple[str, ...] = FLAGS) -> pathlib.Path:
    """The library's path, keyed on the source and the flags."""
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(flags).encode())
    return BUILD_DIR / f"libepic_native-{digest.hexdigest()[:16]}.so"


def _compilers() -> list[str]:
    """$CXX, then g++ on PATH (a host's $CXX may lack OpenMP's runtime)."""
    out = []
    for c in (os.environ.get("CXX"), shutil.which("g++")):
        if c and c not in out:
            out.append(c)
    return out or ["g++"]


def build() -> pathlib.Path:
    """Compile the source unless its library already exists: with each
    compiler of :func:`_compilers` in turn, with ``FLAGS``, and if none of
    them can, without ``-fopenmp`` (the entries' results do not depend on
    the thread count; ``build_info["openmp"]`` says which). Raise with every
    compiler's output if nothing builds."""
    attempts = []
    serial = tuple(f for f in FLAGS if f != "-fopenmp")
    for flags in (FLAGS, serial):
        out = library_path(flags)
        if out.exists():
            build_info.setdefault("openmp", flags == FLAGS)
            build_info.setdefault("library", str(out))
            return out
        for cxx in _compilers():
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp")
            cmd = [cxx, *flags, "-o", str(tmp), str(SOURCE)]
            t0 = time.perf_counter()
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
                rc, log = proc.returncode, proc.stdout + proc.stderr
            except OSError as e:
                rc, log = None, str(e)
            attempts.append(f"$ {' '.join(cmd)}\n{log}")
            if rc == 0:
                os.replace(tmp, out)
                build_info.update(seconds=time.perf_counter() - t0, compiler=cxx,
                                  openmp=flags == FLAGS, library=str(out),
                                  log="".join(attempts))
                return out
            tmp.unlink(missing_ok=True)
    build_info.update(log="".join(attempts), error="no compiler built the library")
    raise RuntimeError("the native library did not build:\n" + build_info["log"])


def _bind(lib: ct.CDLL) -> ct.CDLL:
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    f80p = np.ctypeslib.ndpointer(np.longdouble, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.epic_path2d_f32.argtypes = [
        f32p, u8p, ct.c_int, ct.c_int,
        ct.c_float, ct.c_float, ct.c_float, ct.c_float,
        ct.c_int, ct.c_int, f32p, ct.c_int, ct.POINTER(ct.c_int),
    ]
    lib.epic_sweep2d_f32.argtypes = [f32p, u8p, ct.c_int, ct.c_int, ct.c_int,
                                     ct.POINTER(ct.c_float)]
    lib.epic_solve2d_f32.argtypes = [
        f32p, u8p, ct.c_int, ct.c_int, ct.c_float, ct.c_uint, ct.c_uint,
        ct.POINTER(ct.c_uint), ct.POINTER(ct.c_float), ct.POINTER(ct.c_int),
    ]
    for name, ptr, real in (("epic_sor2d_f32", f32p, ct.c_float),
                            ("epic_sor2d_f64", f64p, ct.c_double),
                            ("epic_sor2d_f80", f80p, ct.c_longdouble)):
        getattr(lib, name).argtypes = [ptr, u8p, ct.c_int, ct.c_int, real, real,
                                       ct.c_uint, ct.POINTER(ct.c_uint)]
    lib.epic_path3d_f32.argtypes = [
        f32p, u8p, ct.c_int, ct.c_int, ct.c_int,
        ct.c_float, ct.c_float, ct.c_float, ct.c_double, ct.c_double,
        ct.c_int64, f32p, ct.c_int64, ct.POINTER(ct.c_int64),
    ]
    for name in ("epic_path2d_f32", "epic_path3d_f32", "epic_sweep2d_f32", "epic_solve2d_f32",
                 "epic_sor2d_f32", "epic_sor2d_f64", "epic_sor2d_f80"):
        getattr(lib, name).restype = ct.c_int
    return lib


def _load():
    """The library, built and loaded once per process; None if the build
    failed (``build_info`` says why)."""
    global _lib, _build_failed
    if _lib is None and not _build_failed:
        try:
            _lib = _bind(ct.CDLL(str(build())))
        except (OSError, RuntimeError) as e:
            build_info.setdefault("error", str(e))
            _build_failed = True
    return _lib


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {build_info.get('error')}")
    return lib


def available() -> bool:
    return _load() is not None


def _points(walk, dims: int, count, max_length: int, first_cap: int | None,
            where: str) -> np.ndarray:
    """The points of a native walk, ``float32 [k, dims]``. ``walk(out, cap,
    n)`` runs the entry into ``out``, which holds ``cap`` points, and sets
    ``n`` (a ``count``). A 4M-point buffer first; a longer walk makes the
    library report the true count (code 100) and the walk is rerun into an
    exact-size buffer. The step budget is always max_length, never the
    buffer's capacity. ``first_cap`` overrides the first capacity (the tests
    exercise the retry). A walker's error code raises its error."""
    cap = min(max_length, 4_000_000) if first_cap is None else first_cap
    while True:
        out = np.empty((cap, dims), dtype=np.float32)
        n = count(0)
        code = walk(out.reshape(-1), cap, ct.byref(n))
        if code != 100:
            break
        cap = int(n.value)
    if code != 0:
        exc = _PATH_ERRORS.get(code)
        if exc is not None:
            raise exc(f"native path extraction failed at {where}")
        raise EpicError(code, "native path extraction failed")
    return out[: n.value].copy()


def compute_path(
    u: np.ndarray,
    locked: np.ndarray,
    x: float,
    y: float,
    step_size: float = 0.2,
    cd_precision: float = 0.4,
    max_length: int = 1_000_000,
    mode: str = "reference",
    _cap: int | None = None,
) -> np.ndarray:
    """Native streamline extraction; the contract of
    :func:`epic_tpu_torch.path.compute_path`."""
    lib = _require()
    u = np.ascontiguousarray(u, dtype=np.float32)
    locked_u8 = np.ascontiguousarray(locked, dtype=np.uint8)
    h, w = u.shape
    interp = {"reference": 0, "bilinear": 1}[mode]
    return _points(
        lambda out, cap, n: lib.epic_path2d_f32(
            u, locked_u8, h, w, float(x), float(y), float(step_size), float(cd_precision),
            int(max_length), interp, out, cap, n),
        2, ct.c_int, max_length, _cap, f"({x}, {y})")


def compute_path_3d(
    u: np.ndarray,
    locked: np.ndarray,
    x: float,
    y: float,
    z: float,
    step_size: float = 0.2,
    cd_precision: float = 0.4,
    max_length: int = 1_000_000,
    _cap: int | None = None,
) -> np.ndarray:
    """Native 3D streamline extraction over ``u[z, y, x]``; the contract of
    :func:`epic_tpu_torch.path3d.compute_path` (the same points). A boolean
    ``locked`` is read in place, not copied."""
    lib = _require()
    u = np.ascontiguousarray(u, dtype=np.float32)
    if u.ndim != 3:
        raise ValueError(f"expected a 3D volume, got {u.ndim}D")
    locked = np.asarray(locked)
    if locked.shape != u.shape:
        raise ValueError(f"locked shape {locked.shape} != u shape {u.shape}")
    if locked.dtype == np.bool_ and locked.flags.c_contiguous:
        locked_u8 = locked.view(np.uint8)
    else:
        locked_u8 = np.ascontiguousarray(locked.astype(bool), dtype=np.uint8)
    d, h, w = u.shape
    return _points(
        lambda out, cap, n: lib.epic_path3d_f32(
            u, locked_u8, d, h, w, float(x), float(y), float(z), float(step_size),
            float(cd_precision), int(max_length), out, cap, n),
        3, ct.c_int64, max_length, _cap, f"({x}, {y}, {z})")


def sweep_2d(u: np.ndarray, locked: np.ndarray, iteration: int):
    """One scalar red-black sweep (an independent C++ oracle). Returns
    ``(u, delta)``."""
    lib = _require()
    u = np.ascontiguousarray(u, dtype=np.float32).copy()
    locked_u8 = np.ascontiguousarray(locked, dtype=np.uint8)
    h, w = u.shape
    delta = ct.c_float(0.0)
    code = lib.epic_sweep2d_f32(u, locked_u8, h, w, int(iteration), ct.byref(delta))
    if code != 0:
        raise EpicError(code, "native sweep failed")
    return u, float(delta.value)


def solve_2d(
    u: np.ndarray,
    locked: np.ndarray,
    epsilon: float = 1e-3,
    stagger: int = 100,
    max_iterations: int = 1_000_000,
):
    """The whole log-space solve protocol on the host, the C++ twin of
    :func:`epic_tpu_torch.solver.core.solve` (harmonic_complete_cpu,
    harmonic_cpu.cpp:136-184). Returns ``(u, iterations, delta,
    converged)``: iteration counts equal core's, fields to float32
    tolerance."""
    lib = _require()
    u = np.ascontiguousarray(u, dtype=np.float32).copy()
    locked_u8 = np.ascontiguousarray(locked, dtype=np.uint8)
    h, w = u.shape
    iters = ct.c_uint(0)
    delta = ct.c_float(0.0)
    converged = ct.c_int(0)
    code = lib.epic_solve2d_f32(
        u, locked_u8, h, w, float(epsilon), int(stagger), int(max_iterations),
        ct.byref(iters), ct.byref(delta), ct.byref(converged),
    )
    if code != 0:
        raise EpicError(code, "native solve failed")
    return u, int(iters.value), float(delta.value), bool(converged.value)


def legacy_sor_2d(
    u: np.ndarray,
    locked: np.ndarray,
    epsilon: float = 1e-4,
    omega: float = 1.5,
    min_iterations: int = 10_000,
    dtype=np.float64,
):
    """Legacy non-log SOR to convergence (harmonic_legacy_cpu semantics).
    ``dtype`` float32, float64 or ``np.longdouble`` (x87 80-bit on x86-64)
    selects the precision, as the reference's Python exposes all three.
    Returns ``(u, iterations)``."""
    lib = _require()
    locked_u8 = np.ascontiguousarray(locked, dtype=np.uint8)
    h, w = u.shape
    iters = ct.c_uint(0)
    if dtype == np.float32:
        entry, dt, real = lib.epic_sor2d_f32, np.float32, float
    elif dtype == np.longdouble:
        entry, dt, real = lib.epic_sor2d_f80, np.longdouble, np.longdouble
    else:
        entry, dt, real = lib.epic_sor2d_f64, np.float64, float
    u = np.ascontiguousarray(u, dtype=dt).copy()
    code = entry(u, locked_u8, h, w, real(epsilon), real(omega), int(min_iterations),
                 ct.byref(iters))
    if code != 0:
        raise EpicError(code, "native SOR failed")
    return u, int(iters.value)
