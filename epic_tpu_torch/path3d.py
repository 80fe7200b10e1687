"""Streamline (path) extraction from a relaxed 3D log-potential volume.

A NumPy copy of ``epic_tpu.path3d``: the reference ships a 3D solver
(harmonic_update_3d_cpu, harmonic_cpu.cpp:81-133) but no 3D path extraction
(harmonic_path_cpu.cpp is 2D-only); the field is fetched to the host once per
request and walked there.

Design: the natural 3D generalization of the 2D walker
(:mod:`epic_tpu_torch.path`), using the *fixed* interpolation variant (the
2D ``mode="bilinear"``) throughout — there is no reference 3D behaviour to
replicate, so the alpha>1 extrapolation quirk is deliberately not carried
over:

- potential at a continuous point = trilinear interpolation of the 8
  surrounding cell centres (corners ``floor(v)`` and ``floor(v)+1``, weights
  in [0, 1) — never extrapolates);
- gradient = central differences at precision ``cd_precision``, normalised
  to unit length (norm accumulated in f64 and rounded once, as the 2D
  walker does, path.py:compute_gradient);
- path loop: gradient ascent with step ``step_size`` until a locked cell is
  reached, the point budget is exhausted, or the stuck check against the
  last 5 points fires (PATH_STUCK_HISTORY_LENGTH, harmonic_path_cpu.cpp:39);
- paths of <= 2 points raise InvalidPathError — the same anytime contract
  ("not relaxed enough yet, keep relaxing and retry").

Coordinates are ``(x, y, z)`` continuous cell units over ``u[z, y, x]``
(row-major ``[depth, height, width]``, matching GridState's 3D layout).

Its native C++ twin with the same points is
:func:`epic_tpu_torch.native.compute_path_3d` (``impl="auto"`` takes it
when it is built); this module is the always-available walker and the
oracle for it.
"""

from __future__ import annotations

import numpy as np

from . import constants as C
from . import profiling
from .errors import (
    InvalidGradientError,
    InvalidLocationError,
    InvalidPathError,
)
from .path_common import cell_index as _cell_index


def _check_location(
    u: np.ndarray, locked: np.ndarray, x: float, y: float, z: float
) -> tuple[int, int, int]:
    """The cell under the point must be in bounds and not a locked
    negative-u cell (obstacle); goal cells (u = 0) are fine."""
    d, h, w = u.shape
    xc, yc, zc = _cell_index(x), _cell_index(y), _cell_index(z)
    if xc < 0 or yc < 0 or zc < 0 or xc >= w or yc >= h or zc >= d:
        raise InvalidLocationError(f"({x}, {y}, {z}) outside the volume")
    if locked[zc, yc, xc] and u[zc, yc, xc] < 0.0:
        raise InvalidLocationError(f"({x}, {y}, {z}) is inside an obstacle")
    return xc, yc, zc


def compute_potential(
    u: np.ndarray, locked: np.ndarray, x: float, y: float, z: float
) -> float:
    """Trilinear interpolation of the 8 surrounding cell centres."""
    _check_location(u, locked, x, y, z)
    d, h, w = u.shape
    x = np.float32(x)
    y = np.float32(y)
    z = np.float32(z)
    x0 = min(int(x), w - 2)
    y0 = min(int(y), h - 2)
    z0 = min(int(z), d - 2)
    a = x - np.float32(x0)
    b = y - np.float32(y0)
    c = z - np.float32(z0)
    one = np.float32(1.0)
    # Bilinear on the z0 plane, then on z0+1, then lerp along z — the same
    # lerp nesting order as the 2D walker's (rows then columns).
    p00 = (one - a) * u[z0, y0, x0] + a * u[z0, y0, x0 + 1]
    p01 = (one - a) * u[z0, y0 + 1, x0] + a * u[z0, y0 + 1, x0 + 1]
    pz0 = (one - b) * p00 + b * p01
    p10 = (one - a) * u[z0 + 1, y0, x0] + a * u[z0 + 1, y0, x0 + 1]
    p11 = (one - a) * u[z0 + 1, y0 + 1, x0] + a * u[z0 + 1, y0 + 1, x0 + 1]
    pz1 = (one - b) * p10 + b * p11
    return float((one - c) * pz0 + c * pz1)


def compute_gradient(
    u: np.ndarray,
    locked: np.ndarray,
    x: float,
    y: float,
    z: float,
    cd_precision: float = C.DEFAULT_CD_PRECISION,
) -> tuple[float, float, float]:
    """Unit-normalised central-difference gradient (6 potential samples)."""
    try:
        v = [
            compute_potential(u, locked, x - cd_precision, y, z),
            compute_potential(u, locked, x + cd_precision, y, z),
            compute_potential(u, locked, x, y - cd_precision, z),
            compute_potential(u, locked, x, y + cd_precision, z),
            compute_potential(u, locked, x, y, z - cd_precision),
            compute_potential(u, locked, x, y, z + cd_precision),
        ]
    except InvalidLocationError as e:
        raise InvalidGradientError(str(e)) from e
    cd2 = np.float32(2.0) * np.float32(cd_precision)
    px = (np.float32(v[1]) - np.float32(v[0])) / cd2
    py = (np.float32(v[3]) - np.float32(v[2])) / cd2
    pz = (np.float32(v[5]) - np.float32(v[4])) / cd2
    denom = np.float32(
        np.sqrt(
            np.float64(px) * np.float64(px)
            + np.float64(py) * np.float64(py)
            + np.float64(pz) * np.float64(pz)
        )
    )
    if denom == 0.0 or not np.isfinite(denom):
        raise InvalidGradientError(f"zero/NaN gradient at ({x}, {y}, {z})")
    return float(px / denom), float(py / denom), float(pz / denom)


def _is_stuck(points: list[tuple[float, float, float]], step_size: float) -> bool:
    """Newest point within step_size/2 of any of the previous
    PATH_STUCK_HISTORY_LENGTH points (harmonic_path_cpu.cpp:121-151)."""
    n = len(points)
    if n == 0:
        return False
    x, y, z = points[-1]
    lo = max(0, n - 1 - C.PATH_STUCK_HISTORY_LENGTH)
    for i in range(n - 2, lo - 1, -1):
        xi, yi, zi = points[i]
        if np.sqrt((x - xi) ** 2 + (y - yi) ** 2 + (z - zi) ** 2) < step_size / 2.0:
            return True
    return False


def compute_path(
    u: np.ndarray,
    locked: np.ndarray,
    x: float,
    y: float,
    z: float,
    step_size: float = C.DEFAULT_STEP_SIZE,
    cd_precision: float = C.DEFAULT_CD_PRECISION,
    max_length: int = C.DEFAULT_MAX_LENGTH,
    impl: str = "auto",
) -> np.ndarray:
    """Gradient-ascent streamline from (x, y, z) through a 3D volume.

    Returns float32 [k, 3] of (x, y, z) points.

    impl: "auto" walks with the native C++ walker when it is built (the
    same points; ``tests/test_torch_path3d_native.py``), else in NumPy;
    "numpy" and "native" force one ("native" raises if the library is not
    built).

    Raises:
      InvalidLocationError: start outside the volume or inside an obstacle.
      InvalidGradientError: gradient sampling failed mid-walk.
      InvalidPathError: <= 2 points produced (field not relaxed enough).
    """
    with profiling.span("path3d.walk"):
        if impl not in ("auto", "numpy", "native"):
            raise ValueError(f"impl must be 'auto', 'numpy' or 'native', got {impl!r}")
        if np.ndim(u) != 3:
            raise ValueError(f"expected a 3D volume, got {np.ndim(u)}D")
        if impl != "numpy":
            from . import native

            if native.available():
                return native.compute_path_3d(u, locked, x, y, z, step_size, cd_precision,
                                              max_length)
            if impl == "native":
                raise RuntimeError(f"native library unavailable: {native.build_info.get('error')}")
        u = np.asarray(u, dtype=np.float32)
        locked = np.asarray(locked).astype(bool)
        xc, yc, zc = _check_location(u, locked, x, y, z)

        points: list[tuple[float, float, float]] = [
            (float(np.float32(x)), float(np.float32(y)), float(np.float32(z)))
        ]
        x = np.float32(x)
        y = np.float32(y)
        z = np.float32(z)
        d, h, w = u.shape
        while (
            not locked[zc, yc, xc]
            and not _is_stuck(points, step_size)
            and len(points) < max_length
        ):
            px, py, pz = compute_gradient(
                u, locked, float(x), float(y), float(z), cd_precision
            )
            x = np.float32(x + np.float32(px) * np.float32(step_size))
            y = np.float32(y + np.float32(py) * np.float32(step_size))
            z = np.float32(z + np.float32(pz) * np.float32(step_size))
            points.append((float(x), float(y), float(z)))
            xc, yc, zc = _cell_index(x), _cell_index(y), _cell_index(z)
            if xc < 0 or yc < 0 or zc < 0 or xc >= w or yc >= h or zc >= d:
                raise InvalidGradientError(f"walked off the volume at ({x}, {y}, {z})")

        if len(points) <= 2:
            raise InvalidPathError(
                "path has <= 2 points; the field is not relaxed enough yet"
            )
        return np.asarray(points, dtype=np.float32)


def path_reaches_goal(u: np.ndarray, locked: np.ndarray, path: np.ndarray) -> bool:
    """True if the final path point lies in a goal cell (locked, u == 0)."""
    x, y, z = path[-1]
    xc, yc, zc = _cell_index(float(x)), _cell_index(float(y)), _cell_index(float(z))
    d, h, w = u.shape
    if not (0 <= xc < w and 0 <= yc < h and 0 <= zc < d):
        return False
    return bool(locked[zc, yc, xc]) and float(u[zc, yc, xc]) == float(
        C.LOG_SPACE_GOAL
    )
