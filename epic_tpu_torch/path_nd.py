"""Streamline extraction from a relaxed N-dimensional log-potential.

A copy of ``epic_tpu.path_nd`` (NumPy only). The reference walks 2D fields
only (harmonic_path_cpu.cpp); this package adds 3D
(:mod:`epic_tpu_torch.path3d`) and — with the N-D solver
(:mod:`epic_tpu_torch.solver.core` for any rank, on any device; the
reference stubs 4D out at harmonic_cpu.cpp:193-195) — this rank-generic
walker, so 4D+ fields are usable end-to-end too.

Same design as the 3D walker (the *fixed*, non-extrapolating interpolation
variant; there is no reference N-D behaviour to replicate):

- potential at a continuous point = multilinear interpolation of the 2^n
  surrounding cell centres, lerped innermost-to-outermost over the LAST
  array axis first (the same nesting order as the 2D/3D walkers);
- gradient = central differences at ``cd_precision`` per axis, normalised
  to unit length (norm accumulated in f64, rounded once);
- gradient ascent with the reference's stuck check (history 5, radius
  step_size/2) and the <= 2-point anytime rejection.

COORDINATES ARE IN ARRAY-AXIS ORDER: ``pos[i]`` indexes ``u``'s axis ``i``
(so a 3D position here is ``(z, y, x)``). The 2D/3D walkers keep their
reference-parity ``(x, y[, z])`` order; this module is the rank-generic
API and follows NumPy indexing instead.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from . import constants as C
from .errors import (
    InvalidGradientError,
    InvalidLocationError,
    InvalidPathError,
)
from .path_common import cell_index as _cell_index


def _check_location(u: np.ndarray, locked: np.ndarray,
                    pos: Sequence[float]) -> tuple[int, ...]:
    cell = tuple(_cell_index(p) for p in pos)
    if any(c < 0 or c >= s for c, s in zip(cell, u.shape)):
        raise InvalidLocationError(f"{tuple(pos)} outside the grid")
    if locked[cell] and u[cell] < 0.0:
        raise InvalidLocationError(f"{tuple(pos)} is inside an obstacle")
    return cell


def compute_potential(u: np.ndarray, locked: np.ndarray,
                      pos: Sequence[float]) -> float:
    """Multilinear interpolation of the 2^n surrounding cell centres."""
    _check_location(u, locked, pos)
    base = tuple(
        min(int(np.float32(p)), s - 2) for p, s in zip(pos, u.shape)
    )
    frac = [np.float32(p) - np.float32(b) for p, b in zip(pos, base)]
    vals = u[tuple(slice(b, b + 2) for b in base)].astype(np.float32)
    one = np.float32(1.0)
    # Reduce the LAST axis first — the same lerp nesting as the 2D walker's
    # rows-then-columns and the 3D walker's x-then-y-then-z.
    for axis in reversed(range(u.ndim)):
        a = frac[axis]
        vals = (one - a) * vals[..., 0] + a * vals[..., 1]
    return float(vals)


def compute_gradient(
    u: np.ndarray,
    locked: np.ndarray,
    pos: Sequence[float],
    cd_precision: float = C.DEFAULT_CD_PRECISION,
) -> tuple[float, ...]:
    """Unit-normalised central-difference gradient (2n potential samples)."""
    nd = u.ndim
    comps = []
    try:
        for axis in range(nd):
            lo = list(pos)
            hi = list(pos)
            lo[axis] -= cd_precision
            hi[axis] += cd_precision
            v_lo = compute_potential(u, locked, lo)
            v_hi = compute_potential(u, locked, hi)
            cd2 = np.float32(2.0) * np.float32(cd_precision)
            comps.append((np.float32(v_hi) - np.float32(v_lo)) / cd2)
    except InvalidLocationError as e:
        raise InvalidGradientError(str(e)) from e
    denom = np.float32(
        np.sqrt(sum(np.float64(c) * np.float64(c) for c in comps))
    )
    if denom == 0.0 or not np.isfinite(denom):
        raise InvalidGradientError(f"zero/NaN gradient at {tuple(pos)}")
    return tuple(float(c / denom) for c in comps)


def _is_stuck(points: list[tuple[float, ...]], step_size: float) -> bool:
    n = len(points)
    if n == 0:
        return False
    last = np.asarray(points[-1])
    lo = max(0, n - 1 - C.PATH_STUCK_HISTORY_LENGTH)
    for i in range(n - 2, lo - 1, -1):
        if np.sqrt(np.sum((last - np.asarray(points[i])) ** 2)) < step_size / 2.0:
            return True
    return False


def compute_path(
    u: np.ndarray,
    locked: np.ndarray,
    start: Sequence[float],
    step_size: float = C.DEFAULT_STEP_SIZE,
    cd_precision: float = C.DEFAULT_CD_PRECISION,
    max_length: int = C.DEFAULT_MAX_LENGTH,
) -> np.ndarray:
    """Gradient-ascent streamline from ``start`` (array-axis order).

    Returns float32 [k, n] points. Raises InvalidLocationError /
    InvalidGradientError / InvalidPathError with the 2D walker's contract.
    """
    u = np.asarray(u, dtype=np.float32)
    locked = np.asarray(locked).astype(bool)
    if u.ndim < 2:
        raise ValueError(f"expected a rank >= 2 grid, got {u.ndim}D")
    if len(start) != u.ndim:
        raise ValueError(f"start has {len(start)} coords for a {u.ndim}D grid")
    cell = _check_location(u, locked, start)

    pos = [np.float32(p) for p in start]
    points: list[tuple[float, ...]] = [tuple(float(p) for p in pos)]
    while (
        not locked[cell]
        and not _is_stuck(points, step_size)
        and len(points) < max_length
    ):
        grad = compute_gradient(
            u, locked, [float(p) for p in pos], cd_precision
        )
        pos = [
            np.float32(p + np.float32(g) * np.float32(step_size))
            for p, g in zip(pos, grad)
        ]
        points.append(tuple(float(p) for p in pos))
        cell = tuple(_cell_index(float(p)) for p in pos)
        if any(c < 0 or c >= s for c, s in zip(cell, u.shape)):
            raise InvalidGradientError(f"walked off the grid at {points[-1]}")

    if len(points) <= 2:
        raise InvalidPathError(
            "path has <= 2 points; the field is not relaxed enough yet"
        )
    return np.asarray(points, dtype=np.float32)


def path_reaches_goal(u: np.ndarray, locked: np.ndarray,
                      path: np.ndarray) -> bool:
    """True if the final path point lies in a goal cell (locked, u == 0)."""
    cell = tuple(_cell_index(float(p)) for p in path[-1])
    if any(c < 0 or c >= s for c, s in zip(cell, u.shape)):
        return False
    return bool(locked[cell]) and float(u[cell]) == float(C.LOG_SPACE_GOAL)
