"""Streamline (path) extraction from the relaxed log-potential.

Host-side, float32, semantics matched to the reference's scalar CPU loop
(the reference's libepic/src/harmonic/harmonic_path_cpu.cpp):

- potential at a continuous "float pixel" = bilinear interpolation of the 4
  surrounding cell centres (corner indices from truncating x±0.5, y±0.5;
  weights alpha/beta measured from the top-left corner) (:41-82);
- gradient = central differences of the interpolated potential at precision
  ``cd_precision``, then normalised to unit length (:85-118);
- path loop: gradient *ascent* (goals hold the maximum, u = 0) with step
  ``step_size`` until a locked cell is reached, the point budget is
  exhausted, or a stuck check against the last 5 points fires (:121-205);
- a path of <= 2 points raises InvalidPathError — the anytime contract:
  "not relaxed enough yet, keep relaxing and retry" (:207-212).

A NumPy copy of ``epic_tpu.path``'s walker: the field is fetched to the
host once per request and walked there. Its native C++ twin with the same
semantics is :mod:`epic_tpu_torch.native` (``impl="auto"`` takes it when it
is built); this module is the always-available walker and the oracle for
it. The batched device walker is :mod:`epic_tpu_torch.solver.batched_path`
(``compute_paths``).
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


def _check_location(u: np.ndarray, locked: np.ndarray, x: float, y: float) -> tuple[int, int]:
    """Start/sample validity (harmonic_path_cpu.cpp:49-58,165-174): the cell
    under the point must be in bounds and not a locked negative-u cell (i.e.
    not an obstacle; goal cells with u = 0 are fine)."""
    h, w = u.shape
    xc = _cell_index(x)
    yc = _cell_index(y)
    if xc < 0 or yc < 0 or xc >= w or yc >= h:
        raise InvalidLocationError(f"({x}, {y}) outside the map")
    if locked[yc, xc] and u[yc, xc] < 0.0:
        raise InvalidLocationError(f"({x}, {y}) is inside an obstacle")
    return xc, yc


def compute_potential(
    u: np.ndarray,
    locked: np.ndarray,
    x: float,
    y: float,
    mode: str = "reference",
) -> float:
    """Interpolated potential at a float pixel.

    mode="reference": exact port of harmonic_path_cpu.cpp:41-82, including its
    quirk — corners from truncating (x±0.5, y±0.5) give alpha/beta in
    [0.5, 1.5), so positions in the lower half of a cell *extrapolate* beyond
    the corner pair. Next to an obstacle (-1e6) the negative weight flips the
    sign, producing a huge positive potential estimate that pulls streamlines
    toward walls, where the stuck detector then truncates them. Faithful to
    the reference's observable behaviour.

    mode="bilinear": proper cell-centre bilinear (corners floor(x), floor(x)+1
    with alpha = x - floor(x) in [0, 1)); never extrapolates, markedly more
    robust near thin walls. Matches "reference" exactly whenever alpha,
    beta <= 1 there (x, y in the upper half of a cell).
    """
    _check_location(u, locked, x, y)
    x = np.float32(x)
    y = np.float32(y)
    h, w = u.shape
    if mode == "reference":
        half = np.float32(0.5)
        xtl = max(int(x - half), 0)
        ytl = max(int(y - half), 0)
        xtr = int(x + half)
        ybl = int(y + half)
    elif mode == "bilinear":
        xtl = min(int(x), w - 2)
        ytl = min(int(y), h - 2)
        xtr = xtl + 1
        ybl = ytl + 1
    else:
        raise ValueError(f"unknown interpolation mode {mode!r}")
    alpha = x - np.float32(xtl)
    beta = y - np.float32(ytl)
    one = (np.float32(1.0) - alpha) * u[ytl, xtl] + alpha * u[ytl, xtr]
    two = (np.float32(1.0) - alpha) * u[ybl, xtl] + alpha * u[ybl, xtr]
    return float((np.float32(1.0) - beta) * one + beta * two)


def compute_gradient(
    u: np.ndarray,
    locked: np.ndarray,
    x: float,
    y: float,
    cd_precision: float = C.DEFAULT_CD_PRECISION,
    mode: str = "reference",
) -> tuple[float, float]:
    """Unit-normalised central-difference gradient
    (harmonic_path_cpu.cpp:85-118). Raises InvalidGradientError if any of the
    4 sample points is invalid or the gradient has zero/NaN norm."""
    try:
        v0 = compute_potential(u, locked, x - cd_precision, y, mode)
        v1 = compute_potential(u, locked, x + cd_precision, y, mode)
        v2 = compute_potential(u, locked, x, y - cd_precision, mode)
        v3 = compute_potential(u, locked, x, y + cd_precision, mode)
    except InvalidLocationError as e:
        raise InvalidGradientError(str(e)) from e
    cd2 = np.float32(2.0) * np.float32(cd_precision)
    px = (np.float32(v1) - np.float32(v0)) / cd2
    py = (np.float32(v3) - np.float32(v2)) / cd2
    # std::pow(px, 2) promotes to double in the reference
    # (harmonic_path_cpu.cpp:113), so the norm is computed in f64 and rounded
    # once — required for bit-exact walks vs the prebuilt binary.
    denom = np.float32(np.sqrt(np.float64(px) * np.float64(px) + np.float64(py) * np.float64(py)))
    if denom == 0.0 or not np.isfinite(denom):
        # The reference divides regardless and lets NaNs poison the walk
        # until a location check fails; we fail fast with the same
        # observable outcome (an INVALID_GRADIENT error).
        raise InvalidGradientError(f"zero/NaN gradient at ({x}, {y})")
    return float(px / denom), float(py / denom)


def _is_stuck(points: list[tuple[float, float]], step_size: float) -> bool:
    """Stuck detection (harmonic_path_cpu.cpp:121-151): the newest point
    within step_size/2 of any of the previous PATH_STUCK_HISTORY_LENGTH
    points."""
    n = len(points)
    if n == 0:
        return False
    x, y = points[-1]
    lo = max(0, n - 1 - C.PATH_STUCK_HISTORY_LENGTH)
    for i in range(n - 2, lo - 1, -1):
        xi, yi = points[i]
        if np.sqrt((x - xi) ** 2 + (y - yi) ** 2) < step_size / 2.0:
            return True
    return False


def compute_path(
    u: np.ndarray,
    locked: np.ndarray,
    x: float,
    y: float,
    step_size: float = C.DEFAULT_STEP_SIZE,
    cd_precision: float = C.DEFAULT_CD_PRECISION,
    max_length: int = C.DEFAULT_MAX_LENGTH,
    mode: str = "reference",
    impl: str = "auto",
) -> np.ndarray:
    """Gradient-ascent streamline from (x, y). Returns float32 [k, 2] of
    (x, y) points (harmonic_path_cpu.cpp:154-221).

    impl: "auto" walks with the native C++ walker when it is built (the
    same points; ``tests/test_torch_native.py``), else in NumPy; "numpy"
    and "native" force one ("native" raises if the library is not built).

    Raises:
      InvalidLocationError: start outside the map or inside an obstacle.
      InvalidGradientError: gradient sampling failed mid-walk.
      InvalidPathError: <= 2 points produced (field not relaxed enough).
    """
    with profiling.span("path.walk"):
        if impl not in ("auto", "numpy", "native"):
            raise ValueError(f"impl must be 'auto', 'numpy' or 'native', got {impl!r}")
        if impl != "numpy":
            from . import native

            if native.available():
                return native.compute_path(u, locked, x, y, step_size, cd_precision, max_length,
                                           mode)
            if impl == "native":
                raise RuntimeError(f"native library unavailable: {native.build_info.get('error')}")
        u = np.asarray(u, dtype=np.float32)
        locked = np.asarray(locked).astype(bool)
        xc, yc = _check_location(u, locked, x, y)

        points: list[tuple[float, float]] = [(float(np.float32(x)), float(np.float32(y)))]
        x = np.float32(x)
        y = np.float32(y)
        while (
            not locked[yc, xc]
            and not _is_stuck(points, step_size)
            and len(points) < max_length
        ):
            px, py = compute_gradient(u, locked, float(x), float(y), cd_precision, mode)
            x = np.float32(x + np.float32(px) * np.float32(step_size))
            y = np.float32(y + np.float32(py) * np.float32(step_size))
            points.append((float(x), float(y)))
            xc = _cell_index(x)
            yc = _cell_index(y)
            if xc < 0 or yc < 0 or xc >= u.shape[1] or yc >= u.shape[0]:
                raise InvalidGradientError(f"walked off the map at ({x}, {y})")

        if len(points) <= 2:
            raise InvalidPathError(
                "path has <= 2 points; the field is not relaxed enough yet"
            )
        return np.asarray(points, dtype=np.float32)


def path_reaches_goal(
    u: np.ndarray, locked: np.ndarray, path: np.ndarray
) -> bool:
    """True if the final path point lies in a goal cell (locked, u == 0)."""
    x, y = path[-1]
    xc, yc = _cell_index(float(x)), _cell_index(float(y))
    h, w = u.shape
    if not (0 <= xc < w and 0 <= yc < h):
        return False
    return bool(locked[yc, xc]) and float(u[yc, xc]) == float(C.LOG_SPACE_GOAL)
