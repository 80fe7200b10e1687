"""Solution-quality metrics: the paper's percent-valid-streamlines analysis.

A copy of ``epic_tpu.analysis`` (NumPy only). Re-creates the reference's
benchmark oracle (its libepic/tests/batch/batch.py:52-102 and
compare_precision.py:75-189): a free cell is "valid" when

  1. the central-difference gradient of the solved field at the cell has
     norm > 1e-10 (not flat / underflowed), and
  2. the cell can reach a goal by flood fill over valid cells (so its
     streamline has somewhere to go).

This is the headline quality metric: the log-space solver keeps ~100% of
free cells valid on large maps, while float SOR collapses. An optional
third stage actually walks streamlines from sampled cells
(:func:`streamline_success_rate`).
"""

from __future__ import annotations

import numpy as np


def gradient_norms(u: np.ndarray) -> np.ndarray:
    """Central-difference gradient norm per interior cell (cells outside the
    interior get 0). Works on 2D grids and 3D volumes alike."""
    u = np.asarray(u, dtype=np.float64)
    sq = np.zeros_like(u)
    for axis in range(u.ndim):
        g = np.zeros_like(u)
        mid = tuple(
            slice(1, -1) if a == axis else slice(None) for a in range(u.ndim)
        )
        hi = tuple(
            slice(2, None) if a == axis else slice(None) for a in range(u.ndim)
        )
        lo = tuple(
            slice(None, -2) if a == axis else slice(None) for a in range(u.ndim)
        )
        g[mid] = (u[hi] - u[lo]) / 2.0
        sq += g * g
    return np.sqrt(sq)


def valid_gradient_mask(u: np.ndarray, threshold: float = 1e-10) -> np.ndarray:
    """Cells whose gradient is not flat (compare_precision.py:100-114)."""
    return gradient_norms(u) > threshold


def reachable_from(seed_mask: np.ndarray, passable: np.ndarray) -> np.ndarray:
    """Face-connected flood fill from seed cells over passable cells
    (compare_precision.py:125-142): 4-connected on 2D grids, 6-connected on
    3D volumes. Vectorized frontier dilation (one shift pair per axis per
    round) — O(diameter) numpy passes, no Python per-cell loop."""
    passable = np.asarray(passable).astype(bool)
    reached = np.asarray(seed_mask).astype(bool).copy()
    nd = passable.ndim
    while True:
        frontier = np.zeros_like(reached)
        for axis in range(nd):
            lo = tuple(
                slice(1, None) if a == axis else slice(None) for a in range(nd)
            )
            hi = tuple(
                slice(None, -1) if a == axis else slice(None) for a in range(nd)
            )
            frontier[lo] |= reached[hi]
            frontier[hi] |= reached[lo]
        new = frontier & passable & ~reached
        if not new.any():
            return reached
        reached |= new


def percent_valid(
    u: np.ndarray,
    locked: np.ndarray,
    goal_mask: np.ndarray,
    gradient_threshold: float = 1e-10,
) -> float:
    """Fraction of free cells that are gradient-valid AND goal-reachable over
    gradient-valid cells — the reference's "Percent Valid" column
    (batch.py:105-164)."""
    locked = np.asarray(locked).astype(bool)
    free = ~locked
    if not free.any():
        return 1.0
    grad_ok = valid_gradient_mask(u, gradient_threshold)
    passable = (grad_ok & free) | goal_mask
    reached = reachable_from(goal_mask, passable)
    valid = reached & free
    return float(valid.sum() / free.sum())


def streamline_success_rate(
    u: np.ndarray,
    locked: np.ndarray,
    goal_mask: np.ndarray,
    n_samples: int = 200,
    seed: int = 0,
    log_space: bool = True,
    flipped: bool = False,
    mode: str = "bilinear",
    step_size: float = 0.2,
    cd_precision: float = 0.4,
) -> float:
    """Walk actual streamlines from sampled free cells; fraction ending in a
    goal cell. ``log_space`` selects the log-potential walker
    (epic_tpu_torch.path) vs the legacy linear walker (solver.legacy)."""
    from . import path as path_mod
    from .errors import EpicError
    from .solver import legacy as legacy_mod

    locked = np.asarray(locked).astype(bool)
    free_ys, free_xs = np.nonzero(~locked)
    if len(free_ys) == 0:
        return 1.0
    rng = np.random.default_rng(seed)
    n = min(n_samples, len(free_ys))
    idx = rng.choice(len(free_ys), size=n, replace=False)
    ok = 0
    for i in idx:
        x, y = float(free_xs[i]), float(free_ys[i])
        try:
            if log_space:
                pts = path_mod.compute_path(
                    u, locked, x, y, step_size, cd_precision, mode=mode
                )
            else:
                pts = legacy_mod.compute_path(
                    u, locked, x, y, step_size, cd_precision,
                    flipped=flipped, mode=mode,
                )
        except EpicError:
            continue
        ex, ey = pts[-1]
        xc, yc = int(ex + 0.5), int(ey + 0.5)
        if 0 <= yc < u.shape[0] and 0 <= xc < u.shape[1] and goal_mask[yc, xc]:
            ok += 1
    return ok / n
