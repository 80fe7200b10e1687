"""Coarse-to-fine cascade warm start for the log-space solver.

The counterpart of ``epic_tpu.solver.cascade``. The reference always relaxes
from the cold field (free cells at EPIC_LOG_SPACE_FREE = -1e6,
harmonic_cpu.cpp:153-158), so a solve to convergence costs O(diameter)
sweeps *of the full grid*. Information in a harmonic relaxation propagates
one cell per sweep, which a resolution pyramid short-cuts: solve a
2^L-downsampled copy first (diameter/2^L sweeps of a 4^-L-sized grid),
upsample the log-potential as the warm field, repeat. The FINAL level runs
the unmodified reference protocol (stagger-100 checks, non-sticky exit,
``iter >= max(shape)`` guard) on the full grid, so the result carries the
same convergence certificate as a cold solve; only ``iteration`` (the
number of sweeps that certificate took) differs.

An OPT-IN accelerator: nothing in the core protocol changes, and cold
starts stay the default everywhere.

Level construction (NumPy, on the host):

- cell types coarsen 2x2 (2x2x2 in 3D) with goal-wins-then-obstacle
  priority: any goal child -> GOAL, else any obstacle child -> OBSTACLE,
  else FREE. Goal-wins keeps every goal basin present at every level;
  obstacle-wins-over-free keeps thin walls closed (paths can only
  *disappear* at coarse levels, never tunnel through walls, so the warm
  field is conservative).
- the upsampled log-potential seeds only FREE fine cells (nearest-neighbour
  repeat); locked cells are pinned to their exact values (0 / -1e6), and
  fine FREE cells under a coarse OBSTACLE parent fall back to the cold
  LOG_SPACE_FREE init.

Each level's state is built on the input state's device, one host-to-device
copy of ``u`` and ``locked`` a level; each level's field comes back to the
host in one copy. On the card the default solver (:func:`solve_grid`'s
route) runs every 2D level on the in-place kernels (K2) or, past two thirds
of the L2, the tile solve, and every 3D level on K7.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .. import constants as C
from ..grid import GridState, _host, make_state


@dataclasses.dataclass(frozen=True)
class CascadeStats:
    """Per-level iteration counts, coarsest first; total includes every
    level (coarse sweeps are ~4^-L as expensive as fine ones in 2D)."""

    iterations: tuple[int, ...]
    shapes: tuple[tuple[int, ...], ...]

    @property
    def total_fine_equivalent(self) -> float:
        """Total cost in fine-grid-sweep equivalents."""
        fine_cells = float(np.prod(self.shapes[-1]))
        return sum(
            it * float(np.prod(s)) / fine_cells
            for it, s in zip(self.iterations, self.shapes)
        )


def _coarsen_masks(goal: np.ndarray, obstacle: np.ndarray):
    """2x (per axis) downsample of cell-type masks, goal > obstacle > free."""
    nd = goal.ndim
    pad = [(0, (-goal.shape[i]) % 2) for i in range(nd)]
    g = np.pad(goal, pad)          # padding: neither goal nor obstacle...
    o = np.pad(obstacle, pad, constant_values=True)  # ...but blocked.
    for ax in range(nd):
        g = np.logical_or.reduce(
            g.reshape(g.shape[:ax] + (g.shape[ax] // 2, 2) + g.shape[ax + 1:]),
            axis=ax + 1,
        )
        o = np.logical_or.reduce(
            o.reshape(o.shape[:ax] + (o.shape[ax] // 2, 2) + o.shape[ax + 1:]),
            axis=ax + 1,
        )
    o = o & ~g
    # The boundary must stay blocked at every level (interior-only updates).
    for ax in range(nd):
        sl0 = [slice(None)] * nd
        sl1 = [slice(None)] * nd
        sl0[ax] = 0
        sl1[ax] = -1
        for sl in (tuple(sl0), tuple(sl1)):
            o[sl] = o[sl] | ~g[sl]
    return g, o


def _upsample(u_coarse: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """Nearest-neighbour 2x upsample cropped to ``shape`` (a view: the
    level's state copies it contiguous)."""
    u = u_coarse
    for ax in range(u.ndim):
        u = np.repeat(u, 2, axis=ax)
    return u[tuple(slice(0, s) for s in shape)]


def _masks_of(state: GridState):
    u = _host(state.u)
    locked = _host(state.locked).astype(bool)
    goal = locked & (u == np.float32(C.LOG_SPACE_GOAL))
    obstacle = locked & ~goal
    return goal, obstacle


def _state_from_masks(goal, obstacle, epsilon, device, u_warm=None) -> GridState:
    u = np.where(goal, np.float32(C.LOG_SPACE_GOAL),
                 np.float32(C.LOG_SPACE_FREE)).astype(np.float32)
    if u_warm is not None:
        u_warm = u_warm[tuple(slice(0, s) for s in goal.shape)]
        free = ~(goal | obstacle)
        u = np.where(free, u_warm.astype(np.float32), u)
        u = np.where(obstacle, np.float32(C.LOG_SPACE_OBSTACLE), u)
    # np.where returns a fresh C-contiguous array, and make_state copies it
    # once to the device (contiguous and aligned, as the kernels need).
    return make_state(np.ascontiguousarray(u), goal | obstacle, epsilon, device=device)


@dataclasses.dataclass(frozen=True)
class _HostOut:
    u: np.ndarray
    iteration: int
    delta: float
    converged: bool


def native_solver(st: GridState, stagger: int, max_iterations: int):
    """Coarse-level solver on the native C++ whole solve
    (:func:`epic_tpu_torch.native.solve_2d`, 2D only): no device work, so
    the small pyramid levels cost no launches or copies to the card. The
    field comes back on the host; the next level's state moves it to the
    input state's device in its one copy."""
    from .. import native

    u, iters, delta, converged = native.solve_2d(
        _host(st.u), _host(st.locked),
        epsilon=float(st.epsilon),
        stagger=stagger, max_iterations=max_iterations,
    )
    return _HostOut(u=u, iteration=iters, delta=delta, converged=converged)


def solve_cascade(
    state: GridState,
    levels: int | None = None,
    min_extent: int = 48,
    stagger: int = C.DEFAULT_STAGGER,
    max_iterations: int = 1_000_000,
    solver=None,
    coarse_solver=None,
):
    """Solve to convergence through a resolution cascade.

    Returns ``(out_state, CascadeStats)``. ``out_state`` satisfies the exact
    reference convergence protocol on the full grid (same ``converged``
    /``delta`` semantics as :func:`core.solve`); ``iteration`` is the fine-
    level count only; see stats for the per-level breakdown. Every level's
    state lives on ``state``'s device.

    ``solver(state, stagger=..., max_iterations=...)`` defaults to
    :func:`epic_tpu_torch.solver.solve_grid` (the plain version on the CPU;
    on the card K2 or the tile solve in 2D, K7 in 3D). ``coarse_solver``
    overrides the solver for the non-final levels (e.g.
    :func:`native_solver` to keep small levels on the host); defaults to
    ``solver``.
    """
    if solver is None:
        solver = _auto_solver()
    if coarse_solver is None:
        coarse_solver = solver

    device = state.u.device
    goal, obstacle = _masks_of(state)
    eps = float(state.epsilon)

    pyramid = [(goal, obstacle)]
    if levels is None:
        levels = 0
        g, o = goal, obstacle
        while min(g.shape) // 2 >= min_extent and g.any():
            g, o = _coarsen_masks(g, o)
            if not g.any():
                break
            pyramid.append((g, o))
            levels += 1
    else:
        g, o = goal, obstacle
        for _ in range(levels):
            g, o = _coarsen_masks(g, o)
            if not g.any():
                break
            pyramid.append((g, o))

    iterations: list[int] = []
    shapes: list[tuple[int, ...]] = []
    u_warm = None
    for g, o in reversed(pyramid[1:]):
        st = _state_from_masks(g, o, eps, device, u_warm)
        out = coarse_solver(st, stagger=stagger, max_iterations=max_iterations)
        iterations.append(int(out.iteration))
        shapes.append(tuple(g.shape))
        u_warm = _upsample(_host(out.u), _double_shape(g.shape))

    st = _state_from_masks(goal, obstacle, eps, device, u_warm)
    out = solver(st, stagger=stagger, max_iterations=max_iterations)
    iterations.append(int(out.iteration))
    shapes.append(tuple(goal.shape))
    return out, CascadeStats(tuple(iterations), tuple(shapes))


def _double_shape(shape):
    return tuple(2 * s for s in shape)


def _auto_solver():
    from . import solve_grid

    def solver(st, stagger, max_iterations):
        return solve_grid(st, stagger=stagger, max_iterations=max_iterations)

    return solver
