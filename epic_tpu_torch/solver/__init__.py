"""The port's solvers: the plain torch version (``core``) and the CUDA
kernels behind it (``hopper_sweep`` in 2D, ``hopper_tile2d`` for 2D grids
beyond the card's L2, ``hopper_sweep3d`` for every 3D volume, and
``hopper_tile3d``, the 3D tile kernels, when called), with the
library-level entries; the tile families'
plain versions (``tiled``, ``tiled3d``); batched scenario solves over
``[B, H, W]`` lanes in plain torch (``batched``) and on their CUDA kernels
(``hopper_batched``); the coarse-to-fine warm start (``cascade``), the
legacy non-log SOR (``legacy``) and the NumPy oracle (``reference_np``).

A grid of rank 4 or more runs on the plain ``core`` on whatever device
holds it, the card included: the one route on the card without a kernel of
its own, as ``epic_tpu`` runs its XLA core there (no TPU kernel exists for
rank >= 4)."""

from . import (batched, cascade, core, hopper_batched, hopper_sweep, hopper_sweep3d,
               hopper_tile2d, hopper_tile3d, legacy, reference_np, tiled, tiled3d)
from .. import constants as _C
from .. import profiling as _profiling

__all__ = ["batched", "cascade", "core", "hopper_batched", "hopper_sweep", "hopper_sweep3d",
           "hopper_tile2d", "hopper_tile3d", "legacy", "reference_np", "tiled", "tiled3d",
           "solve_grid", "update_grid", "solve_volume", "update_volume"]


def _tiles(state) -> bool:
    return state.u.ndim == 2 and hopper_tile2d.use_tiles(state.u.shape, state.u.device)


def solve_grid(state, stagger=None, max_iterations: int = 1_000_000,
               segment_iterations: int | None = None, chunk_depth: int | None = None):
    """Solve to convergence on whatever device holds ``state`` — the
    counterpart of ``epic_tpu.solver.solve_grid``: the plain version for a
    tensor on the CPU (any rank); on the card, for a 2D grid, the tile
    kernels (``hopper_tile2d``, halo depth ``chunk_depth``, by default its
    ``DEFAULT_DEPTH``) when it exceeds the L2 and the in-place kernels
    (``hopper_sweep``) otherwise; a 3D volume, with both keywords, through
    :func:`solve_volume`; a grid of rank 4 or more, on any device, the plain
    ``core.solve`` (no kernel: the tile keywords are ignored).
    ``segment_iterations`` runs the tile route's solve
    as segments (``solve_segments``); the other routes' solve is one launch
    and ignores it, as ``epic_tpu``'s VMEM route does. Protocol identical on
    every route (harmonic_complete_cpu). A 2D grid's or the plain route's
    solve is the span ``solve.<route>`` (:func:`epic_tpu_torch.profiling.span`):
    ``solve.sweep2d``, ``solve.tile2d``, or ``solve.core`` for a state on
    the CPU or of rank 4 or more."""
    stagger = _C.DEFAULT_STAGGER if stagger is None else stagger
    if state.u.ndim == 3:
        return solve_volume(state, stagger, max_iterations, segment_iterations, chunk_depth)
    if state.u.ndim != 2 or state.u.device.type == "cpu":
        with _profiling.span("solve.core"):
            return core.solve(state, stagger, max_iterations)
    if _tiles(state):
        k = hopper_tile2d.DEFAULT_DEPTH if chunk_depth is None else chunk_depth
        with _profiling.span("solve.tile2d"):
            if segment_iterations is not None:
                return hopper_tile2d.solve_segments(state, stagger, max_iterations,
                                                    segment_iterations, k)
            return hopper_tile2d.solve(state, stagger, max_iterations, k)
    with _profiling.span("solve.sweep2d"):
        return hopper_sweep.solve(state, stagger, max_iterations)


def update_grid(state, num_steps: int, chunk_depth: int | None = None):
    """The anytime stepper on whatever device holds ``state``; routes as
    :func:`solve_grid`, and its spans are ``tick.<route>``."""
    if state.u.ndim == 3:
        return update_volume(state, num_steps, chunk_depth)
    if state.u.ndim != 2 or state.u.device.type == "cpu":
        with _profiling.span("tick.core"):
            return core.update_n(state, num_steps)
    if _tiles(state):
        k = hopper_tile2d.DEFAULT_DEPTH if chunk_depth is None else chunk_depth
        with _profiling.span("tick.tile2d"):
            return hopper_tile2d.update_n(state, num_steps, k)
    with _profiling.span("tick.sweep2d"):
        return hopper_sweep.update_n(state, num_steps)


def solve_volume(state, stagger=None, max_iterations: int = 1_000_000,
                 segment_iterations: int | None = None, chunk_depth: int | None = None):
    """3D solve (``epic_tpu.solver.solve_volume``'s counterpart): the plain
    version for a volume on the CPU, the in-place kernels (``hopper_sweep3d``,
    K7's z walk) for every volume on the card. ``tile_probe.py --volumes``
    measured K7 as fast or faster than the z-marching tile kernels on every
    volume it ran on an H100 (PERF.md), so no volume goes to those. The
    solve is one launch: ``segment_iterations`` and ``chunk_depth``, which
    only a tile route would use, are ignored, as ``epic_tpu``'s VMEM route
    does. The solve is the span ``solve.sweep3d`` on the card, one K7
    solve, and ``solve.core`` on the CPU."""
    stagger = _C.DEFAULT_STAGGER if stagger is None else stagger
    with _profiling.span("solve.core" if state.u.device.type == "cpu" else "solve.sweep3d"):
        return hopper_sweep3d.solve(state, stagger, max_iterations)


def update_volume(state, num_steps: int, chunk_depth: int | None = None):
    """The 3D anytime stepper: ``hopper_sweep3d`` for every volume, as
    :func:`solve_volume`; ``chunk_depth`` is ignored. Its span is
    ``tick.sweep3d``, or ``tick.core`` on the CPU."""
    with _profiling.span("tick.core" if state.u.device.type == "cpu" else "tick.sweep3d"):
        return hopper_sweep3d.update_n(state, num_steps)
