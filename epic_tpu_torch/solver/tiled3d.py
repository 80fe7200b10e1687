"""The temporally blocked 3D tile family in plain torch: the reference
version of the CUDA kernels in ``csrc/tile3d.cu``.

The counterpart of ``epic_tpu.solver.pallas_biggrid3d`` (plane bands),
``pallas_tiled3d`` (z-band x y-tile x x-tile slabs) and the 3D half of
``pallas_cycle``. Those stage their layouts through TPU VMEM; here, as in
the kernels, a volume is cut into ``tile = (TD, TH, TW)`` centres of the
unpadded ``D x H x W`` volume (the last tiles along each axis ragged), and
each centre is swept together with a ``k``-deep halo on all six faces. A
sweep ``s`` of a chunk updates a halo-extended voxel only if

- its local z, y and x all lie in ``(s, ext - 1 - s)`` (the trapezoid of
  ``pallas_tiled3d.py:196-200``, shrinking on every axis);
- it is unlocked and off the volume's shell (voxels outside the volume hold
  ``LOG_SPACE_OBSTACLE`` and never move);
- it is of the class ``(z + y + x) % 2 == (t0 + s) % 2`` in global
  coordinates (3D updates the other class than 2D; ``core.py``'s
  ``flip``).

A chunk of ``num_sweeps <= k`` sweeps writes the centres to a new volume, so
it equals ``core.update_n`` bit for bit for any tile shape, ``k`` above the
tile included. The delta is ``max |u1 - u0|`` over centre voxels: over
every voxel once, never over fill voxels (ROADMAP R7).

The kernels march each tile along z through a ring of planes instead (no z
halo but at a segment's ends, ``csrc/tile3d.cu``); the sweeps they run are
these, so the bits are the same. Here the halo-extended tiles are gathered
into one ``[tiles, TD + 2k, TH + 2k, TW + 2k]`` batch and swept together. The schedules (``spread``,
``tick_schedule``, ``solve_schedule``, ``segment_bounds``) and the runners
over a chunk are :mod:`.tiled`'s, so the plain and the kernel routes sweep
the same chunks in 2D and 3D. The CPU tests use these functions, and
``chip_smoke.py`` holds the kernels against them on the card; the card's
main path never comes here.
"""

from __future__ import annotations

import torch

from .. import constants as C
from ..grid import GridState
from ._sweep_body import lse6
from .tiled import cycle, protocol_solve, segment_bounds, solve_schedule, spread, tick, \
    tick_schedule

__all__ = ["sweep_chunk", "sweep_cycle", "update_n", "solve", "solve_segments", "spread",
           "tick_schedule", "solve_schedule", "segment_bounds", "calls"]

calls = {"update_n": 0, "solve": 0}


def _tile_grid(shape, tile) -> tuple[int, int, int]:
    return tuple(-(-n // t) for n, t in zip(shape, tile))


def _blocks(x: torch.Tensor, fill, k: int, tile) -> torch.Tensor:
    """The halo-extended tiles of ``x`` as ``[tiles, TD + 2k, TH + 2k,
    TW + 2k]``, ``fill`` outside the volume; tiles in (z, y, x) order, x
    fastest."""
    d, h, w = x.shape
    nz, ny, nx = _tile_grid(x.shape, tile)
    td, th, tw = tile
    padded = x.new_full((nz * td + 2 * k, ny * th + 2 * k, nx * tw + 2 * k), fill)
    padded[k:k + d, k:k + h, k:k + w] = x
    return _unfold(padded, k, tile)


def _unfold(padded: torch.Tensor, k: int, tile) -> torch.Tensor:
    """The overlapping ``[TD + 2k, TH + 2k, TW + 2k]`` windows of a padded
    volume, one a tile."""
    td, th, tw = tile
    ext = (padded.unfold(0, td + 2 * k, td).unfold(1, th + 2 * k, th)
           .unfold(2, tw + 2 * k, tw))
    return ext.reshape(-1, td + 2 * k, th + 2 * k, tw + 2 * k)


def _centres(blocks: torch.Tensor, shape, k: int, tile) -> torch.Tensor:
    """The tiles' centres reassembled into a ``D x H x W`` volume."""
    d, h, w = shape
    td, th, tw = tile
    nz, ny, nx = _tile_grid(shape, tile)
    c = blocks[:, k:k + td, k:k + th, k:k + tw].reshape(nz, ny, nx, td, th, tw)
    c = c.permute(0, 3, 1, 4, 2, 5).reshape(nz * td, ny * th, nx * tw)
    return c[:d, :h, :w].contiguous()


def _check_layout(k: int, tile) -> None:
    if k < 1 or len(tile) != 3 or min(tile) < 1:
        raise ValueError(f"need k >= 1 and a tile of at least 1 x 1 x 1, got k={k}, "
                         f"tile={tile}")


def _frozen_and_parity(locked: torch.Tensor, k: int, tile):
    """Per tile: which voxels never move (locked, the volume's shell, fill)
    and each voxel's global class ``(z + y + x) % 2``."""
    fixed = locked.clone()
    for axis in range(3):
        fixed.select(axis, 0).fill_(True)
        fixed.select(axis, -1).fill_(True)
    frozen = _blocks(fixed, True, k, tile)
    nz, ny, nx = _tile_grid(locked.shape, tile)
    td, th, tw = tile
    # Padded coordinates are global ones plus k on every axis.
    dev = locked.device
    z = torch.arange(nz * td + 2 * k, device=dev)[:, None, None]
    y = torch.arange(ny * th + 2 * k, device=dev)[None, :, None]
    x = torch.arange(nx * tw + 2 * k, device=dev)[None, None, :]
    cls = ((z + y + x - 3 * k) % 2).to(torch.uint8)
    return frozen, _unfold(cls, k, tile)


def _sweep_blocks(u, frozen, parity, t, s: int) -> None:
    """Sweep ``s`` of a chunk, in place on the batch of tiles: the class
    of iteration ``t``, inside the trapezoid."""
    ed, eh, ew = u.shape[1:]
    win = u[:, s:ed - s, s:eh - s, s:ew - s]
    c = slice(1, -1)
    val = lse6(win[:, :-2, c, c], win[:, 2:, c, c], win[:, c, :-2, c], win[:, c, 2:, c],
               win[:, c, c, :-2], win[:, c, c, 2:])
    inner = (slice(None), slice(s + 1, ed - 1 - s), slice(s + 1, eh - 1 - s),
             slice(s + 1, ew - 1 - s))
    update = (parity[inner] == t % 2) & ~frozen[inner]
    u[inner] = torch.where(update, val, u[inner])


def sweep_chunk(src: torch.Tensor, locked: torch.Tensor, iteration, num_sweeps: int, *,
                k: int, tile, u1: bool = False):
    """``num_sweeps`` (1..k) sweeps from ``iteration`` (an int or a 0-d
    tensor), tile by tile. Returns ``(dst, delta, u1)``: the new volume, the
    delta of the first sweep, and with ``u1=True`` the volume after that
    sweep (else None). ``src`` is not modified."""
    _check_layout(k, tile)
    if src.ndim != 3:
        raise ValueError(f"tiled3d takes a 3D volume, got {src.ndim}D")
    if not 1 <= num_sweeps <= k:
        raise ValueError(f"a chunk runs 1..k={k} sweeps, got {num_sweeps}")
    shape = tuple(src.shape)
    td, th, tw = tile
    centre = (slice(None), slice(k, k + td), slice(k, k + th), slice(k, k + tw))
    frozen, parity = _frozen_and_parity(locked, k, tile)
    u = _blocks(src, float(C.LOG_SPACE_OBSTACLE), k, tile)
    u0 = u[centre].clone()
    _sweep_blocks(u, frozen, parity, iteration, 0)
    delta = (u[centre] - u0).abs().max()
    first = _centres(u, shape, k, tile) if u1 else None
    for s in range(1, num_sweeps):
        _sweep_blocks(u, frozen, parity, iteration + s, s)
    return _centres(u, shape, k, tile), delta, first


def sweep_cycle(a: torch.Tensor, b: torch.Tensor, locked: torch.Tensor, iteration,
                n_chunks: int, num_sweeps: int | None = None, *, k: int, tile):
    """``num_sweeps`` sweeps (default ``n_chunks * k``) spread over
    ``n_chunks`` ping-pong chunks (:func:`.tiled.sweep_cycle`'s contract,
    and ``pallas_cycle.sweep_cycle3d``'s): ``(a', b', deltas)``, the state
    in ``a'`` for an even count and in ``b'`` for an odd one."""
    return cycle(sweep_chunk, a, b, locked, iteration, n_chunks, num_sweeps, k=k, tile=tile)


def update_n(state: GridState, num_steps: int, *, k: int, tile) -> GridState:
    """``num_steps`` sweeps in the wrapper's chunk schedule
    (:func:`.tiled.tick_schedule`), delta from the first; equals
    ``core.update_n`` bit for bit."""
    calls["update_n"] += 1
    return tick(sweep_chunk, state, num_steps, k=k, tile=tile)


def solve(state: GridState, stagger: int = C.DEFAULT_STAGGER, max_iterations: int = 1_000_000,
          *, k: int, tile) -> GridState:
    """Relax to convergence with ``core.solve``'s protocol, the check folded
    into the first chunk of each stagger cycle; equals ``core.solve`` bit for
    bit."""
    calls["solve"] += 1
    return protocol_solve(sweep_chunk, state, stagger, max_iterations, k=k, tile=tile)


def solve_segments(state: GridState, stagger: int = C.DEFAULT_STAGGER,
                   max_iterations: int = 1_000_000, segment_iterations: int = 5_000, *,
                   k: int, tile) -> GridState:
    """:func:`solve` in segments ending at :func:`.tiled.segment_bounds`
    (``pallas_biggrid3d.solve_segments``, ``pallas_tiled3d.
    solve_segments``); bit-identical to one solve."""
    calls["solve"] += 1
    return protocol_solve(sweep_chunk, state, stagger, max_iterations, segment_iterations, k=k,
                          tile=tile)
