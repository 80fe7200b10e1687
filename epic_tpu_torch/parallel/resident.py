"""The 2D resident route on the shard blocks: ``epic_tpu.parallel.resident``'s
entries.

In ``epic_tpu`` each shard lives permanently in a guard-aligned banded
layout (k guard rows, a 128-lane guard tile a side, tile-pure guard writes),
and every chunk is ``_resident_kernel`` (K16) with the solve loop inside
``shard_map``. In the port a shard already stays resident as its K-extended
block (:mod:`.sharded`), and the resident route runs all of a device's
shards in one launch (:mod:`.hopper_resident2d`: ``epic_resident2d_cycle``
and ``epic_resident2d_solve`` on a card). This module keeps the reference's
entry names over that route, ``sharded``'s ``kernel="resident"``; the TPU
layout (``GC``, ``MIN_WIDTH``, ``_layout``, ``solve_chunk_depth``'s VMEM
budget, the guard exchange) is not ported (ROADMAP, "Do not port").

``eligible`` is the port's own shape rule: the route needs no alignment, so
any shard with a centre takes it. ``interpret`` names the device's route:
None follows the mesh, True the plain version (a CPU mesh), False the
kernels (a card).
"""

from __future__ import annotations

from .. import constants as C
from ..grid import GridState
from . import sharded
from .sharded import Mesh

DEFAULT_CHUNK_DEPTH = sharded.DEFAULT_CHUNK_DEPTH


def eligible(h_loc: int, w_loc: int, chunk_depth: int = DEFAULT_CHUNK_DEPTH) -> bool:
    """Whether ``h_loc x w_loc`` shards take the route: any shard with a
    cell (``chunk_depth`` is the reference's argument; the depth is cut to
    the shard)."""
    return min(h_loc, w_loc) >= 1 and chunk_depth >= 1


def _kernel_name(shape, mesh: Mesh, interpret: bool | None = None) -> str:
    """``sharded``'s kernel name for the route on ``mesh``, after refusing a
    grid of ``shape`` with an empty shard and an ``interpret`` that names
    the other device's route."""
    hp, wp = sharded.padded_shape(tuple(shape), mesh)
    if not eligible(hp // mesh.shape["my"], wp // mesh.shape["mx"]):
        raise ValueError(f"the resident route has no shard for a {tuple(shape)} grid")
    if interpret is not None and bool(interpret) == (mesh.device_type == "cuda"):
        raise ValueError(f"interpret={interpret} names the other device's route; this mesh lies "
                         f"on {mesh.device_type} (use None)")
    return "resident_interpret" if interpret else "resident"


def update_n(state: GridState, num_steps: int, mesh: Mesh,
             chunk_depth: int = DEFAULT_CHUNK_DEPTH, interpret: bool | None = None) -> GridState:
    """``core.update_n``'s semantics on a mesh, the delta the first
    sweep's."""
    kernel = _kernel_name(state.u.shape, mesh, interpret)
    return sharded.update_n(state, num_steps, mesh, chunk_depth, kernel)


def solve(state: GridState, mesh: Mesh, stagger: int = C.DEFAULT_STAGGER,
          max_iterations: int = 1_000_000, chunk_depth: int | None = None,
          interpret: bool | None = None) -> GridState:
    """``core.solve``'s protocol on a mesh. ``chunk_depth=None`` is
    ``sharded``'s default (results do not depend on it)."""
    return solve_segments(state, mesh, stagger, max_iterations, None, chunk_depth, interpret)


def solve_segments(state: GridState, mesh: Mesh, stagger: int = C.DEFAULT_STAGGER,
                   max_iterations: int = 1_000_000, segment_iterations: int | None = 5_000,
                   chunk_depth: int | None = None, interpret: bool | None = None) -> GridState:
    """:func:`solve`, paused at stagger-aligned bounds every
    ``segment_iterations`` (``solver.tiled.segment_bounds``, ROADMAP R4):
    the same trajectory."""
    kernel = _kernel_name(state.u.shape, mesh, interpret)
    depth = DEFAULT_CHUNK_DEPTH if chunk_depth is None else chunk_depth
    return sharded.solve(state, mesh, stagger, max_iterations, depth, kernel, segment_iterations)
