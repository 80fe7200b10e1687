"""The resident 3D route of a z-only mesh: whole planes and guard planes.

The counterpart of ``epic_tpu.parallel.resident_z``. There, over a z-only
mesh (``make_mesh3d((n, 1, 1))``) each shard keeps its whole H x W planes
with K guard planes a side in the plane-banded layout, and every chunk is
the ping-pong plane-band kernel ``_resident_z_kernel`` (K21): the shard's
global z origin in the parity, a plane trapezoid, the sweep-0 delta masked
to the interior planes. In the port that is what :mod:`.sharded3d` lays out
on such a mesh anyway (only z is cut, so a block is ``d_loc + 2K`` whole
planes), and this route is its ``kernel="resident"``: the device entries
(:mod:`.hopper_resident3d`) where one device of one process holds the mesh,
each shard's z faces read from its neighbours' planes in place; the
per-shard entry (``epic_shard3d_chunk``) after a halo exchange where a
neighbour lives on another device or process, as in the multi-process
``solve_resident_z``. Either delta is K21's max over the shards (see
:mod:`.hopper_shard3d`). The VMEM plane-band layout (``_layout``,
``_pad_resident``, the fresh twin) is not ported (ROADMAP, "Do not port").

``eligible`` is the port's own shape rule: any shard of at least one plane
(ROADMAP R3: shards of one or an odd number of planes give core's bits;
the per-shard depth is then ``min(chunk_depth, d_loc)``).
"""

from __future__ import annotations

from .. import constants as C
from ..grid import GridState
from . import sharded3d
from .resident3d import check_interpret
from .sharded import Mesh

DEFAULT_CHUNK_DEPTH = sharded3d.DEFAULT_CHUNK_DEPTH


def eligible(d_loc: int, h: int, w: int, chunk_depth: int = DEFAULT_CHUNK_DEPTH) -> bool:
    """Whether a ``d_loc x h x w`` z shard takes the route: any shard of at
    least one plane (``chunk_depth`` is the reference's argument; no depth
    limits the route)."""
    return min(d_loc, h, w) >= 1 and chunk_depth >= 1


def check_mesh(shape, mesh: Mesh, interpret: bool | None = None) -> None:
    """Refuse what the route does not serve: a mesh without a z axis, or
    one that cuts the planes too, and an ``interpret`` that names the other
    device's route."""
    if not sharded3d._has_z(mesh):
        raise ValueError("the z-resident route needs a z-sharded mesh (make_mesh3d((n, 1, 1))); "
                         "plane-sharded meshes take parallel.resident3d")
    if mesh.shape["my"] != 1 or mesh.shape["mx"] != 1:
        raise ValueError("the z-resident route shards z ONLY (my = mx = 1); mixed z and plane "
                         "meshes take sharded3d kernel='auto'")
    dp, hp, wp = sharded3d.padded_shape(shape, mesh)
    if not eligible(dp // mesh.shape["mz"], hp, wp):
        raise ValueError(f"the z-resident route has no shard for a {tuple(shape)} volume")
    check_interpret(interpret, mesh)


def update_n(state: GridState, num_steps: int, mesh: Mesh,
             chunk_depth: int = DEFAULT_CHUNK_DEPTH, interpret: bool | None = None) -> GridState:
    """``core.update_n``'s semantics on a z-only mesh, the delta the first
    sweep's."""
    check_mesh(state.u.shape, mesh, interpret)
    return sharded3d.update_entry(state, num_steps, mesh, chunk_depth, "resident")


def solve(state: GridState, mesh: Mesh, stagger: int = C.DEFAULT_STAGGER,
          max_iterations: int = 1_000_000, chunk_depth: int = DEFAULT_CHUNK_DEPTH,
          interpret: bool | None = None) -> GridState:
    """``core.solve``'s protocol on a z-only mesh."""
    check_mesh(state.u.shape, mesh, interpret)
    return sharded3d.solve_entry(state, mesh, stagger, max_iterations, chunk_depth, None,
                                 "resident")


def solve_segments(state: GridState, mesh: Mesh, stagger: int = C.DEFAULT_STAGGER,
                   max_iterations: int = 1_000_000, segment_iterations: int = 2_000,
                   chunk_depth: int = DEFAULT_CHUNK_DEPTH,
                   interpret: bool | None = None) -> GridState:
    """:func:`solve`, paused at stagger-aligned bounds every
    ``segment_iterations``: the same trajectory."""
    check_mesh(state.u.shape, mesh, interpret)
    return sharded3d.solve_entry(state, mesh, stagger, max_iterations, chunk_depth,
                                 segment_iterations, "resident")
