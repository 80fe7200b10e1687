"""The resident 3D route of a plane mesh, on the shard blocks.

The counterpart of ``epic_tpu.parallel.resident3d``. There, each shard of a
plane-sharded mesh (z resident) lives permanently in the tiled3d guard
layout (``_HY``/``_HX`` guard rows and lane tiles, tile-pure guard writes)
and every chunk is K11's slab cycle at ``nc = 1`` (K20) with the
interior-masked sweep-0 delta. In the port a shard already stays resident
as its extended block (:mod:`.sharded3d`), so this route is
:mod:`.sharded3d`'s ``kernel="resident"``: where one device of one process
holds the mesh, the device entries (``epic_resident3d_cycle`` and
``epic_resident3d_solve``, :mod:`.hopper_resident3d`) sweep every shard's
centre in one launch, reading same-device face neighbours directly; where
a face neighbour lives on another device or process, the per-shard entry
(``epic_shard3d_chunk``) runs each chunk after a halo exchange. Either
delta is K20's max over the shards (see :mod:`.hopper_shard3d`). The TPU
guard layouts (``tile_layouts``, ``choose_layout``, ``_pad_resident``, the
fresh twin) are not ported (ROADMAP, "Do not port").

``eligible`` is the port's own shape rule: the entries need no alignment
and no slab budget, so any shard with a centre takes the route.
"""

from __future__ import annotations

from .. import constants as C
from ..grid import GridState
from . import sharded3d
from .sharded import Mesh

DEFAULT_CHUNK_DEPTH = sharded3d.DEFAULT_CHUNK_DEPTH


def eligible(d: int, h_loc: int, w_loc: int, chunk_depth: int = DEFAULT_CHUNK_DEPTH) -> bool:
    """Whether a ``d x h_loc x w_loc`` shard takes the route: any shard
    with at least one voxel on each axis (``chunk_depth`` is the
    reference's argument; no depth limits the route)."""
    return min(d, h_loc, w_loc) >= 1 and chunk_depth >= 1


def check_mesh(shape, mesh: Mesh, interpret: bool | None = None) -> None:
    """Refuse what the route does not serve: a mesh that cuts z (those go
    to :mod:`.resident_z` or the generic route), a shape with an empty
    shard, and an ``interpret`` that names the other device's route."""
    if sharded3d._has_z(mesh):
        raise ValueError("the resident 3D route needs a plane-sharded mesh (z resident); "
                         "z-only meshes take parallel.resident_z")
    dp, hp, wp = sharded3d.padded_shape(shape, mesh)
    if not eligible(dp, hp // mesh.shape["my"], wp // mesh.shape["mx"]):
        raise ValueError(f"the resident 3D route has no shard for a {tuple(shape)} volume")
    check_interpret(interpret, mesh)


def check_interpret(interpret: bool | None, mesh: Mesh) -> None:
    """``interpret=True`` names the plain version (a CPU mesh), False the
    CUDA entry (a card); None follows the mesh."""
    on_card = mesh.device_type == "cuda"
    if interpret is not None and bool(interpret) == on_card:
        raise ValueError(f"interpret={interpret} names the other device's route; this mesh "
                         f"lies on {mesh.device_type} (use None)")


def update_n(state: GridState, num_steps: int, mesh: Mesh,
             chunk_depth: int = DEFAULT_CHUNK_DEPTH, interpret: bool | None = None) -> GridState:
    """``core.update_n``'s semantics on a plane mesh, the delta the first
    sweep's."""
    check_mesh(state.u.shape, mesh, interpret)
    return sharded3d.update_entry(state, num_steps, mesh, chunk_depth, "resident")


def solve(state: GridState, mesh: Mesh, stagger: int = C.DEFAULT_STAGGER,
          max_iterations: int = 1_000_000, chunk_depth: int = DEFAULT_CHUNK_DEPTH,
          interpret: bool | None = None) -> GridState:
    """``core.solve``'s protocol on a plane mesh."""
    check_mesh(state.u.shape, mesh, interpret)
    return sharded3d.solve_entry(state, mesh, stagger, max_iterations, chunk_depth, None,
                                 "resident")


def solve_segments(state: GridState, mesh: Mesh, stagger: int = C.DEFAULT_STAGGER,
                   max_iterations: int = 1_000_000, segment_iterations: int = 2_000,
                   chunk_depth: int = DEFAULT_CHUNK_DEPTH,
                   interpret: bool | None = None) -> GridState:
    """:func:`solve`, paused at stagger-aligned bounds every
    ``segment_iterations`` (``solver.tiled.segment_bounds``, ROADMAP R4):
    the same trajectory."""
    check_mesh(state.u.shape, mesh, interpret)
    return sharded3d.solve_entry(state, mesh, stagger, max_iterations, chunk_depth,
                                 segment_iterations, "resident")
