"""The 2D resident route on the shard blocks: ``epic_tpu.parallel.
resident_tiled``'s entries.

In ``epic_tpu`` wide shards (``prefer_tiled_shards``) live in the tiled
guard layout and every chunk is K6's slab body at ``nc = 1`` through
``_chunk_cycle`` (K17), with the interior-masked sweep-0 delta. In the port
one route serves every shard (:mod:`.resident`, :mod:`.hopper_resident2d`):
the tile pass of ``csrc/tile2d.cu`` already cuts the shard into row x
column tiles, whatever its width, and its delta covers the centres. So this
module is the same route under the reference's names; the TPU layout
(``layout``, ``_HX`` guard tiles, the guard exchange) is not ported
(ROADMAP, "Do not port").
"""

from __future__ import annotations

from .. import constants as C
from ..grid import GridState
from . import resident
from .resident import DEFAULT_CHUNK_DEPTH, eligible
from .sharded import Mesh

__all__ = ["DEFAULT_CHUNK_DEPTH", "eligible", "prefer_tiled_shards", "update_n", "solve",
           "solve_segments"]


def prefer_tiled_shards(h_loc: int, w_loc: int, chunk_depth: int = DEFAULT_CHUNK_DEPTH) -> bool:
    """The reference's choice between its banded and tiled resident layouts
    for a shard extent. The port has one route for both, the same tiles at
    every width, so this chooses nothing: it says whether the shard takes
    that route (:func:`.resident.eligible`)."""
    return eligible(h_loc, w_loc, chunk_depth)


def update_n(state: GridState, num_steps: int, mesh: Mesh,
             chunk_depth: int = DEFAULT_CHUNK_DEPTH, interpret: bool | None = None) -> GridState:
    """:func:`.resident.update_n`."""
    return resident.update_n(state, num_steps, mesh, chunk_depth, interpret)


def solve(state: GridState, mesh: Mesh, stagger: int = C.DEFAULT_STAGGER,
          max_iterations: int = 1_000_000, chunk_depth: int = DEFAULT_CHUNK_DEPTH,
          interpret: bool | None = None) -> GridState:
    """:func:`.resident.solve`."""
    return resident.solve(state, mesh, stagger, max_iterations, chunk_depth, interpret)


def solve_segments(state: GridState, mesh: Mesh, stagger: int = C.DEFAULT_STAGGER,
                   max_iterations: int = 1_000_000, segment_iterations: int = 5_000,
                   chunk_depth: int = DEFAULT_CHUNK_DEPTH,
                   interpret: bool | None = None) -> GridState:
    """:func:`.resident.solve_segments`."""
    return resident.solve_segments(state, mesh, stagger, max_iterations, segment_iterations,
                                   chunk_depth, interpret)
