"""Grids and volumes on a device mesh: the counterpart of ``epic_tpu.parallel``.

``sharded`` cuts a 2D grid into K-extended shard blocks and runs the halo
exchange and the per-shard chunks (``hopper_shard2d``: the CUDA entry
``epic_shard2d_chunk`` of ``csrc/tile2d.cu`` on a card, the plain torch
version on the CPU); ``sharded3d`` does the same for volumes on plane and z
meshes (``hopper_shard3d``: ``epic_shard3d_chunk`` of ``csrc/shard3d.cu``),
with the resident routes ``resident3d`` and ``resident_z`` on the same
blocks; ``multihost`` spreads a mesh over processes with
``torch.distributed``. The 2D resident layouts are not ported yet (ROADMAP
§1 item 3.2)."""

from . import multihost, resident3d, resident_z, sharded, sharded3d
from .sharded import make_mesh, make_mesh3d
from .sharded3d import choose_mesh3d

__all__ = ["choose_mesh3d", "make_mesh", "make_mesh3d", "multihost", "resident3d", "resident_z",
           "sharded", "sharded3d"]
