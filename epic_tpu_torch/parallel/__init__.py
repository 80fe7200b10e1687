"""Grids and volumes on a device mesh: the counterpart of ``epic_tpu.parallel``.

``sharded`` cuts a 2D grid into K-extended shard blocks and runs the halo
exchange and the chunks on two routes: per shard (``hopper_shard2d``: the
CUDA entry ``epic_shard2d_chunk`` of ``csrc/tile2d.cu`` on a card, the
plain torch version on the CPU) and resident (``hopper_resident2d``: all of
a device's shards in one launch of ``epic_resident2d_cycle`` or
``epic_resident2d_solve``, also in ``csrc/tile2d.cu``), with the
reference's entry names in ``resident`` and ``resident_tiled``;
``sharded3d`` does the same for volumes on plane and z meshes, per shard
(``hopper_shard3d``: ``epic_shard3d_chunk`` of ``csrc/shard3d.cu``) and on
the device route (``hopper_resident3d``: every shard of a device in one
launch of ``epic_resident3d_cycle`` or ``epic_resident3d_solve``, also in
``csrc/shard3d.cu``), with the reference's entry names in ``resident3d``
and ``resident_z``;
``multihost`` spreads a mesh over processes with ``torch.distributed``."""

from . import multihost, resident, resident3d, resident_tiled, resident_z, sharded, sharded3d
from .sharded import make_mesh, make_mesh3d
from .sharded3d import choose_mesh3d

__all__ = ["choose_mesh3d", "make_mesh", "make_mesh3d", "multihost", "resident", "resident3d",
           "resident_tiled", "resident_z", "sharded", "sharded3d"]
