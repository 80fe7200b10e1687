"""The 2D grid on a device mesh: the counterpart of ``epic_tpu.parallel``.

``sharded`` cuts the grid into K-extended shard blocks and runs the halo
exchange and the per-shard chunks (``hopper_shard2d``: the CUDA entry
``epic_shard2d_chunk`` of ``csrc/tile2d.cu`` on a card, the plain torch
version on the CPU);
``multihost`` spreads a mesh over processes with ``torch.distributed``.
The resident shard layouts and the 3D mesh are not ported yet (ROADMAP §1
item 3)."""

from . import multihost, sharded
from .sharded import make_mesh

__all__ = ["make_mesh", "multihost", "sharded"]
