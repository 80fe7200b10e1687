"""Big and wide-plane 3D volumes on the temporally blocked CUDA tile kernels.

The counterpart of ``epic_tpu.solver.pallas_biggrid3d`` and
``pallas_tiled3d`` (with the 3D cycles of ``pallas_cycle``): ``update_n``
runs a tick as one launch of ``epic_tile3d_cycle`` (K9/K11), with an odd
chunk count's last chunk through ``epic_tile3d_chunk`` (K8/K10, the TPU's
remainder chunk) and copied back; ``solve`` runs the whole protocol in one
launch of ``epic_tile3d_solve``; ``solve_segments`` is a host loop of such
launches, each resuming where the last stopped. All from
``csrc/tile3d.cu``. ``sweep_chunk`` and ``sweep_cycle`` expose the chunk
and cycle entries themselves. A volume on the CPU goes to the plain version
in :mod:`.tiled3d`; a volume on a CUDA device goes to the kernels or raises.

Routing (:func:`use_tiles`): a volume goes here when its ``u`` and
``locked`` (5 B a voxel) exceed ``CROSSOVER_L2`` times the card's L2, where
``tile_probe.py --volumes`` measures the tiles to start winning; below it
the in-place kernels of :mod:`.hopper_sweep3d` (K7) run it faster. On an
H100 they won at no measured size, so ``CROSSOVER_L2`` is None and every
volume on the card stays on K7 (see the constant).

In place, like every other wrapper: on CUDA the returned state holds the
caller's ``u`` tensor, relaxed, with the twin and u1 scratch volumes that
:class:`._tiles.TileKernels` keeps (the wrapper it shares with
:mod:`.hopper_tile2d`).

``launches`` counts each kernel's launches; nothing else changes it.
"""

from __future__ import annotations

import torch

from . import tiled3d
from ._tiles import TileKernels

DEFAULT_DEPTH = 3         # sweeps per trip to memory (the halo depth K)
# The centre a block owns, TD x TH x TW: kTD x kTH x kTW of csrc/tile3d.cu,
# fixed there (with 512 threads a block) as the fastest shape, at K = 3, of
# those tile_probe.py --shapes measured at 256³ and 32 x 2048 x 2048 on an
# H100 (PERF.md). The plain version takes any tile; it is held to the
# kernels at this one.
TILE = (8, 16, 64)
# u and locked past this many L2s go to the tiles. None: on an H100 the
# tiles ran a 100-sweep tick 1.3x (32 x 2048 x 2048) to 1.9x (256³) slower a
# sweep than K7 at every volume tile_probe.py --volumes measured, 160³ to
# 320³ and 32 x 2048 x 2048 (PERF.md). A chunk of K <= 4 sweeps refills its
# halo-extended tile from memory and recomputes the trapezoid, and that
# fill plus the lse6 arithmetic costs more instructions than K7's HBM
# traffic costs time; so no volume goes to them until a design that reads
# each voxel once per K sweeps without a z halo (ROADMAP: z-marching blocks)
# measures a crossover.
CROSSOVER_L2: float | None = None

_kernels = TileKernels("epic_tile3d", tiled3d, TILE, DEFAULT_DEPTH)
launches = _kernels.launches
smem_bytes = _kernels.smem_bytes
check_depth = _kernels.check_depth
sweep_chunk = _kernels.sweep_chunk
sweep_cycle = _kernels.sweep_cycle
update_n = _kernels.update_n
solve = _kernels.solve
solve_segments = _kernels.solve_segments


def past_crossover(shape, l2_bytes: int) -> bool:
    """The routing rule: ``u`` (4 B) and ``locked`` (1 B) of a volume exceed
    ``CROSSOVER_L2`` times ``l2_bytes``; never while ``CROSSOVER_L2`` is
    None."""
    if CROSSOVER_L2 is None:
        return False
    d, h, w = shape
    return 5 * d * h * w > CROSSOVER_L2 * l2_bytes


def use_tiles(shape, device) -> bool:
    """Whether a volume of ``shape`` on ``device`` runs on the tile
    kernels: on a CUDA device, past the crossover of its L2
    (:func:`past_crossover`). A volume on the CPU never does (it runs
    ``core``)."""
    device = torch.device(device)
    if device.type != "cuda" or len(shape) != 3:
        return False
    return past_crossover(shape, torch.cuda.get_device_properties(device).L2_cache_size)
