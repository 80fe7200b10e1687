"""Big and wide 2D grids on the temporally blocked CUDA tile kernels.

The counterpart of ``epic_tpu.solver.pallas_biggrid`` and
``pallas_tiled2d`` (with the 2D cycles of ``pallas_cycle``): ``update_n``
runs a tick as one launch of ``epic_tile2d_cycle`` (K4/K6), with an odd
chunk count's last chunk through ``epic_tile2d_chunk`` (K3/K5, the TPU's
remainder chunk) and copied back; ``solve`` runs the whole protocol in one
launch of ``epic_tile2d_solve``; ``solve_segments`` is a host loop of such
launches, each resuming where the last stopped. All from
``csrc/tile2d.cu``. ``sweep_chunk`` and ``sweep_cycle`` expose the chunk
and cycle entries themselves. A grid on the CPU goes to the plain version in
:mod:`.tiled`; a grid on a CUDA device goes to the kernels or raises.

Routing (:func:`use_tiles`): a grid goes here when its ``u`` and ``locked``
(5 B a cell) exceed two thirds of the card's L2; below that the in-place
kernels of :mod:`.hopper_sweep` run it from L2 faster. Two thirds of the
50 MiB L2 of an H100 80GB HBM3 fall at about 2644². There, at 700 W,
``tile_probe --sweep2d`` timed a 100-sweep tick and a solve capped at
2,000 sweeps, in place against the tiles (ms, the mean of two turns):
2560² 2.06 / 43.0 against 2.23 / 45.2; 2624² 2.26 / 51.1 against 2.24 /
45.7, a tie on the tick; 2688² 2.61 / 48.9 against 2.24 / 45.2; 2736² 2.97
/ 58.0 against 2.27 / 45.8. At 2816² the tiles lead by only 4% (3.31
against 3.19 ms), likely because its 540 tiles of 96 × 160 need a third
wave over the 264 an H100 runs at once, where 2736²'s 522 fill two.
PERF.md holds the readings.

In place, like every other wrapper: on CUDA the returned state holds the
caller's ``u`` tensor, relaxed, with the twin and u1 scratch grids that
:class:`._tiles.TileKernels` keeps (the same wrapper serves
:mod:`.hopper_tile3d`).

``launches`` counts each kernel's launches; nothing else changes it.
"""

from __future__ import annotations

import torch

from . import tiled
from ._tiles import TileKernels

DEFAULT_DEPTH = 16        # SolverConfig.tile_depth's default: sweeps per trip to memory
# The centre a block owns, TH x TW: kTH x kTW of csrc/tile2d.cu, fixed there
# (with 512 threads a block) as the fastest shape ``tile_probe --shapes2d``
# measured on an H100 (PERF.md). A launch whose grid, shard or plan gives
# the card's SMs fewer than two such tiles each runs on the small tile
# kSmallTH x kSmallTW instead (TILE_SMALL), which busies more SMs. The plain
# version takes any tile and gives the same bits with each; it is held to
# the kernels at TILE.
TILE = (96, 160)
TILE_SMALL = (32, 96)


def tile_smem_bytes(k: int, tile: tuple[int, int] = TILE) -> int:
    """Dynamic shared memory of one block of ``csrc/tile2d.cu`` at halo depth
    ``k`` (its ``smem_bytes``): each of the extended tile's ``TH + 2k`` rows
    holds two class rows (the red and the black cells) of ``(TW + 2k) / 2``
    floats and their frozen flags as bits in 32-bit words. At ``TILE``, the
    larger of the two shapes, it bounds what a launch asks for."""
    th, tw = tile
    half = tw // 2 + k
    return (th + 2 * k) * 2 * (4 * half + 4 * -(-half // 32))


_kernels = TileKernels("epic_tile2d", tiled, TILE, DEFAULT_DEPTH, tile_smem_bytes)
launches = _kernels.launches
smem_bytes = _kernels.smem_bytes
check_depth = _kernels.check_depth
sweep_chunk = _kernels.sweep_chunk
sweep_cycle = _kernels.sweep_cycle
update_n = _kernels.update_n
solve = _kernels.solve
solve_segments = _kernels.solve_segments


def past_crossover(shape, l2_bytes: int) -> bool:
    """The routing rule: ``u`` (4 B) and ``locked`` (1 B) of a 2D grid
    exceed two thirds of ``l2_bytes``, where the tiles start to win."""
    h, w = shape
    return 3 * 5 * h * w > 2 * l2_bytes


def use_tiles(shape, device) -> bool:
    """Whether a 2D grid of ``shape`` on ``device`` runs on the tile
    kernels: on a CUDA device, past the crossover of its L2
    (:func:`past_crossover`). A grid on the CPU never does (it runs
    ``core``)."""
    device = torch.device(device)
    if device.type != "cuda" or len(shape) != 2:
        return False
    return past_crossover(shape, torch.cuda.get_device_properties(device).L2_cache_size)
