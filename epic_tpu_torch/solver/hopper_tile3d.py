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

The kernels' pass marches along z: a block owns a column segment, a
``TZ x TH x TW`` centre (``COLUMN`` is ``TH x TW``, fixed in the source;
:func:`tile_for` picks ``TZ`` for a shape), with a K-deep halo in y and x
and in z only at a segment's ends, and streams the segment's planes
through a ring of K + 3 planes in shared memory, each voxel loaded once a
chunk (the note at the head of ``csrc/tile3d.cu``). The plain version is
handed the same tile; it gives the same bits for any tile.

No router sends a volume here: ``tile_probe.py --volumes`` times these
kernels against the in-place kernels of :mod:`.hopper_sweep3d` (K7), and
since K7's z walk keeps a voxel's z neighbours in registers it has measured
as fast or faster on every volume run on an H100, within the L2 and past
it, cubes, deep volumes and wide planes (PERF.md), so
``solver.update_volume`` and ``solve_volume`` take K7 for every volume.
The tile entries run when called here directly.

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

DEFAULT_DEPTH = 4         # sweeps per trip to memory (the halo depth K)
MAX_DEPTH = 5             # kMaxK of csrc/tile3d.cu: the deepest halo an H100's block holds
# The column a block owns, TH x TW: kTH x kTW of csrc/tile3d.cu, fixed there
# (a lane a quad of 8 voxels of a plane, one block an SM: kMinBlocks).
COLUMN = (32, 128)
MIN_SEGMENT = 8           # the shortest segment tile_for cuts
H100_SMS = 132            # tile_for's SM count for a volume on the CPU
# The tile of a 256³ cube on an H100: eight segments of 32 planes over its
# 16 columns. The CPU tests hand it to the plain version among others.
TILE = (32, *COLUMN)


def smem_bytes(k: int) -> int:
    """Dynamic shared memory of one block at halo depth ``k``: a ring of
    k + 3 planes of the (TH + 2k) x (TW + 2k) extended column, each x
    parity's rows padded to whole quads of 4 voxels, with a guard row above
    and below, 4 B a voxel (``epic_tile3d_smem_bytes``)."""
    th, tw = COLUMN
    return (k + 3) * (th + 2 * k + 2) * 2 * -(-(tw + 2 * k) // 8) * 4 * 4


def tile_for(shape, device=None) -> tuple[int, int, int]:
    """The tile ``(TZ, TH, TW)`` of a ``D x H x W`` volume on ``device``'s
    card (an H100's SMs for a CPU device or None): ``COLUMN``, and the
    volume's depth cut into the segments that finish soonest
    (:func:`_segments_tile` at one block an SM)."""
    device = None if device is None else torch.device(device)
    sms = (torch.cuda.get_device_properties(device).multi_processor_count
           if device is not None and device.type == "cuda" else H100_SMS)
    return _segments_tile(shape, sms, COLUMN)


def _segments_tile(shape, slots: int, column) -> tuple[int, int, int]:
    """The tile of a ``D x H x W`` volume on ``column`` when the card runs
    ``slots`` blocks at once. A slot marches one segment at a time,
    ``TZ + 2 * DEFAULT_DEPTH`` steps, and the slots take the segments in
    rounds: the rule takes the number of segments, none shorter than
    ``MIN_SEGMENT`` planes unless the volume is, with the fewest rounds
    times steps (the fewest segments on a tie). A volume whose columns
    alone fill the slots keeps ``TZ = D``: no z halo. ``tile_probe
    --shapes`` calls it for other columns and blocks an SM."""
    d, h, w = shape
    th, tw = column
    columns = -(-h // th) * -(-w // tw)

    def steps(segments: int) -> int:
        tz = -(-d // segments)
        return -(-segments * columns // slots) * (tz + 2 * DEFAULT_DEPTH)

    best = min(range(1, max(1, d // MIN_SEGMENT) + 1), key=lambda s: (steps(s), s))
    return (-(-d // best), th, tw)


_kernels = TileKernels("epic_tile3d", tiled3d, TILE, DEFAULT_DEPTH, smem_bytes=smem_bytes,
                       max_depth=MAX_DEPTH, tile_for=tile_for)
launches = _kernels.launches
check_depth = _kernels.check_depth
sweep_chunk = _kernels.sweep_chunk
sweep_cycle = _kernels.sweep_cycle
update_n = _kernels.update_n
solve = _kernels.solve
solve_segments = _kernels.solve_segments

