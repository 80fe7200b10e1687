"""The least time the chip could take for a volume solve's work, from the
inputs and the iteration counts alone.

The 3D arithmetic of ``chip_smoke.py`` (its ``class_counts``, ``updates``
with ``lse6`` and ``bound``), copied here so that the yardstick stays as it
is whatever the program does. It counts the work the inputs need, not what a
kernel does:

- operations: 25 float32 operations an update (lse6: 5 max, 6 sub, 6 expf,
  5 add, logf, add, sub), one update a sweep of each unlocked interior voxel
  of the class that sweep relaxes (a 3D sweep at iteration ``t`` relaxes the
  class ``(z + y + x) % 2 == t % 2``);
- bytes: 9 a voxel of the volume (u read, locked read, u written), each
  input read once and each output written once over the whole solve.

The least time is the larger of operations over the float32 peak and bytes
over the memory peak of one H100 SXM (NVIDIA's data sheet, at the full power
limit of 700 W; the run prints the card's own limit beside it).
"""

from __future__ import annotations

import numpy as np

PEAK_FP32_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
OPS_PER_UPDATE = 25
BYTES_PER_VOXEL = 9


def class_counts(locked: np.ndarray) -> tuple[int, int]:
    """Unlocked interior voxels whose coordinates sum to an even and to an
    odd number."""
    locked = np.asarray(locked, dtype=bool)
    d, h, w = locked.shape
    inner = ~locked[1:-1, 1:-1, 1:-1]
    z = np.arange(1, d - 1).reshape(-1, 1, 1)
    y = np.arange(1, h - 1).reshape(1, -1, 1)
    x = np.arange(1, w - 1).reshape(1, 1, -1)
    odd = (z + y + x) % 2 == 1
    n_odd = int((inner & odd).sum())
    return int(inner.sum()) - n_odd, n_odd


def updates(counts: tuple[int, int], sweeps: int, t0: int = 0) -> int:
    """Voxel updates of ``sweeps`` sweeps from iteration ``t0``: a sweep at an
    even iteration relaxes the even class, at an odd one the odd class."""
    even, odd = counts
    at_even_t = (sweeps + 1 - t0 % 2) // 2
    at_odd_t = sweeps - at_even_t
    return at_even_t * even + at_odd_t * odd


def least_seconds(n_updates: int, voxels: int) -> float:
    """The larger of the operations bound and the bytes bound."""
    return max(n_updates * OPS_PER_UPDATE / PEAK_FP32_PER_S,
               voxels * BYTES_PER_VOXEL / PEAK_BYTES_PER_S)


def solves_least_seconds(locked: np.ndarray, items: list) -> float:
    """The least time of the cold solves of ``items``, each from the volume
    ``locked`` with its ``goal`` voxel ``(x, y, z)`` locked too, at its own
    ``sweeps``."""
    even, odd = class_counts(locked)
    n_updates = 0
    for i in items:
        gx, gy, gz = i["goal"]
        counts = (even - 1, odd) if (gx + gy + gz) % 2 == 0 else (even, odd - 1)
        n_updates += updates(counts, i["sweeps"])
    return least_seconds(n_updates, len(items) * int(np.asarray(locked).size))
