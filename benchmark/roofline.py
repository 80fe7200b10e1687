"""The least time the chip could take for a solve's work, from the inputs and
the iteration counts alone.

The arithmetic of ``chip_smoke.py`` (its ``class_counts``, ``updates`` and
``bound``), copied here so that the yardstick stays as it is whatever the
program does. It counts the work the inputs need, not what a kernel does:

- operations: 17 float32 operations an update (lse4: 3 max, 4 sub, 4 expf,
  3 add, logf, add, sub), one update a sweep of each unlocked interior cell
  of the class that sweep relaxes;
- bytes: 9 a cell of the grid (u read, locked read, u written), each input
  read once and each output written once over the whole solve.

The least time is the larger of operations over the float32 peak and bytes
over the memory peak of one H100 SXM (NVIDIA's data sheet, at the full power
limit of 700 W; the run prints the card's own limit beside it).
"""

from __future__ import annotations

import numpy as np

PEAK_FP32_PER_S = 67e12      # H100 SXM, float32 outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12   # H100 SXM, HBM3
OPS_PER_UPDATE = 17
BYTES_PER_CELL = 9


def class_counts(locked: np.ndarray) -> tuple[int, int]:
    """Unlocked interior cells whose coordinates sum to an even and to an odd
    number."""
    locked = np.asarray(locked, dtype=bool)
    h, w = locked.shape
    inner = ~locked[1:-1, 1:-1]
    y = np.arange(1, h - 1).reshape(-1, 1)
    x = np.arange(1, w - 1).reshape(1, -1)
    odd = (y + x) % 2 == 1
    return int((inner & ~odd).sum()), int((inner & odd).sum())


def updates(counts: tuple[int, int], sweeps: int, t0: int = 0) -> int:
    """Cell updates of ``sweeps`` sweeps from iteration ``t0``: a sweep at an
    even iteration relaxes the odd class, at an odd one the even class."""
    even, odd = counts
    at_even_t = (sweeps + 1 - t0 % 2) // 2
    at_odd_t = sweeps - at_even_t
    return at_even_t * odd + at_odd_t * even


def least_seconds(n_updates: int, cells: int) -> float:
    """The larger of the operations bound and the bytes bound."""
    return max(n_updates * OPS_PER_UPDATE / PEAK_FP32_PER_S,
               cells * BYTES_PER_CELL / PEAK_BYTES_PER_S)
