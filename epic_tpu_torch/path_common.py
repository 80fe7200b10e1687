"""Helpers shared by the streamline walkers (path, path3d, path_nd).

``cell_index`` is the reference's float->cell truncation
((unsigned int)(v + 0.5f), harmonic_path_cpu.cpp:165-174) — byte-identical
across all three walkers and golden-pinned against the prebuilt reference
binary's walks, so it lives in exactly one place. The per-rank ``_is_stuck``
loops stay in their walkers (their float accumulation order is part of the
bit-pinned walk behaviour); each carries a cross-reference to the others.
"""

from __future__ import annotations

import numpy as np


def cell_index(v: float) -> int:
    """(unsigned int)(v + 0.5f) truncation; -1 for negative coordinates."""
    f = np.float32(v) + np.float32(0.5)
    if f < 0:
        return -1
    return int(f)
