"""A configuration's volume: a building storey made from its 2D plan.

A configuration with a ``volume`` key extrudes its plan's walls through every
plane of a storey ``depth`` voxels deep; the storey's floor and ceiling are
the volume's boundary shell, which the planner keeps as obstacle as it keeps
the plan's border. The driver hands the program this volume, and the check
rebuilds the same one from the same plan and configuration.

A request's goal and start voxels take their plane cells from the run's
seeded stream (:class:`benchmark.inputs.Stream`) and their planes, uniform
over the configuration's ``z_band``, from a stream of their own
(``inputs.rng(seed, 3)``), so a request's inputs depend on the seed and its
index alone.
"""

from __future__ import annotations

import numpy as np

from . import inputs


def shape(obstacle: np.ndarray, config: dict) -> tuple[int, int, int]:
    """The volume's ``(depth, height, width)``."""
    h, w = obstacle.shape
    return int(config["volume"]["depth"]), h, w


def occupancy(obstacle: np.ndarray, config: dict) -> np.ndarray:
    """The occupancy volume the program ingests: int16 ``[D, H, W]``, 100
    where the plan has a wall, 0 elsewhere, on every plane."""
    d, h, w = shape(obstacle, config)
    plane = np.where(np.asarray(obstacle, dtype=bool), 100, 0).astype(np.int16)
    return np.broadcast_to(plane, (d, h, w)).copy()


def locked(obstacle: np.ndarray, config: dict) -> np.ndarray:
    """The voxels a solve never updates before a goal is set: the plan's
    walls on every plane and the boundary shell (the floor, the ceiling and
    the plan's border). bool ``[D, H, W]``."""
    d, h, w = shape(obstacle, config)
    out = np.broadcast_to(np.asarray(obstacle, dtype=bool), (d, h, w)).copy()
    out[0], out[-1] = True, True
    out[:, 0, :], out[:, -1, :] = True, True
    out[:, :, 0], out[:, :, -1] = True, True
    return out


class Stream:
    """Request ``k``'s goal and start voxels, ``(x, y, z)`` rows: the plane
    cells of :class:`benchmark.inputs.Stream` and planes drawn uniformly
    from ``z_band`` (inclusive), in blocks, from ``inputs.rng(seed, 3)``."""

    BLOCK = 1024

    def __init__(self, m: inputs.Map, seed: int, z_band):
        self._plane = inputs.Stream(m, seed)
        self._g = inputs.rng(seed, 3)
        self._lo, self._hi = (int(v) for v in z_band)
        self._z = np.empty((0, 2), dtype=np.int64)

    def take(self, k: int, n: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """Requests ``k .. k + n - 1``: goals ``[n, 3]`` and starts ``[n, 3]``."""
        goals, starts = self._plane.take(k, n)
        while len(self._z) < k + n:
            block = self._g.integers(self._lo, self._hi + 1, size=(self.BLOCK, 2))
            self._z = np.concatenate([self._z, block])
        z = self._z[k:k + n]
        return (np.column_stack([goals, z[:, 0]]).astype(np.int64),
                np.column_stack([starts, z[:, 1]]).astype(np.int64))
