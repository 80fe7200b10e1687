"""The benchmark's inputs: the map of a configuration and the seeded goals and
starts of a traffic mix.

Every request of a run draws its goal and its start from the run's
``--seed`` (:class:`Stream`), uniformly over the cells below, so no two
requests of a window share their inputs unless the draw repeats a cell; the
driver runs parent and change on the same seeds, so both get the same work.
The answers compared with the reference are a uniform sample of the window's
requests, drawn from the seed as they complete (:class:`Reservoir`). The
set-up's warm request is drawn from a fixed seed, so set-up does the same
work on every seed.

A goal or a start is a cell of the map's largest 4-connected component of
free interior cells, at least ``clearance_m`` from the nearest obstacle or the
map's edge: a robot's pose, which its footprint keeps off the walls.
"""

from __future__ import annotations

import dataclasses
import hashlib
import pathlib

import numpy as np


@dataclasses.dataclass
class Map:
    """A configuration's map: ``obstacle [H, W]`` and the cells goals and
    starts are drawn from, as ``(x, y)`` rows."""

    obstacle: np.ndarray
    cells: np.ndarray
    resolution: float
    origin: tuple[float, float]

    @property
    def shape(self) -> tuple[int, int]:
        return self.obstacle.shape

    def to_world(self, x: float, y: float) -> tuple[float, float]:
        return self.origin[0] + x * self.resolution, self.origin[1] + y * self.resolution

    def to_map(self, wx, wy):
        return (np.asarray(wx) - self.origin[0]) / self.resolution, \
            (np.asarray(wy) - self.origin[1]) / self.resolution


def image_sha256(img: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(img, dtype=np.uint8).tobytes()).hexdigest()


def load_map(config: dict, root: pathlib.Path) -> Map:
    """Read the configuration's map image (pixel 0 an obstacle, any other
    value free), check its checksum, and find the cells to draw from."""
    from scipy import ndimage

    spec = config["map"]
    with np.load(root / spec["file"]) as data:
        img = data[spec["key"]]
    if image_sha256(img) != spec["sha256"]:
        raise ValueError(f"{spec['file']}: the image's SHA-256 is not {spec['sha256']}")
    if list(img.shape) != [spec["height"], spec["width"]]:
        raise ValueError(f"{spec['file']}: shape {img.shape}, expected "
                         f"{spec['height']} x {spec['width']}")
    obstacle = img == 0
    free = ~obstacle
    free[0, :] = free[-1, :] = free[:, 0] = free[:, -1] = False
    labels, _ = ndimage.label(free)
    sizes = np.bincount(labels.ravel())
    sizes[0] = 0
    clear = ndimage.distance_transform_edt(free) * config["resolution_m"] >= config["clearance_m"]
    ys, xs = np.nonzero((labels == sizes.argmax()) & clear)
    return Map(obstacle=obstacle, cells=np.stack([xs, ys], axis=1),
               resolution=float(config["resolution_m"]), origin=tuple(config["origin_m"]))


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for any whole number, negative and past 64 bits included;
    ``stream`` parts independent draws of one seed."""
    return np.random.default_rng([stream, int(seed) & ((1 << 64) - 1)])


class Stream:
    """Request ``k``'s goal and start, ``(x, y)`` cells, a start never on its
    goal: drawn from ``seed`` in blocks, so a request's inputs depend on the
    seed and ``k`` alone."""

    BLOCK = 1024

    def __init__(self, m: Map, seed: int):
        self._cells = m.cells
        self._g = rng(seed, 1)
        self._goals = np.empty((0, 2), dtype=m.cells.dtype)
        self._starts = np.empty((0, 2), dtype=m.cells.dtype)

    def _grow(self, n: int) -> None:
        while len(self._goals) < n:
            c = len(self._cells)
            goal_idx = self._g.integers(c, size=self.BLOCK)
            start_idx = (goal_idx + self._g.integers(1, c, size=self.BLOCK)) % c
            self._goals = np.concatenate([self._goals, self._cells[goal_idx]])
            self._starts = np.concatenate([self._starts, self._cells[start_idx]])

    def take(self, k: int, n: int = 1) -> tuple[np.ndarray, np.ndarray]:
        """Requests ``k .. k + n - 1``: goals ``[n, 2]`` and starts ``[n, 2]``."""
        self._grow(k + n)
        return self._goals[k:k + n], self._starts[k:k + n]


class Reservoir:
    """Which of a run's completed requests have their answers compared: a
    uniform sample of ``size`` of them, whatever their number, drawn from
    ``seed`` as they complete (Vitter's algorithm R)."""

    def __init__(self, size: int, seed: int):
        self.size = size
        self._g = rng(seed, 2)
        self._seen = 0

    def offer(self) -> int | None:
        """The slot the next completed request takes, or ``None`` if it is
        not kept (a slot's earlier request then drops out)."""
        n = self._seen
        self._seen += 1
        if n < self.size:
            return n
        j = int(self._g.integers(n + 1))
        return j if j < self.size else None
