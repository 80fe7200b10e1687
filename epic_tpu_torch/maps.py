"""Map ingest and procedural occupancy-grid generators.

Ingest mirrors the reference's two entry points:

- Grayscale PNG, HarmonicMap.load semantics
  (the reference's libepic/python/epic/harmonic_map.py:54-100):
  255 -> goal, 0 -> obstacle, otherwise free.
- map_server YAML + image (maps/maze.yaml): resolution/origin metadata plus
  an image whose dark pixels (>= occupied_thresh) are obstacles. For the
  planner we keep the PNG convention above, and carry resolution/origin for
  world<->map transforms.

The procedural generators exist because the reference validates empirically
on a fixed set of PNG fixtures (SURVEY §4); we generate equivalent workloads
(rooms, recursive-division mazes) at any size so the regression suite and
benchmarks are self-contained and scale-parameterised.
"""

from __future__ import annotations

import dataclasses
import os
import pathlib

import numpy as np

# The reference's fixtures (maps/maze.png and the like) are searched for in
# these directories, in this order, of the reference tree named by
# $EPIC_REFERENCE_ROOT: those of epic_tpu.maps.reference_map_path.
REFERENCE_MAP_DIRS = ("maps", "libepic/tests/batch", "libepic/tests/maps")


@dataclasses.dataclass(frozen=True)
class MapMeta:
    """map_server-style metadata (maps/maze.yaml:1-6)."""

    resolution: float = 1.0
    origin_x: float = 0.0
    origin_y: float = 0.0


def load_png(path: str | pathlib.Path) -> np.ndarray:
    """Load a grayscale image as uint8 [H, W]."""
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("L"), dtype=np.uint8)


def load_map_server_yaml(path: str | pathlib.Path) -> tuple[np.ndarray, MapMeta]:
    """Load a map_server YAML (image/resolution/origin) and its image."""
    import yaml

    path = pathlib.Path(path)
    with open(path) as f:
        meta = yaml.safe_load(f)
    img = load_png(path.parent / meta["image"])
    origin = meta.get("origin", [0.0, 0.0, 0.0])
    return img, MapMeta(
        resolution=float(meta.get("resolution", 1.0)),
        origin_x=float(origin[0]),
        origin_y=float(origin[1]),
    )


# ---------------------------------------------------------------------------
# Procedural fixtures. All return uint8 images in the PNG convention
# (255 goal, 0 obstacle, 128 free) with an obstacle boundary ring.
# ---------------------------------------------------------------------------


def open_room(
    height: int, width: int, goal: tuple[int, int] | None = None
) -> np.ndarray:
    """Empty room with a single goal cell (default: near the centre)."""
    img = np.full((height, width), 128, dtype=np.uint8)
    img[0, :] = 0
    img[-1, :] = 0
    img[:, 0] = 0
    img[:, -1] = 0
    if goal is None:
        goal = (width // 2, height // 2)
    img[goal[1], goal[0]] = 255
    return img


def random_obstacles(
    height: int,
    width: int,
    density: float = 0.15,
    seed: int = 0,
    goal: tuple[int, int] | None = None,
) -> np.ndarray:
    """Room with scattered square obstacles; goal guaranteed free."""
    rng = np.random.default_rng(seed)
    img = open_room(height, width, goal=goal or (width // 2, height // 2))
    gx, gy = goal or (width // 2, height // 2)
    n_blocks = int(density * height * width / 25)
    for _ in range(n_blocks):
        y = int(rng.integers(1, height - 4))
        x = int(rng.integers(1, width - 4))
        h = int(rng.integers(2, 5))
        w = int(rng.integers(2, 5))
        if abs(y - gy) < 6 and abs(x - gx) < 6:
            continue
        img[y : y + h, x : x + w] = 0
    img[gy, gx] = 255
    return img


def recursive_maze(
    height: int,
    width: int,
    seed: int = 0,
    corridor: int = 4,
    goal: tuple[int, int] | None = None,
) -> np.ndarray:
    """Recursive-division maze, a workload shaped like the reference's
    maze fixtures (maps/maze.png 482x482, tests/batch/large_maze.png 962x962).

    Walls are 1 cell thick with ``corridor``-wide openings; all free cells are
    connected, so every streamline should reach the goal on a converged field.
    """
    rng = np.random.default_rng(seed)
    img = np.full((height, width), 128, dtype=np.uint8)
    img[0, :] = 0
    img[-1, :] = 0
    img[:, 0] = 0
    img[:, -1] = 0

    min_cell = 2 * corridor + 1

    def divide(y0, y1, x0, x1):
        h, w = y1 - y0, x1 - x0
        if h < min_cell * 2 or w < min_cell * 2:
            return
        if h >= w:
            # horizontal wall
            wy = int(rng.integers(y0 + corridor + 1, y1 - corridor - 1))
            img[wy, x0:x1] = 0
            gap = int(rng.integers(x0, x1 - corridor))
            img[wy, gap : gap + corridor] = 128
            divide(y0, wy, x0, x1)
            divide(wy + 1, y1, x0, x1)
        else:
            wx = int(rng.integers(x0 + corridor + 1, x1 - corridor - 1))
            img[y0:y1, wx] = 0
            gap = int(rng.integers(y0, y1 - corridor))
            img[gap : gap + corridor, wx] = 128
            divide(y0, y1, x0, wx)
            divide(y0, y1, wx + 1, x1)

    divide(1, height - 1, 1, width - 1)

    if goal is None:
        # Find a free cell near the centre.
        free = np.argwhere(img == 128)
        centre = np.array([height // 2, width // 2])
        goal_yx = free[np.argmin(np.abs(free - centre).sum(axis=1))]
        goal = (int(goal_yx[1]), int(goal_yx[0]))
    img[goal[1], goal[0]] = 255
    return img


def free_fraction(img: np.ndarray) -> float:
    return float((img == 128).mean())


def reference_map_path(name: str) -> pathlib.Path | None:
    """Path to a reference-shipped fixture if the reference tree is mounted.

    Purely optional: sessions and benchmarks use it to run the reference's
    own workloads (maps/maze.png etc.) when available. Data files only — no
    code is used. Searches :data:`REFERENCE_MAP_DIRS`, in that order, under
    ``$EPIC_REFERENCE_ROOT``; None where that is unset."""
    root = os.environ.get("EPIC_REFERENCE_ROOT")
    if not root:
        return None
    for d in REFERENCE_MAP_DIRS:
        p = pathlib.Path(root) / d / name
        if p.exists():
            return p
    return None
