"""The anytime planner for 3D volumes: warm-started re-solves + service verbs.

The counterpart of ``epic_tpu.planner3d``: the 2D planner's verb surface
(:class:`epic_tpu_torch.planner.Planner`) one dimension up, over a
``GridState`` volume on the planner's device. ``update()`` and ``solve()`` go
through :func:`epic_tpu_torch.solver.update_volume` and ``solve_volume``:
on the card the in-place kernels of ``csrc/sweep3d.cu``, or past the
measured crossover beyond the L2 the tile kernels of ``csrc/tile3d.cu``;
the plain torch version on the CPU. Either relaxes ``u`` in place, so there
is no padded-buffer cache.
Paths come from the trilinear walker (:mod:`epic_tpu_torch.path3d`, on the
host: the native C++ walker when it is built, else NumPy) or, many at once,
from :mod:`epic_tpu_torch.solver.batched_path3d` on the planner's device.
Their world poses come back as :class:`PathPoses3D`, five arrays, with no
Python object per pose. The verbs are spans ``planner3d.<verb>``
(:func:`epic_tpu_torch.profiling.span`).

The reference's service layer is 2D-only; the core semantic carried over
from the 2D planner is unchanged: the planner never stops relaxing, verbs
perturb ``u``/``locked`` and relaxation resumes warm from the current state.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import itertools
import logging
import math

import numpy as np
import torch

from . import constants as C
from . import grid as G
from .config import check_backend
from .errors import EpicError, InvalidLocationError
from .path3d import compute_path
from . import profiling, solver
from .solver import batched_path3d

logger = logging.getLogger("epic_tpu_torch.planner3d")

# ``built`` counts the world poses ``VolumePlanner._poses`` computes, one a
# walker point; ``boxed`` the ``PathPose3D`` objects a ``PathPoses3D`` makes
# for its callers (an index one, an iteration all of its poses, counted as it
# starts). Nothing else changes them.
poses = {"built": 0, "boxed": 0}


@dataclasses.dataclass
class VolumePlannerConfig:
    """3D extension of PlannerConfig: one more origin axis; interpolation is
    always the trilinear (non-extrapolating) walker."""

    epsilon: float = C.DEFAULT_EPSILON_NODE
    stagger: int = C.DEFAULT_STAGGER
    steps_per_update: int = 50
    resolution: float = 1.0
    origin_x: float = 0.0
    origin_y: float = 0.0
    origin_z: float = 0.0
    # Kept so configs written for epic_tpu load; only "auto" is accepted
    # (the kernels on the card, the plain version on the CPU).
    backend: str = "auto"

    def __post_init__(self):
        check_backend(self.backend)


@dataclasses.dataclass(frozen=True)
class PathPose3D:
    """A 3D path pose: world coordinates + yaw/pitch from the segment
    direction (the 3D analogue of the 2D node's per-pose yaw,
    epic_navigation_node_harmonic.cpp:655-668)."""

    x: float
    y: float
    z: float
    yaw: float
    pitch: float


class PathPoses3D(collections.abc.Sequence):
    """A 3D path's world poses, held as five read-only float64 arrays ``x``,
    ``y``, ``z``, ``yaw`` and ``pitch``.

    A sequence of :class:`PathPose3D`: an index gives a pose (negative ones
    too), a slice another ``PathPoses3D``, and iteration makes each pose as
    it is reached. ``list(poses)`` gives the poses as a list."""

    __slots__ = ("_x", "_y", "_z", "_yaw", "_pitch")

    def __init__(self, x: np.ndarray, y: np.ndarray, z: np.ndarray, yaw: np.ndarray,
                 pitch: np.ndarray):
        for a in (x, y, z, yaw, pitch):
            a.flags.writeable = False
        self._x, self._y, self._z, self._yaw, self._pitch = x, y, z, yaw, pitch

    @property
    def x(self) -> np.ndarray:
        return self._x

    @property
    def y(self) -> np.ndarray:
        return self._y

    @property
    def z(self) -> np.ndarray:
        return self._z

    @property
    def yaw(self) -> np.ndarray:
        return self._yaw

    @property
    def pitch(self) -> np.ndarray:
        return self._pitch

    def _arrays(self) -> tuple:
        return self._x, self._y, self._z, self._yaw, self._pitch

    def __len__(self) -> int:
        return len(self._x)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PathPoses3D(*(a[i] for a in self._arrays()))
        pose = PathPose3D(*(float(a[i]) for a in self._arrays()))
        poses["boxed"] += 1
        return pose

    def __iter__(self):
        poses["boxed"] += len(self._x)
        return map(PathPose3D, *(a.tolist() for a in self._arrays()))


class VolumePlanner:
    """Incremental anytime harmonic planner over a 3D volume.

    Verb mapping (the 2D Planner's, one dimension up):

      SetStatus      -> set_status(paused)
      ModifyGoals +  -> add_goals(world_points_3d)
      ModifyGoals -  -> remove_goals(world_points_3d)
      GetCell        -> get_cell(x, y, z)
      SetCells       -> set_cells(xyz_cells, types)   [voxel coords]
      ResetFreeCells -> reset_free_cells()
      ComputePath    -> compute_path(start_world_3d, ...)
      (occupancy)    -> update_occupancy(volume, resolution, origin)
      (main loop)    -> update(num_steps)

    ``device`` places the volume: a CUDA device runs the kernels of
    ``csrc/sweep3d.cu`` or, for a volume past the crossover, of
    ``csrc/tile3d.cu``; the CPU the plain torch version.
    """

    def __init__(self, config: VolumePlannerConfig | None = None, *,
                 device: torch.device | str):
        self.config = config or VolumePlannerConfig()
        self.device = torch.device(device)
        self.state: G.GridState | None = None
        self.paused = False

    # -- lifecycle ---------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return self.state is not None

    def init(self, width: int, height: int, depth: int) -> None:
        """initAlg generalized to 3D: all-free volume (u = 0), boundary
        shell forced obstacle (epic_navigation_node_harmonic.cpp:207-244,
        :282-307)."""
        self.state = G.empty_volume(depth, height, width, epsilon=self.config.epsilon,
                                    device=self.device)
        logger.info("volume planner init %dx%dx%d eps=%g device=%s",
                    width, height, depth, self.config.epsilon, self.device)

    def uninit(self) -> None:
        self.state = None

    def _require_state(self) -> G.GridState:
        if self.state is None:
            raise EpicError(2, "planner not initialized")
        return self.state

    # -- world <-> map transforms -----------------------------------------

    def map_to_world(self, mx: float, my: float, mz: float):
        cfg = self.config
        return (
            cfg.origin_x + mx * cfg.resolution,
            cfg.origin_y + my * cfg.resolution,
            cfg.origin_z + mz * cfg.resolution,
        )

    def world_to_map(self, wx: float, wy: float, wz: float):
        cfg = self.config
        d, h, w = self._require_state().u.shape
        if (
            wx < cfg.origin_x
            or wy < cfg.origin_y
            or wz < cfg.origin_z
            or wx >= cfg.origin_x + w * cfg.resolution
            or wy >= cfg.origin_y + h * cfg.resolution
            or wz >= cfg.origin_z + d * cfg.resolution
        ):
            raise InvalidLocationError(f"world ({wx}, {wy}, {wz}) outside map")
        return (
            (wx - cfg.origin_x) / cfg.resolution,
            (wy - cfg.origin_y) / cfg.resolution,
            (wz - cfg.origin_z) / cfg.resolution,
        )

    # -- the anytime loop --------------------------------------------------

    def update(self, num_steps: int | None = None) -> None:
        """Run a chunk of relaxation sweeps (no-op when paused / uninit)."""
        with profiling.span("planner3d.update"):
            if self.state is None or self.paused:
                return
            n = num_steps if num_steps is not None else self.config.steps_per_update
            if n < 1:
                return
            self.state = solver.update_volume(self.state, n)

    def solve(self, max_iterations: int | None = None) -> None:
        """Blocking solve-to-convergence (harmonic_complete semantics).
        ``max_iterations`` caps the solve; a capped solve leaves
        ``state.converged`` False and can be resumed by calling again."""
        with profiling.span("planner3d.solve"):
            cap = 1_000_000 if max_iterations is None else int(max_iterations)
            self.state = solver.solve_volume(self._require_state(), self.config.stagger, cap)

    # -- service verbs -----------------------------------------------------

    def set_status(self, paused: bool) -> bool:
        self.paused = bool(paused)
        return True

    def set_cells(self, xyz, types) -> bool:
        """SetCells on voxel coordinates, no world transform."""
        with profiling.span("planner3d.set_cells"):
            self.state = G.set_cells_3d(self._require_state(), xyz, types)
            return True

    def add_goals(self, world_points) -> bool:
        """ModifyGoals(add): world (x, y, z) -> voxels; goals refused inside
        obstacles; False when no goal could be added."""
        with profiling.span("planner3d.add_goals"):
            st = self._require_state()
            u_np = G.host_u(st)
            locked_np = G.host_locked(st)
            d, h, w = u_np.shape
            xyz = []
            for wx, wy, wz in world_points:
                try:
                    mx, my, mz = self.world_to_map(wx, wy, wz)
                except InvalidLocationError:
                    continue
                cx, cy, cz = int(mx + 0.5), int(my + 0.5), int(mz + 0.5)
                is_obstacle = not (0 <= cx < w and 0 <= cy < h and 0 <= cz < d) or (
                    bool(locked_np[cz, cy, cx])
                    and float(u_np[cz, cy, cx]) == float(C.LOG_SPACE_OBSTACLE)
                )
                if is_obstacle:
                    continue
                xyz.append((int(mx), int(my), int(mz)))
            if not xyz:
                return False
            self.state = G.set_cells_3d(st, xyz, [C.CELL_TYPE_GOAL] * len(xyz))
            return True

    def remove_goals(self, world_points) -> bool:
        """ModifyGoals(remove): removed goals become FREE voxels."""
        with profiling.span("planner3d.remove_goals"):
            st = self._require_state()
            xyz = []
            for wx, wy, wz in world_points:
                try:
                    mx, my, mz = self.world_to_map(wx, wy, wz)
                except InvalidLocationError:
                    continue
                xyz.append((int(mx), int(my), int(mz)))
            if xyz:
                self.state = G.set_cells_3d(st, xyz, [C.CELL_TYPE_FREE] * len(xyz))
            return True

    def get_cell(self, x: int, y: int, z: int) -> float:
        """GetCell: the voxel's log hitting probability, a 4-byte read."""
        st = self._require_state()
        d, h, w = st.u.shape
        if not (0 <= x < w and 0 <= y < h and 0 <= z < d):
            raise InvalidLocationError(f"cell ({x}, {y}, {z}) outside map")
        return float(st.u[z, y, x])

    def reset_free_cells(self) -> bool:
        with profiling.span("planner3d.reset_free_cells"):
            self.state = G.reset_free_cells(self._require_state())
            return True

    def update_occupancy(
        self,
        data: np.ndarray,
        resolution: float | None = None,
        origin: tuple[float, float, float] | None = None,
    ) -> None:
        """Occupancy-volume ingest with the 2D subscriber's update rules
        (epic_navigation_node_harmonic.cpp:383-426) per voxel: >= 50 ->
        OBSTACLE, else FREE; NO_CHANGE (-2) and existing-goal voxels
        untouched; size change triggers full reinit (goals lost); the
        boundary shell stays obstacle."""
        with profiling.span("planner3d.update_occupancy"):
            data = np.asarray(data)
            d, h, w = data.shape
            if self.state is None or tuple(self.state.u.shape) != (d, h, w):
                if self.state is not None:
                    logger.warning(
                        "occupancy resize %s -> (%d, %d, %d): full reinit, goals"
                        " lost (reference behaviour)", tuple(self.state.u.shape), d, h, w)
                self.uninit()
                self.init(w, h, d)
            if resolution is not None:
                self.config.resolution = float(resolution)
            if origin is not None:
                (self.config.origin_x, self.config.origin_y,
                 self.config.origin_z) = map(float, origin)

            st = self._require_state()
            u_np = G.host_u(st)
            locked_np = G.host_locked(st)
            goal_mask = locked_np & (u_np == float(C.LOG_SPACE_GOAL))

            interior = np.zeros((d, h, w), dtype=bool)
            interior[1:-1, 1:-1, 1:-1] = True
            changeable = interior & (data != C.OCCUPANCY_NO_CHANGE) & ~goal_mask
            obstacle = changeable & (data >= C.OCCUPANCY_OBSTACLE_THRESHOLD)
            free = changeable & ~obstacle
            zs, ys, xs = np.nonzero(obstacle | free)
            if len(zs) == 0:
                return
            types = np.where(obstacle[zs, ys, xs], C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_FREE)
            self.state = G.set_cells_3d(st, np.stack([xs, ys, zs], axis=1), types)

    def _poses(self, pts: np.ndarray) -> PathPoses3D:
        """Map-frame points -> world poses with per-segment yaw (about z)
        and pitch (elevation), in one pass over the points:
        ``map_to_world``'s float64 operations on whole arrays, and the yaw
        and pitch, 0 at the start, from ``math.atan2`` and ``math.hypot`` of
        each step's float64 differences (NumPy's ``arctan2`` and ``hypot``
        round some differently)."""
        with profiling.span("planner3d.poses"):
            cfg = self.config
            p = np.asarray(pts, dtype=np.float64).reshape(-1, 3)
            dx, dy, dz = (p[1:] - p[:-1]).T.tolist()
            yaw = np.fromiter(itertools.chain((0.0,), map(math.atan2, dy, dx)),
                              np.float64, len(p))
            pitch = np.fromiter(
                itertools.chain((0.0,), map(math.atan2, dz, map(math.hypot, dx, dy))),
                np.float64, len(p))
            poses["built"] += len(p)
            return PathPoses3D(cfg.origin_x + p[:, 0] * cfg.resolution,
                               cfg.origin_y + p[:, 1] * cfg.resolution,
                               cfg.origin_z + p[:, 2] * cfg.resolution, yaw, pitch)

    def compute_path(
        self,
        start_world: tuple[float, float, float],
        step_size: float = 0.05,
        cd_precision: float = 0.5,
        max_length: int | None = None,
    ) -> PathPoses3D:
        """ComputePath: trilinear streamline from the current field (fetched
        to the host), as world poses (:class:`PathPoses3D`)."""
        with profiling.span("planner3d.compute_path"):
            st = self._require_state()
            d, h, w = st.u.shape
            if max_length is None:
                max_length = int(w * h * d / step_size)
            mx, my, mz = self.world_to_map(*start_world)
            pts = compute_path(G.host_u(st), G.host_locked(st), mx, my, mz,
                               step_size=step_size, cd_precision=cd_precision,
                               max_length=max_length)
            return self._poses(pts)

    def compute_paths_batch(
        self,
        starts_world,
        step_size: float = 0.05,
        cd_precision: float = 0.5,
        max_steps: int = 4096,
    ) -> list[PathPoses3D | None]:
        """Many 3D streamlines at once through the batched walker
        (:mod:`epic_tpu_torch.solver.batched_path3d`) on the planner's
        device. Entries are :class:`PathPoses3D`, or None for invalid starts
        or <= 2-point walks.
        Lanes are padded to a power of two (at least 8) with off-map starts,
        as in ``epic_tpu``."""
        st = self._require_state()
        starts_world = list(starts_world)
        starts_map, valid_idx = [], []
        for i, (wx, wy, wz) in enumerate(starts_world):
            try:
                starts_map.append(self.world_to_map(wx, wy, wz))
                valid_idx.append(i)
            except InvalidLocationError:
                continue
        results: list[PathPoses3D | None] = [None] * len(starts_world)
        if not starts_map:
            return results
        n_lanes = max(8, 1 << (len(starts_map) - 1).bit_length())
        padded = starts_map + [(-1.0, -1.0, -1.0)] * (n_lanes - len(starts_map))
        out = batched_path3d.walk(
            st.u, st.locked, np.asarray(padded, np.float32),
            step_size=step_size, cd_precision=cd_precision, max_steps=max_steps,
        )
        positions = out["positions"].cpu().numpy()
        lengths = out["lengths"].cpu().numpy()
        for lane, i in enumerate(valid_idx):
            n = int(lengths[lane])
            if n > 2:
                results[i] = self._poses(positions[lane, :n])
        return results
