"""The anytime planner: warm-started incremental re-solves + service verbs.

The counterpart of ``epic_tpu.planner`` (2D). The state is one ``GridState``
on the planner's device; edits are scatters into fresh tensors; ``update()``
is one launch of a CUDA kernel on the card (the plain torch version on the
CPU), which relaxes ``u`` in place — so there is no padded-buffer cache to
keep: the kernels take the grid as it is. ``solver.update_grid`` and
``solve_grid`` choose them (``epic_tpu``'s ``Planner._kernel_module``): the
in-place sweep kernels while the grid fits the card's L2, the temporally
blocked tile kernels beyond it (their ping-pong twin is scratch of
``solver.hopper_tile2d``).

Key semantic carried over (SURVEY §3.2): the planner NEVER stops relaxing —
edits perturb ``u``/``locked`` and relaxation resumes from the current state.

``cascade=True`` solves warm-start through a resolution pyramid
(``solver.cascade``): the coarse levels on the host's native C++ solve when
it is built, the fine level on the same route as a cold solve (K2 or the
tile solve on the card), with the same convergence certificate.
"""

from __future__ import annotations

import collections.abc
import dataclasses
import functools
import itertools
import logging
import math
import typing

import numpy as np
import torch

from . import constants as C
from . import grid as G
from .config import EpicConfig, SolverConfig, check_backend
from .errors import EpicError, InvalidLocationError
from .path import compute_path
from . import native, profiling, solver
from .solver import batched_path, cascade

logger = logging.getLogger("epic_tpu_torch.planner")

# ``built`` counts the world poses ``Planner._poses`` computes; ``boxed`` the
# ``PathPose`` objects a ``PathPoses`` makes for its callers (an index one,
# an iteration all of its poses, counted as it starts). Nothing else changes
# them.
poses = {"built": 0, "boxed": 0}


@dataclasses.dataclass
class PlannerConfig:
    """Typed config covering the reference's ROS-parameter surface
    (src/epic_navigation_node_main.cpp:43-68 + map_server YAML metadata)."""

    epsilon: float = C.DEFAULT_EPSILON_NODE
    stagger: int = C.DEFAULT_STAGGER
    steps_per_update: int = 50       # launch/epic_navigation_node_maze.launch:11
    resolution: float = 1.0
    origin_x: float = 0.0
    origin_y: float = 0.0
    interpolation: str = "reference"  # or "bilinear" (epic_tpu extension)
    # Kept so configs written for epic_tpu load; only "auto" is accepted
    # (the kernels on the card, the plain version on the CPU).
    backend: str = "auto"
    # Coarse-to-fine warm start (solver.cascade). Only this field turns it
    # on: a Planner built from an EpicConfig drops solver.cascade, as
    # epic_tpu's does (ROADMAP, known divergences: R9).
    cascade: bool = False

    def __post_init__(self):
        check_backend(self.backend)


class PathPose(typing.NamedTuple):
    """A path pose: world coordinates + yaw from the segment direction
    (epic_navigation_node_harmonic.cpp:655-668).

    Immutable and hashable; being a tuple, it also equals the plain tuple
    ``(x, y, yaw)``."""

    x: float
    y: float
    yaw: float


# A PathPose from an (x, y, yaw) tuple: ``PathPose._make`` without its
# length check, about a fifth cheaper per pose.
_box = functools.partial(tuple.__new__, PathPose)


class PathPoses(collections.abc.Sequence):
    """A path's world poses, held as three read-only float64 arrays ``x``,
    ``y`` and ``yaw``.

    A sequence of :class:`PathPose`: an index gives a pose (negative ones
    too), a slice another ``PathPoses``, and iteration makes each pose as it
    is reached, so a caller that reads the poses one by one keeps none of
    them alive. ``list(poses)`` gives the poses as a list."""

    __slots__ = ("_x", "_y", "_yaw")

    def __init__(self, x: np.ndarray, y: np.ndarray, yaw: np.ndarray):
        for a in (x, y, yaw):
            a.flags.writeable = False
        self._x, self._y, self._yaw = x, y, yaw

    @property
    def x(self) -> np.ndarray:
        return self._x

    @property
    def y(self) -> np.ndarray:
        return self._y

    @property
    def yaw(self) -> np.ndarray:
        return self._yaw

    def __len__(self) -> int:
        return len(self._x)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return PathPoses(self._x[i], self._y[i], self._yaw[i])
        pose = PathPose(float(self._x[i]), float(self._y[i]), float(self._yaw[i]))
        poses["boxed"] += 1
        return pose

    def __iter__(self):
        poses["boxed"] += len(self._x)
        return map(_box, zip(self._x.tolist(), self._y.tolist(), self._yaw.tolist()))


class Planner:
    """Incremental anytime harmonic planner with the reference's verbs.

    Verb mapping (srv/*.srv -> methods):
      SetStatus      -> set_status(paused)
      ModifyGoals +  -> add_goals(world_points)
      ModifyGoals -  -> remove_goals(world_points)
      GetCell        -> get_cell(x, y)
      SetCells       -> set_cells(xy_cells, types)     [cell coords, no transform]
      ResetFreeCells -> reset_free_cells()
      ComputePath    -> compute_path(start_world, ...)
      (OccupancyGrid subscriber) -> update_occupancy(grid, resolution, origin)
      (main loop)    -> update(num_steps)

    ``device`` places the grid: a CUDA device runs the kernels of
    ``csrc/sweep2d.cu``, or of ``csrc/tile2d.cu`` for a grid beyond the
    card's L2 (halo depth ``SolverConfig.tile_depth``); the CPU the plain
    torch version.
    """

    def __init__(self, config: "PlannerConfig | EpicConfig | None" = None, *,
                 device: torch.device | str):
        if isinstance(config, EpicConfig):
            self.solver_config = config.solver
            config = PlannerConfig(
                epsilon=config.solver.epsilon,
                stagger=config.solver.stagger,
                steps_per_update=config.service.steps_per_update,
                backend=config.solver.backend,
            )
        else:
            cfg = config or PlannerConfig()
            self.solver_config = SolverConfig(
                epsilon=cfg.epsilon, stagger=cfg.stagger, backend=cfg.backend)
        self.config = config or PlannerConfig()
        self.device = torch.device(device)
        self.state: G.GridState | None = None
        self.paused = False

    # -- lifecycle ---------------------------------------------------------

    @property
    def initialized(self) -> bool:
        return self.state is not None

    def init(self, width: int, height: int) -> None:
        """initAlg equivalent (epic_navigation_node_harmonic.cpp:207-244):
        u = 0 everywhere, unlocked, boundary ring forced obstacle."""
        self.state = G.empty_state(height, width, epsilon=self.config.epsilon,
                                   device=self.device)
        logger.info("planner init %dx%d eps=%g device=%s", width, height,
                    self.config.epsilon, self.device)

    def uninit(self) -> None:
        self.state = None

    def _require_state(self) -> G.GridState:
        if self.state is None:
            raise EpicError(2, "planner not initialized")
        return self.state

    # -- world <-> map transforms -----------------------------------------

    def map_to_world(self, mx: float, my: float) -> tuple[float, float]:
        """epic_navigation_node_harmonic.cpp:310-315."""
        return (
            self.config.origin_x + mx * self.config.resolution,
            self.config.origin_y + my * self.config.resolution,
        )

    def world_to_map(self, wx: float, wy: float) -> tuple[float, float]:
        """epic_navigation_node_harmonic.cpp:318-330; raises if outside."""
        cfg = self.config
        st = self._require_state()
        h, w = st.u.shape
        if (
            wx < cfg.origin_x
            or wy < cfg.origin_y
            or wx >= cfg.origin_x + w * cfg.resolution
            or wy >= cfg.origin_y + h * cfg.resolution
        ):
            raise InvalidLocationError(f"world ({wx}, {wy}) outside map")
        return (wx - cfg.origin_x) / cfg.resolution, (wy - cfg.origin_y) / cfg.resolution

    # -- the anytime loop --------------------------------------------------

    def update(self, num_steps: int | None = None) -> None:
        """Run a chunk of relaxation sweeps (no-op when paused / uninit),
        mirroring EpicNavigationNodeHarmonic::update (:165-204)."""
        with profiling.span("planner.update"):
            if self.state is None or self.paused:
                return
            n = num_steps if num_steps is not None else self.config.steps_per_update
            if n < 1:
                return
            self.state = solver.update_grid(self.state, n, self.solver_config.tile_depth)

    def solve(self, max_iterations: int | None = None) -> None:
        """Blocking solve-to-convergence (harmonic_complete semantics), as
        the nav_core plugin does per makePlan (epic_nav_core_plugin.cpp:256).
        With ``config.cascade`` the solve warm-starts through a resolution
        pyramid (``solver.cascade``): the same certificate, fewer sweeps;
        the coarse levels run on the native C++ solve when it is built, the
        fine level (capped) as a cold solve would.
        ``max_iterations`` caps the solve; a capped solve leaves
        ``state.converged`` False and can be resumed by calling again."""
        with profiling.span("planner.solve"):
            cap = 1_000_000 if max_iterations is None else int(max_iterations)
            depth = self.solver_config.tile_depth

            def final(st, stagger, max_iterations):
                return solver.solve_grid(st, stagger, min(max_iterations, cap), chunk_depth=depth)

            if self.config.cascade:
                coarse = cascade.native_solver if native.available() else final
                self.state, _ = cascade.solve_cascade(
                    self._require_state(), stagger=self.config.stagger, solver=final,
                    coarse_solver=coarse)
            else:
                self.state = final(self._require_state(), self.config.stagger, cap)

    # -- service verbs -----------------------------------------------------

    def set_status(self, paused: bool) -> bool:
        """srvSetStatus (:429-438)."""
        self.paused = bool(paused)
        return True

    def set_cells(self, xy, types) -> bool:
        """srvSetCells (:545-579): raw cell coordinates, no world transform."""
        with profiling.span("planner.set_cells"):
            st = self._require_state()
            self.state = G.set_cells(st, xy, types)
            return True

    def add_goals(self, world_points) -> bool:
        """srvAddGoals (:441-482): world coords -> cells; goals are refused
        inside obstacles; returns False if no goal could be added."""
        with profiling.span("planner.add_goals"):
            st = self._require_state()
            # One host fetch for the whole batch.
            u_np = G.host_u(st)
            locked_np = G.host_locked(st)
            h, w = u_np.shape
            xy = []
            for wx, wy in world_points:
                try:
                    mx, my = self.world_to_map(wx, wy)
                except InvalidLocationError:
                    continue
                cx, cy = int(mx + 0.5), int(my + 0.5)
                is_obstacle = not (0 <= cx < w and 0 <= cy < h) or (
                    bool(locked_np[cy, cx])
                    and float(u_np[cy, cx]) == float(C.LOG_SPACE_OBSTACLE)
                )
                if is_obstacle:
                    continue
                xy.append((int(mx), int(my)))
            if not xy:
                return False
            self.state = G.set_cells(st, xy, [C.CELL_TYPE_GOAL] * len(xy))
            return True

    def remove_goals(self, world_points) -> bool:
        """srvRemoveGoals (:485-519): removed goals become FREE cells."""
        with profiling.span("planner.remove_goals"):
            st = self._require_state()
            xy = []
            for wx, wy in world_points:
                try:
                    mx, my = self.world_to_map(wx, wy)
                except InvalidLocationError:
                    continue
                xy.append((int(mx), int(my)))
            if xy:
                self.state = G.set_cells(st, xy, [C.CELL_TYPE_FREE] * len(xy))
            return True

    def get_cell(self, x: int, y: int) -> float:
        """srvGetCell (:522-542): the cell's log hitting probability, a
        4-byte read from the device."""
        st = self._require_state()
        h, w = st.u.shape
        if not (0 <= x < w and 0 <= y < h):
            raise InvalidLocationError(f"cell ({x}, {y}) outside map")
        return float(st.u[y, x])

    def reset_free_cells(self) -> bool:
        """srvResetFreeCells (:582-611)."""
        with profiling.span("planner.reset_free_cells"):
            self.state = G.reset_free_cells(self._require_state())
            return True

    def update_occupancy(
        self,
        data: np.ndarray,
        resolution: float | None = None,
        origin: tuple[float, float] | None = None,
    ) -> None:
        """OccupancyGrid ingest (subOccupancyGrid, :383-426).

        ``data``: int [H, W], occupancy 0..100, or OCCUPANCY_NO_CHANGE (-2).
        Values >= 50 -> OBSTACLE, else FREE; NO_CHANGE and existing-goal
        cells untouched; size change triggers full reinit (goals are lost,
        as in the reference); boundary ring stays obstacle.
        """
        with profiling.span("planner.update_occupancy"):
            data = np.asarray(data)
            h, w = data.shape
            if self.state is None or tuple(self.state.u.shape) != (h, w):
                if self.state is not None:
                    logger.warning(
                        "occupancy resize %s -> (%d, %d): full reinit, goals lost"
                        " (reference behaviour)", tuple(self.state.u.shape), h, w)
                self.uninit()
                self.init(w, h)
            if resolution is not None:
                self.config.resolution = float(resolution)
            if origin is not None:
                self.config.origin_x, self.config.origin_y = map(float, origin)

            st = self._require_state()
            u_np = G.host_u(st)
            locked_np = G.host_locked(st)
            goal_mask = locked_np & (u_np == float(C.LOG_SPACE_GOAL))

            interior = np.zeros((h, w), dtype=bool)
            interior[1:-1, 1:-1] = True
            changeable = interior & (data != C.OCCUPANCY_NO_CHANGE) & ~goal_mask
            obstacle = changeable & (data >= C.OCCUPANCY_OBSTACLE_THRESHOLD)
            free = changeable & ~obstacle
            ys, xs = np.nonzero(obstacle | free)
            if len(ys) == 0:
                return
            types = np.where(obstacle[ys, xs], C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_FREE)
            self.state = G.set_cells(st, np.stack([xs, ys], axis=1), types)

    def compute_path(
        self,
        start_world: tuple[float, float],
        step_size: float = 0.05,
        cd_precision: float = 0.5,
        max_length: int | None = None,
    ) -> PathPoses:
        """srvComputePath (:614-674): extract a streamline from the current
        field (fetched to the host) and convert to world poses with
        per-segment yaw, returned as :class:`PathPoses`. Parameter defaults
        follow the rviz node (epic_navigation_node_harmonic_rviz.cpp:114-116);
        max_length defaults to w*h/step_size as there.
        """
        with profiling.span("planner.compute_path"):
            st = self._require_state()
            h, w = st.u.shape
            if max_length is None:
                max_length = int(w * h / step_size)
            mx, my = self.world_to_map(*start_world)
            pts = compute_path(
                G.host_u(st),
                G.host_locked(st),
                mx,
                my,
                step_size=step_size,
                cd_precision=cd_precision,
                max_length=max_length,
                mode=self.config.interpolation,
            )
            return self._poses(pts)

    def _poses(self, pts: np.ndarray) -> PathPoses:
        """Map-frame points -> world poses with per-segment yaw
        (epic_navigation_node_harmonic.cpp:655-668), in one pass over the
        points: ``map_to_world``'s float64 operations on whole arrays, and
        the yaw, 0 at the start, from ``math.atan2`` of each step's float64
        differences (``np.arctan2`` rounds some yaws differently)."""
        with profiling.span("planner.poses"):
            cfg = self.config
            p = np.asarray(pts, dtype=np.float64)
            dx, dy = (p[1:] - p[:-1]).T.tolist()
            yaw = np.fromiter(itertools.chain((0.0,), map(math.atan2, dy, dx)),
                              np.float64, len(p))
            poses["built"] += len(p)
            return PathPoses(cfg.origin_x + p[:, 0] * cfg.resolution,
                             cfg.origin_y + p[:, 1] * cfg.resolution, yaw)

    def compute_paths_batch(
        self,
        starts_world,
        step_size: float = 0.05,
        cd_precision: float = 0.5,
        max_steps: int = 4096,
        mode: str | None = None,
    ) -> list[PathPoses | None]:
        """Many streamlines at once through the batched walker
        (:mod:`epic_tpu_torch.solver.batched_path`) on the planner's device.
        Entries are :class:`PathPoses`, or None for invalid starts or
        <= 2-point walks (the reference's EPIC_ERROR_INVALID_PATH contract
        per lane). ``mode`` defaults to ``config.interpolation``.

        The lane count is padded to a power of two (at least 8) with
        off-map starts, as in ``epic_tpu``, so that lanes match its walker
        one for one."""
        st = self._require_state()
        starts_world = list(starts_world)
        if mode is None:
            mode = self.config.interpolation
        starts_map, valid_idx = [], []
        for i, (wx, wy) in enumerate(starts_world):
            try:
                starts_map.append(self.world_to_map(wx, wy))
                valid_idx.append(i)
            except InvalidLocationError:
                continue
        results: list[PathPoses | None] = [None] * len(starts_world)
        if not starts_map:
            return results
        n_lanes = max(8, 1 << (len(starts_map) - 1).bit_length())
        padded = starts_map + [(-1.0, -1.0)] * (n_lanes - len(starts_map))
        out = batched_path.walk(
            st.u, st.locked, np.asarray(padded, np.float32),
            step_size=step_size, cd_precision=cd_precision,
            max_steps=max_steps, mode=mode,
        )
        positions = out["positions"].cpu().numpy()
        lengths = out["lengths"].cpu().numpy()
        for lane, i in enumerate(valid_idx):
            n = int(lengths[lane])
            if n > 2:
                results[i] = self._poses(positions[lane, :n])
        return results
