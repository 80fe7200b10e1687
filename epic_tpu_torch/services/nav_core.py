"""move_base global-planner plugin semantics, without ROS.

The counterpart of ``epic_tpu.services.nav_core``: the reference's
EpicNavCorePlugin (src/epic_nav_core_plugin.cpp), a blocking per-replan
planner fed by a costmap. Unlike the anytime node, each ``make_plan``
performs a full solve-to-convergence before extracting the path (:256 calls
harmonic_complete_gpu). The grid lives on the plugin's ``device``; the solve
is :func:`epic_tpu_torch.solver.solve_grid`, so on the card it runs the
in-place kernels (K2) or, past two thirds of the L2, the tile solve
(``epic_tpu`` calls its plain ``core.solve`` here, which on a CUDA tensor
would be the port's slow reference path). The walk is
:func:`epic_tpu_torch.path.compute_path` (the native walker when it is
built).
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

from .. import constants as C
from .. import grid as G
from ..errors import EpicError, InvalidLocationError
from ..path import compute_path
from ..planner import PathPose
from .. import solver

COSTMAP_OBSTACLE_THRESHOLD = 250  # epic_nav_core_plugin.cpp:48


class EpicNavCorePlugin:
    """Blocking global planner over a costmap.

    Usage:
      plugin = EpicNavCorePlugin(device="cuda")
      plugin.initialize(costmap, resolution, origin)   # uint8 [H, W] costs
      plan = plugin.make_plan((sx, sy), (gx, gy))      # world coords

    ``solve_fn(state)`` is the solve to convergence, ``solver.solve_grid``
    by default (another, e.g. the plain ``core.solve``, is what a check
    holds it against).
    """

    def __init__(self, epsilon: float = 1e-3, interpolation: str = "reference", *,
                 device: torch.device | str, solve_fn: Callable | None = None):
        # epsilon default from epic_nav_core_plugin.cpp:61.
        self.epsilon = epsilon
        self.interpolation = interpolation
        self.device = torch.device(device)
        self.solve_fn = solve_fn or solver.solve_grid
        self.state: G.GridState | None = None
        self.resolution = 1.0
        self.origin_x = 0.0
        self.origin_y = 0.0
        self.last_plan: List[PathPose] | None = None  # publishPlan stand-in

    @property
    def initialized(self) -> bool:
        return self.state is not None

    def initialize(
        self,
        costmap: np.ndarray,
        resolution: float = 1.0,
        origin: tuple[float, float] = (0.0, 0.0),
    ) -> None:
        """Ingest a costmap (uint8 [H, W], 0..255): cost >=
        COSTMAP_OBSTACLE_THRESHOLD -> obstacle, else free (cost-0 "goal"
        cells become free space too); boundary ring forced obstacle
        (epic_nav_core_plugin.cpp:139-187)."""
        costmap = np.asarray(costmap)
        obstacle = costmap >= COSTMAP_OBSTACLE_THRESHOLD
        u = np.where(obstacle, C.LOG_SPACE_OBSTACLE, C.LOG_SPACE_FREE).astype(np.float32)
        locked = obstacle.copy()
        u[0, :] = u[-1, :] = C.LOG_SPACE_OBSTACLE
        u[:, 0] = u[:, -1] = C.LOG_SPACE_OBSTACLE
        locked[0, :] = locked[-1, :] = True
        locked[:, 0] = locked[:, -1] = True
        self.state = G.make_state(u, locked, epsilon=self.epsilon, device=self.device)
        self.resolution = float(resolution)
        self.origin_x, self.origin_y = map(float, origin)

    # -- transforms (epic_nav_core_plugin.cpp analogues of the node's) -----

    def map_to_world(self, mx: float, my: float) -> tuple[float, float]:
        return self.origin_x + mx * self.resolution, self.origin_y + my * self.resolution

    def world_to_map(self, wx: float, wy: float) -> tuple[float, float]:
        st = self.state
        h, w = st.u.shape
        if (
            wx < self.origin_x
            or wy < self.origin_y
            or wx >= self.origin_x + w * self.resolution
            or wy >= self.origin_y + h * self.resolution
        ):
            raise InvalidLocationError(f"world ({wx}, {wy}) outside costmap")
        return (wx - self.origin_x) / self.resolution, (wy - self.origin_y) / self.resolution

    def set_goal(self, x_goal: int, y_goal: int) -> None:
        """Single-goal semantics (epic_nav_core_plugin.cpp:341-366): every
        existing interior goal cell reverts to FREE, then the new goal is
        set — even if that cell was an obstacle, faithfully to the
        reference's unconditional assignment."""
        st = self.state
        u_np = G.host_u(st)
        h, w = u_np.shape
        interior = np.zeros((h, w), dtype=bool)
        interior[1:-1, 1:-1] = True
        old_goals = interior & (u_np == float(C.LOG_SPACE_GOAL))
        ys, xs = np.nonzero(old_goals)
        xy = list(zip(xs.tolist(), ys.tolist()))
        types = [C.CELL_TYPE_FREE] * len(xy)
        xy.append((int(x_goal), int(y_goal)))
        types.append(C.CELL_TYPE_GOAL)
        self.state = G.set_cells(st, xy, types)

    def make_plan(
        self,
        start_world: tuple[float, float],
        goal_world: tuple[float, float],
    ) -> List[PathPose] | None:
        """makePlan (epic_nav_core_plugin.cpp:234-338): set single goal,
        solve to convergence, extract streamline, return world poses with
        per-segment yaw (start first, goal appended last). Returns None on
        failure, as the reference returns false."""
        if not self.initialized:
            raise EpicError(2, "plugin not initialized")

        try:
            gx, gy = self.world_to_map(*goal_world)
            gx, gy = int(gx), int(gy)
        except InvalidLocationError:
            gx = gy = 0  # reference falls back to (0, 0) with a warning (:247-252)
        self.set_goal(gx, gy)

        self.state = self.solve_fn(self.state)

        try:
            sx, sy = self.world_to_map(*start_world)
        except InvalidLocationError:
            sx = sy = 0.0

        st = self.state
        h, w = st.u.shape
        step_size = 0.05
        cd_precision = 0.5
        max_length = int(h * w / step_size)
        u_np = G.host_u(st)
        locked_np = G.host_locked(st)
        try:
            pts = compute_path(
                u_np, locked_np, sx, sy,
                step_size=step_size,
                cd_precision=cd_precision,
                max_length=max_length,
                mode=self.interpolation,
            )
        except EpicError:
            return None

        plan: List[PathPose] = [PathPose(*start_world, 0.0)]
        for i in range(1, len(pts)):
            x, y = float(pts[i, 0]), float(pts[i, 1])
            yaw = math.atan2(y - float(pts[i - 1, 1]), x - float(pts[i - 1, 0]))
            wx, wy = self.map_to_world(x, y)
            plan.append(PathPose(wx, wy, yaw))
        plan.append(PathPose(*goal_world, plan[-1].yaw))
        self.last_plan = plan
        return plan
