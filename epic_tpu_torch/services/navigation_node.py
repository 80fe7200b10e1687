"""The anytime navigation node — service handlers + update loop.

The counterpart of ``epic_tpu.services.navigation_node``: the reference's
EpicNavigationNodeHarmonic[Rviz] (src/epic_navigation_node_harmonic.cpp,
epic_navigation_node_harmonic_rviz.cpp) without ROS. Handlers take/return the
dataclasses from :mod:`epic_tpu_torch.services.messages`, and ``run``
reproduces the main loop (src/epic_navigation_node_main.cpp:62-81): service
callbacks between chunks of ``steps_per_update`` relaxation sweeps at
``update_rate`` Hz.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional

import numpy as np
import torch

from ..errors import EpicError
from ..planner import Planner, PlannerConfig
from . import messages as msg


class EpicNavigationNode:
    """Anytime planner node. All 7 reference services + occupancy ingest."""

    def __init__(
        self,
        config: PlannerConfig | None = None,
        update_rate: float = 10.0,   # epic_navigation_node_main.cpp:66 default
        planner: Planner | None = None,
        *,
        device: torch.device | str | None = None,
    ):
        # An injected planner runs the same verb surface — the node itself
        # is planner-implementation-agnostic. Without one, the node builds a
        # Planner on ``device``.
        if planner is None:
            if device is None:
                raise ValueError("pass a planner or the device to build one on")
            planner = Planner(config, device=device)
        self.planner = planner
        self.update_rate = update_rate

    # --- subscriber ------------------------------------------------------

    def sub_occupancy_grid(self, grid: msg.OccupancyGrid) -> None:
        data = np.asarray(grid.data).reshape(grid.height, grid.width)
        self.planner.update_occupancy(
            data,
            resolution=grid.resolution,
            origin=(grid.origin_x, grid.origin_y),
        )

    # --- services --------------------------------------------------------

    def srv_set_status(self, req: msg.SetStatusRequest) -> msg.SetStatusResponse:
        return msg.SetStatusResponse(success=self.planner.set_status(req.paused))

    def srv_add_goals(self, req: msg.ModifyGoalsRequest) -> msg.ModifyGoalsResponse:
        ok = self.planner.add_goals([(g.x, g.y) for g in req.goals])
        return msg.ModifyGoalsResponse(success=ok)

    def srv_remove_goals(self, req: msg.ModifyGoalsRequest) -> msg.ModifyGoalsResponse:
        ok = self.planner.remove_goals([(g.x, g.y) for g in req.goals])
        return msg.ModifyGoalsResponse(success=ok)

    def srv_get_cell(self, req: msg.GetCellRequest) -> msg.GetCellResponse:
        try:
            return msg.GetCellResponse(success=True, value=self.planner.get_cell(req.x, req.y))
        except EpicError:
            return msg.GetCellResponse(success=False)

    def srv_set_cells(self, req: msg.SetCellsRequest) -> msg.SetCellsResponse:
        xy = [(req.v[2 * i], req.v[2 * i + 1]) for i in range(len(req.types))]
        return msg.SetCellsResponse(success=self.planner.set_cells(xy, req.types))

    def srv_reset_free_cells(
        self, req: msg.ResetFreeCellsRequest
    ) -> msg.ResetFreeCellsResponse:
        return msg.ResetFreeCellsResponse(success=self.planner.reset_free_cells())

    def srv_compute_path(self, req: msg.ComputePathRequest) -> msg.ComputePathResponse:
        max_length = req.max_length if req.max_length > 0 else None
        poses = self.planner.compute_path(
            (req.start.x, req.start.y),
            step_size=req.step_size,
            cd_precision=req.precision,
            max_length=max_length,
        )
        out = [msg.PoseStamped(p.x, p.y, p.yaw, req.start.frame_id, req.start.stamp) for p in poses]
        # The first pose is the request's start, verbatim
        # (epic_navigation_node_harmonic.cpp:651-653).
        out[0] = req.start
        return msg.ComputePathResponse(
            path=msg.Path(req.start.frame_id, req.start.stamp, out)
        )

    # --- main loop -------------------------------------------------------

    def update(self, num_steps: int | None = None) -> None:
        self.planner.update(num_steps)

    def run(
        self,
        duration_s: float,
        callbacks: Optional[List[Callable[[], None]]] = None,
        realtime: bool = False,
    ) -> int:
        """The anytime outer loop (epic_navigation_node_main.cpp:72-81):
        process callbacks, then relax ``steps_per_update`` sweeps, at
        ``update_rate`` Hz. Returns the number of ticks executed.

        With realtime=False the loop runs as fast as the device allows
        (no sleeps) for ``duration_s`` wall seconds.
        """
        period = 1.0 / self.update_rate
        t_end = time.monotonic() + duration_s
        ticks = 0
        while time.monotonic() < t_end:
            t0 = time.monotonic()
            for cb in callbacks or []:
                cb()
            self.update()
            ticks += 1
            if realtime:
                dt = time.monotonic() - t0
                if dt < period:
                    time.sleep(period - dt)
        return ticks


class EpicNavigationNodeRviz(EpicNavigationNode):
    """Adds the rviz-interaction verbs
    (src/epic_navigation_node_harmonic_rviz.cpp):

    - set_start (sub /initialpose, :95-121): compute + return a path;
    - set_goal (sub /move_base_simple/goal, :124-151): remove the previous
      goal, add the new one.
    """

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._last_goal: msg.PoseStamped | None = None

    def set_start(self, pose: msg.PoseStamped) -> msg.ComputePathResponse:
        # Parameter choice mirrors the rviz node (:114-116).
        return self.srv_compute_path(
            msg.ComputePathRequest(start=pose, step_size=0.05, precision=0.5)
        )

    def set_goal(self, pose: msg.PoseStamped) -> bool:
        if self._last_goal is not None:
            self.srv_remove_goals(msg.ModifyGoalsRequest(goals=[self._last_goal]))
        ok = self.srv_add_goals(msg.ModifyGoalsRequest(goals=[pose])).success
        if ok:
            self._last_goal = pose
        return ok
