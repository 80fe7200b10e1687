"""Message/service dataclasses mirroring the reference's RPC schema.

The reference exposes ROS services (srv/*.srv) and
nav_msgs/geometry_msgs types. ROS itself is not part of this package; these
plain dataclasses carry the same fields so the service *semantics* (SURVEY
§2.1) are preserved and a thin ROS adapter could be layered on unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass
class PoseStamped:
    """geometry_msgs/PoseStamped subset used by the reference handlers."""

    x: float
    y: float
    yaw: float = 0.0
    frame_id: str = "map"
    stamp: float = 0.0


@dataclasses.dataclass
class Path:
    """nav_msgs/Path subset."""

    frame_id: str
    stamp: float
    poses: List[PoseStamped]


# --- srv request/response pairs (srv/*.srv) --------------------------------


@dataclasses.dataclass
class SetStatusRequest:      # srv/SetStatus.srv
    paused: bool


@dataclasses.dataclass
class SetStatusResponse:
    success: bool


@dataclasses.dataclass
class ModifyGoalsRequest:    # srv/ModifyGoals.srv
    goals: List[PoseStamped]


@dataclasses.dataclass
class ModifyGoalsResponse:
    success: bool


@dataclasses.dataclass
class GetCellRequest:        # srv/GetCell.srv
    x: int
    y: int


@dataclasses.dataclass
class GetCellResponse:
    success: bool
    value: float = 0.0


@dataclasses.dataclass
class SetCellsRequest:       # srv/SetCells.srv — (x, y) pairs in CELL coords
    v: List[int]
    types: List[int]


@dataclasses.dataclass
class SetCellsResponse:
    success: bool


@dataclasses.dataclass
class ResetFreeCellsRequest:  # srv/ResetFreeCells.srv
    pass


@dataclasses.dataclass
class ResetFreeCellsResponse:
    success: bool


@dataclasses.dataclass
class ComputePathRequest:    # srv/ComputePath.srv
    start: PoseStamped
    step_size: float = 0.05
    precision: float = 0.5
    max_length: int = 0      # 0 -> node default (w*h/step_size)


@dataclasses.dataclass
class ComputePathResponse:
    path: Path


@dataclasses.dataclass
class OccupancyGrid:
    """nav_msgs/OccupancyGrid subset (info + row-major int8 data)."""

    width: int
    height: int
    resolution: float
    origin_x: float
    origin_y: float
    data: "object"  # array-like [H*W] or [H, W], values -2..100
