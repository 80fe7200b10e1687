"""Closed-loop plan requests through the VolumePlanner's verbs, one caller.

Each request is a 3D planner's blocking ``makePlan`` after a new goal:
reset the field to its initial values (``reset_free_cells``), set the
previous goal voxel back to FREE and the new one to GOAL (``set_cells``),
solve to epsilon (``solve``), and walk one path from the flyer's pose
(``compute_path``, world poses). The next request is sent when this one has
returned. A request fails if its solve did not converge, its walk raised,
or its path does not end in the goal voxel.

The volume is the configuration's storey (:mod:`benchmark.volume`), ingested
once in set-up (``update_occupancy``, an int16 0/100 volume). Request ``k``
takes the ``k``-th goal and start of the run's seeded stream
(:class:`benchmark.volume.Stream`); the set-up's warm request takes the
first of the ``warmup_seed``'s stream.

Traffic keys: ``warmup_seed``, ``step_size``, ``cd_precision``,
``max_iterations`` (the solve's cap), ``check_sample`` (answers compared
with the reference, besides the longest path).
"""

from __future__ import annotations

import time

import numpy as np

from .. import volume
from ..checks.volume import Answer
from .planner_goal import cell


def run(ctx) -> None:
    from epic_tpu_torch import constants as C
    from epic_tpu_torch.errors import EpicError
    # The driver reads the walker's poses as arrays (``PathPoses3D``): a
    # program without them cannot run this mix, and fails here, before its
    # set-up.
    from epic_tpu_torch.planner3d import PathPoses3D  # noqa: F401
    from epic_tpu_torch.planner3d import VolumePlanner, VolumePlannerConfig

    cfg, mix, m = ctx.config, ctx.traffic, ctx.map
    origin = tuple(float(v) for v in cfg["origin_m"])
    res = m.resolution
    band = cfg["volume"]["z_band"]
    planner = VolumePlanner(VolumePlannerConfig(
        epsilon=cfg["epsilon"], stagger=cfg["stagger"], resolution=res,
        origin_x=origin[0], origin_y=origin[1], origin_z=origin[2]), device=ctx.device)
    planner.update_occupancy(volume.occupancy(m.obstacle, cfg), res, origin)
    prev = [None]

    def to_world(v) -> tuple[float, float, float]:
        return tuple(o + float(c) * res for o, c in zip(origin, v))

    ctx.mark("program")

    def request(stream, k: int) -> None:
        (goal,), (start,) = stream.take(k)
        goal = tuple(int(v) for v in goal)
        start_w = to_world(start)
        t0 = time.perf_counter()
        with ctx.spans("request"):
            with ctx.spans("planner.edit"):
                planner.reset_free_cells()
                xyz = [goal] if prev[0] is None else [prev[0], goal]
                planner.set_cells(xyz, [C.CELL_TYPE_FREE] * (len(xyz) - 1) + [C.CELL_TYPE_GOAL])
            with ctx.spans("planner.solve"):
                planner.solve(max_iterations=mix["max_iterations"])
                converged = bool(planner.state.converged)
                sweeps = int(planner.state.iteration)
            with ctx.spans("walker"):
                try:
                    poses = planner.compute_path(start_w, step_size=mix["step_size"],
                                                 cd_precision=mix["cd_precision"])
                except EpicError:
                    poses = None
        t1 = time.perf_counter()
        prev[0] = goal
        if poses is not None:
            pts = np.stack([(poses.x - origin[0]) / res, (poses.y - origin[1]) / res,
                            (poses.z - origin[2]) / res], axis=1)
            reached = tuple(cell(v) for v in pts[-1]) == goal
        else:
            pts, reached = None, False
        n = len(pts) if pts is not None else 0
        ctx.record(start=t0, end=t1, ok=converged and reached, goal=goal, sweeps=sweeps,
                   points=n)
        field = planner.state.u
        ctx.answer(n, lambda: Answer(
            goal=goal, start=tuple((c - o) / res for c, o in zip(start_w, origin)),
            field=field.clone(), sweeps=sweeps, points=pts))

    # Set-up: this traffic's one shape, a whole request.
    request(volume.Stream(m, mix["warmup_seed"], band), 0)
    ctx.clear()
    ctx.mark("warm")
    stream = volume.Stream(m, ctx.seed, band)
    ctx.window(lambda k: request(stream, k))
