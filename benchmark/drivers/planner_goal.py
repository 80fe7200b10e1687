"""Closed-loop plan requests through the Planner's verbs, one caller.

Each request is move_base's ``makePlan`` after a new goal on the upstream
node: reset the field to its initial values (``reset_free_cells``), set the
previous goal back to FREE and the new one to GOAL (``set_cells``), solve to
epsilon (``solve``), and walk one path from the robot's pose
(``compute_path``, world poses). The next request is sent when this one has
returned. A request fails if its solve did not converge, its walk raised,
or its path does not end in the goal cell.

Request ``k`` takes the ``k``-th goal and start of the run's seeded stream
(:class:`benchmark.inputs.Stream`); the set-up's warm request takes the first
of the ``warmup_seed``'s stream.

Traffic keys: ``warmup_seed``, ``step_size``, ``cd_precision``,
``interpolation``, ``max_iterations`` (the solve's cap), ``check_sample``
(answers compared with the reference, besides the longest path).
"""

from __future__ import annotations

import time

import numpy as np

from ..check import Answer


def cell(v: float) -> int:
    """The cell of a map coordinate, as the walker truncates it."""
    f = np.float32(v) + np.float32(0.5)
    return -1 if f < 0 else int(f)


def run(ctx) -> None:
    from epic_tpu_torch import constants as C
    from epic_tpu_torch.errors import EpicError
    from epic_tpu_torch.planner import Planner, PlannerConfig

    cfg, mix, m = ctx.config, ctx.traffic, ctx.map
    planner = Planner(PlannerConfig(
        epsilon=cfg["epsilon"], stagger=cfg["stagger"],
        steps_per_update=cfg["steps_per_update"], resolution=m.resolution,
        origin_x=m.origin[0], origin_y=m.origin[1], interpolation=mix["interpolation"]),
        device=ctx.device)
    # The map as the node's OccupancyGrid subscriber receives it.
    planner.update_occupancy(np.where(m.obstacle, 100, 0).astype(np.int16), m.resolution,
                             m.origin)
    prev = [None]

    def to_map(poses):
        """The poses' points in map cells (no pose object outlives its
        request: they would slow every full collection of the heap)."""
        if poses is None:
            return None
        return np.stack(m.to_map(np.array([p.x for p in poses]),
                                 np.array([p.y for p in poses])), axis=1)

    ctx.mark("program")

    def request(stream, k: int) -> None:
        (gx, gy), (sx, sy) = (v[0] for v in stream.take(k))
        goal = (int(gx), int(gy))
        start = m.to_world(float(sx), float(sy))
        t0 = time.perf_counter()
        with ctx.spans("request"):
            with ctx.spans("planner.edit"):
                planner.reset_free_cells()
                xy = [goal] if prev[0] is None else [prev[0], goal]
                planner.set_cells(xy, [C.CELL_TYPE_FREE] * (len(xy) - 1) + [C.CELL_TYPE_GOAL])
            with ctx.spans("planner.solve"):
                planner.solve(max_iterations=mix["max_iterations"])
                converged = bool(planner.state.converged)
                sweeps = int(planner.state.iteration)
            with ctx.spans("walker"):
                try:
                    poses = planner.compute_path(start, step_size=mix["step_size"],
                                                 cd_precision=mix["cd_precision"])
                except EpicError:
                    poses = None
        t1 = time.perf_counter()
        prev[0] = goal
        reached = bool(poses) and (cell((poses[-1].x - m.origin[0]) / m.resolution),
                                   cell((poses[-1].y - m.origin[1]) / m.resolution)) == goal
        ctx.record(start=t0, end=t1, ok=converged and reached, goal=goal, sweeps=sweeps,
                   points=len(poses) if poses else 0)
        field = planner.state.u
        ctx.answer(len(poses) if poses else 0, lambda: Answer(
            goal=goal, start=tuple(map(float, m.to_map(*start))), field=field.clone(),
            sweeps=sweeps, points=to_map(poses)))

    # Set-up: this traffic's one shape, a whole request.
    request(ctx.stream(warmup=True), 0)
    ctx.clear()
    ctx.mark("warm")
    stream = ctx.stream()
    ctx.window(lambda k: request(stream, k))
