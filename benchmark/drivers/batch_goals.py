"""Closed-loop goal batches: a fleet manager's one field per robot goal on a
shared map, and one path per robot.

Each batch is ``lanes`` goals with a start each. The batch is solved to
epsilon in one call of ``solver.hopper_batched.solve_batch_goals`` (the map
and the goal cells cross to the card, the lanes are built there), the fields
are copied to the host in one copy, and ``path.compute_path`` walks each
lane from its robot's start, as map points. The next batch is sent when this
one has returned. A lane fails if it did not converge, its walk raised, or
its path does not end in its goal cell.

Batch ``k`` takes goals and starts ``k * lanes`` to ``(k + 1) * lanes - 1``
of the run's seeded stream (:class:`benchmark.inputs.Stream`); the set-up's
warm batch takes the first ``lanes`` of the ``warmup_seed``'s stream.

Traffic keys: ``lanes``, ``warmup_seed``, ``step_size``, ``cd_precision``,
``interpolation``, ``max_iterations``, ``warmup_iterations`` (the set-up
batch's cap), ``check_sample`` (lanes compared with the reference, besides
the longest path).
"""

from __future__ import annotations

import time

from ..check import Answer
from .planner_goal import cell


def run(ctx) -> None:
    import torch

    from epic_tpu_torch import path
    from epic_tpu_torch.errors import EpicError
    from epic_tpu_torch.solver import hopper_batched

    cfg, mix, m = ctx.config, ctx.traffic, ctx.map
    lanes = mix["lanes"]
    h, w = m.shape
    base_u = torch.full((h, w), -1e6, dtype=torch.float32, device=ctx.device)
    base_locked = torch.as_tensor(m.obstacle, device=ctx.device)
    # The fleet manager's own copy of each lane's locked cells: the map, its
    # edge, and the lane's goal.
    locked = m.obstacle.copy()
    locked[0, :] = locked[-1, :] = locked[:, 0] = locked[:, -1] = True
    max_length = int(w * h / mix["step_size"])

    ctx.mark("program")

    def batch(stream, k: int, cap: int = mix["max_iterations"]) -> None:
        goals, starts = stream.take(k * lanes, lanes)
        t0 = time.perf_counter()
        with ctx.spans("batch"):
            with ctx.spans("batch.solve"):
                u, iters, _, converged = hopper_batched.solve_batch_goals(
                    base_u, base_locked, goals[:, None, :], epsilon=cfg["epsilon"],
                    stagger=cfg["stagger"], max_iterations=cap, device=ctx.device)
                iters, converged = iters.cpu().numpy(), converged.cpu().numpy()
            with ctx.spans("batch.copy"):
                fields = u.cpu().numpy()
            walks = []
            with ctx.spans("walker"):
                for lane in range(lanes):
                    gx, gy = goals[lane]
                    locked[gy, gx] = True
                    try:
                        pts = path.compute_path(
                            fields[lane], locked, float(starts[lane][0]),
                            float(starts[lane][1]), step_size=mix["step_size"],
                            cd_precision=mix["cd_precision"], max_length=max_length,
                            mode=mix["interpolation"])
                    except EpicError:
                        pts = None
                    locked[gy, gx] = m.obstacle[gy, gx]
                    walks.append(pts)
        t1 = time.perf_counter()
        ctx.group(start=t0, end=t1, lanes=lanes, cells=h * w)
        for lane, pts in enumerate(walks):
            goal = (int(goals[lane][0]), int(goals[lane][1]))
            reached = pts is not None and (cell(pts[-1, 0]), cell(pts[-1, 1])) == goal
            ctx.record(start=t0, end=t1, ok=bool(converged[lane]) and reached, goal=goal,
                       sweeps=int(iters[lane]), points=0 if pts is None else len(pts))
            ctx.answer(0 if pts is None else len(pts), lambda: Answer(
                goal=goal, start=tuple(map(float, starts[lane])),
                field=fields[lane].copy(), sweeps=int(iters[lane]), points=pts))

    # Set-up: this traffic's one shape, a batch capped at a few checks.
    batch(ctx.stream(warmup=True), 0, cap=mix["warmup_iterations"])
    ctx.clear()
    ctx.mark("warm")
    stream = ctx.stream()
    ctx.window(lambda k: batch(stream, k))
