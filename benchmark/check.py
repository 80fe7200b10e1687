"""The comparison that decides ``correct``.

After the window has closed, the run hands a sample of its answers here: for
each, the goal and start it was given, and what the program returned (its
field, its sweep count and its path in map cells). The plain reference
(:mod:`benchmark.reference`) solves the same goals from the same map on the
card and walks from the same starts on the host, and three numbers are
compared, each the worst over the sample:

- ``field_gap``: the largest ``|u - u_ref| / max(1, |u_ref|)`` over the
  cells the solve relaxes (unlocked and inside the ring);
- ``sweeps_gap``: the largest difference of sweep counts;
- ``path_gap``: the largest distance, in cells, between a point of the
  program's path and the step the walk rule takes on the reference's field
  from the point before it (``reference.step_gap``: the path is checked a
  step at a time from its own points, its start, and where it ends, so a
  path that is the reference's walk reads 0); the map's diagonal where the
  path breaks the rule, or where only one side has a path.

``LIMITS`` holds each number's limit; ``PERF.md`` gives the readings they
were set from.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from . import reference

LIMITS = {"field_gap": 0.01, "sweeps_gap": 1000, "path_gap": 0.005}


@dataclasses.dataclass
class Answer:
    """One request's inputs and the program's answer to it."""

    goal: tuple[int, int]
    start: tuple[float, float]      # map cells, as the program was given it
    field: object                   # float32 [H, W]; a device tensor until the window closes
    sweeps: int
    points: np.ndarray | None       # [k, 2] map cells; None for no path


def field_gap(u: np.ndarray, ref: np.ndarray, locked: np.ndarray) -> float:
    inner = (slice(1, -1), slice(1, -1))
    free = ~locked[inner]
    if not free.any():
        return 0.0
    p, r = u[inner][free].astype(np.float64), ref[inner][free].astype(np.float64)
    with np.errstate(invalid="ignore"):
        gap = np.abs(p - r) / np.maximum(1.0, np.abs(r))
    return float(np.nan_to_num(gap, nan=np.inf).max())


def walk_args(obstacle: np.ndarray, walk: dict) -> tuple:
    """The walk rule's step, central-difference precision, point budget
    (``srvComputePath``'s ``w * h / step``) and interpolation."""
    h, w = obstacle.shape
    return (walk["step_size"], walk["cd_precision"], int(w * h / walk["step_size"]),
            walk["interpolation"])


def reference_fields(obstacle: np.ndarray, goals, config: dict, device,
                     dtype=torch.float32, max_iterations: int = 1_000_000):
    """The reference's fields and sweep counts for ``goals``, solved on
    ``device`` in ``dtype`` (float32 for the reference, lower for the
    control). Returns ``(fields [B, H, W] float32, locked, sweeps)`` on the
    host."""
    u, locked = reference.initial_lanes(obstacle, goals, device, dtype)
    u, sweeps, _ = reference.solve(u, locked, config["epsilon"], config["stagger"],
                                   max_iterations)
    return u.float().cpu().numpy(), locked.cpu().numpy(), sweeps


def compare(answers: list[Answer], obstacle: np.ndarray, config: dict, walk: dict,
            device, ref=None) -> dict[str, float]:
    """The three numbers over ``answers``; ``ref`` is the reference's
    ``reference_fields`` for their goals, where already computed."""
    fields, locked, sweeps = ref or reference_fields(obstacle, [a.goal for a in answers],
                                                     config, device)
    args = walk_args(obstacle, walk)
    missing = float(math.hypot(*obstacle.shape))
    out = {"field_gap": 0.0, "sweeps_gap": 0, "path_gap": 0.0}
    for i, a in enumerate(answers):
        out["field_gap"] = max(out["field_gap"], field_gap(a.field, fields[i], locked[i]))
        out["sweeps_gap"] = max(out["sweeps_gap"], abs(int(a.sweeps) - int(sweeps[i])))
        if a.points is not None and len(a.points):
            gap = reference.step_gap(fields[i], locked[i], a.start, a.points, *args)
        else:
            (outcome, _), = reference.walk(fields[i], locked[i], [a.start], *args)
            gap = 0.0 if outcome != reference.OK else missing
        out["path_gap"] = max(out["path_gap"], min(gap, missing))
    return out


def verdict(numbers: dict[str, float]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
