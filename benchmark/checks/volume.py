"""The comparison of the volume mixes (``benchmark/traffic/volume_goal_solve.json``).

After the window has closed, the run hands a sample of its answers here:
for each, the goal and start voxels it was given, and what the program
returned (its field, its sweep count and its path in voxels). The plain
reference (:mod:`benchmark.reference_volume`) rebuilds the volume from the
same plan and configuration (:func:`benchmark.volume.locked`), solves each
goal cold on the card, and checks each path a step at a time on the host.
Three numbers, each the worst over the sample, with the definitions of
``benchmark/check.py`` over a volume:

- ``field_gap``: the largest ``|u - u_ref| / max(1, |u_ref|)`` over the
  voxels the solve relaxes (unlocked and inside the shell);
- ``sweeps_gap``: the largest difference of sweep counts;
- ``path_gap``: ``reference_volume.step_gap`` of the program's path on the
  reference's field, in voxels; the volume's diagonal where the path breaks
  the rule, or where only one side has a path.

``LIMITS`` holds each number's limit (the 2D check's); ``PERF.md`` gives the
readings they were set from.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import reference_volume as ref_mod
from .. import volume

LIMITS = {"field_gap": 0.01, "sweeps_gap": 1000, "path_gap": 0.005}
# The control's solves stop this many sweeps past the program's longest;
# its walks stop at this many points (a walk on a field that never settles
# may circle without end), and are checked against that budget.
CONTROL_EXTRA_SWEEPS = 5000
CONTROL_WALK_POINTS = 200_000


@dataclasses.dataclass
class Answer:
    """One request's inputs and the program's answer to it."""

    goal: tuple[int, int, int]          # voxel (x, y, z)
    start: tuple[float, float, float]   # voxels, as the program was given it
    field: object                       # float32 [D, H, W]; a device tensor until the window closes
    sweeps: int
    points: np.ndarray | None           # [k, 3] voxels; None for no path


def field_gap(u: np.ndarray, ref: np.ndarray, locked: np.ndarray) -> float:
    inner = (slice(1, -1),) * 3
    free = ~locked[inner]
    if not free.any():
        return 0.0
    p, r = u[inner][free].astype(np.float64), ref[inner][free].astype(np.float64)
    with np.errstate(invalid="ignore"):
        gap = np.abs(p - r) / np.maximum(1.0, np.abs(r))
    return float(np.nan_to_num(gap, nan=np.inf).max())


def max_length(obstacle: np.ndarray, config: dict, walk: dict) -> int:
    """The walk's point budget, the program's default: ``w * h * d / step``."""
    d, h, w = volume.shape(obstacle, config)
    return int(w * h * d / walk["step_size"])


def reference_solves(answers: list[Answer], obstacle: np.ndarray, config: dict, device,
                     dtype=torch.float32, cap: int = 1_000_000) -> list[tuple]:
    """Each answer's goal solved cold on ``device`` in ``dtype``: ``(field
    float32 [D, H, W], locked, sweeps)`` on the host, one a goal."""
    base = volume.locked(obstacle, config)
    out = []
    for a in answers:
        u, locked = ref_mod.initial_field(base, a.goal, device, dtype)
        u, sweeps, _ = ref_mod.solve(u, locked, config["epsilon"], config["stagger"], cap)
        out.append((u.float().cpu().numpy(), locked.cpu().numpy(), sweeps))
        del u, locked
    return out


def compare(answers: list[Answer], obstacle: np.ndarray, config: dict, walk: dict, device,
            refs: list | None = None, budget: int | None = None) -> dict[str, float]:
    """The three numbers over ``answers``; ``refs`` is the reference's
    :func:`reference_solves` for them, where already computed, and
    ``budget`` the walks' point budget where it is not the program's."""
    refs = refs or reference_solves(answers, obstacle, config, device)
    n = budget or max_length(obstacle, config, walk)
    args = (walk["step_size"], walk["cd_precision"], n)
    missing = float(math.hypot(*volume.shape(obstacle, config)))
    out = {"field_gap": 0.0, "sweeps_gap": 0, "path_gap": 0.0}
    for a, (u, locked, sweeps) in zip(answers, refs):
        out["field_gap"] = max(out["field_gap"], field_gap(a.field, u, locked))
        out["sweeps_gap"] = max(out["sweeps_gap"], abs(int(a.sweeps) - int(sweeps)))
        if a.points is not None and len(a.points):
            gap = ref_mod.step_gap(u, locked, a.start, a.points, *args)
        else:
            outcome, _ = ref_mod.walk(u, locked, a.start, *args)
            gap = 0.0 if outcome != ref_mod.OK else missing
        out["path_gap"] = max(out["path_gap"], min(gap, missing))
    return out


def verdict(numbers: dict[str, float]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def control(answers: list[Answer], obstacle: np.ndarray, config: dict, walk: dict, device,
            dtype=torch.bfloat16) -> dict[str, float]:
    """The control: the reference computed in ``dtype`` put in the program's
    place for the same goals and starts (its field, its sweep count, and its
    own walk from the answer's start, at most ``CONTROL_WALK_POINTS``
    points), compared as a run's answers are, with that point budget."""
    cap = max((int(a.sweeps) for a in answers), default=0) + CONTROL_EXTRA_SWEEPS
    low = reference_solves(answers, obstacle, config, device, dtype, cap)
    args = (walk["step_size"], walk["cd_precision"], CONTROL_WALK_POINTS)
    stand_in = []
    for a, (u, locked, sweeps) in zip(answers, low):
        outcome, pts = ref_mod.walk(u, locked, a.start, *args)
        stand_in.append(dataclasses.replace(a, field=u, sweeps=sweeps,
                                            points=pts if outcome == ref_mod.OK else None))
    return compare(stand_in, obstacle, config, walk, device, budget=CONTROL_WALK_POINTS)
