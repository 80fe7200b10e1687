"""The comparison of the anytime mix (``benchmark/traffic/anytime.json``).

The node's field after a tick is warm-started and not converged, so no
answer of that loop can be held to a cold solve. Instead the plain reference
replays the window's recorded inputs from the map
(:mod:`benchmark.reference_anytime`: goal changes, cell edits and ticks,
in order), on the card in float32, and each compared answer is held to the
replay's state after that answer's cycle. Three numbers, each the worst over
the compared answers:

- ``field_gap``: the largest ``|u - u_ref| / max(1, |u_ref|)`` over every
  interior cell, the locked ones too: the edits' writes are part of what the
  program produced, so an edit left out or written with the wrong type shows
  here;
- ``sweeps_gap``: the difference of the iteration counters; exact, since a
  tick's count does not depend on the order of float operations;
- ``path_gap``: ``reference.step_gap`` of the program's path on the replay's
  field, in cells; the map's diagonal where only one side has a path.

The answers compared are a uniform sample of the window's cycles, the
longest path's, and the window's last cycle (the most state accumulated).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import check, reference, reference_anytime

LIMITS = {"field_gap": 0.01, "sweeps_gap": 0, "path_gap": 0.005}


@dataclasses.dataclass
class Answer:
    """One cycle's answer: what the program held after its tick and the path
    it returned, beside the window's inputs up to the end of the window."""

    cycle: int
    start: tuple[float, float]      # map cells, as the program was given it
    field: object                   # float32 [H, W]; a device tensor until the window closes
    sweeps: int                     # the program's iteration counter
    points: np.ndarray | None       # [k, 2] map cells; None for no path
    cycles: list                    # reference_anytime.Cycle, shared by a run's answers


def _frames(answers, obstacle, config, device, dtype=torch.float32) -> dict:
    cycles = answers[0].cycles if answers else []
    return reference_anytime.replay(obstacle, config["resolution_m"], config["origin_m"],
                                    cycles, {a.cycle for a in answers}, device, dtype)


def compare(answers: list[Answer], obstacle: np.ndarray, config: dict, walk: dict, device,
            frames: dict | None = None) -> dict[str, float]:
    """The three numbers over ``answers``; ``frames`` is the replay's
    states at their cycles, where already computed."""
    frames = frames or _frames(answers, obstacle, config, device)
    args = check.walk_args(obstacle, walk)
    missing = float(math.hypot(*obstacle.shape))
    out = {"field_gap": 0.0, "sweeps_gap": 0, "path_gap": 0.0}
    for a in answers:
        f = frames[a.cycle]
        every = np.zeros_like(f.locked)
        out["field_gap"] = max(out["field_gap"], check.field_gap(a.field, f.u, every))
        out["sweeps_gap"] = max(out["sweeps_gap"], abs(int(a.sweeps) - f.iteration))
        if a.points is not None and len(a.points):
            gap = reference.step_gap(f.u, f.locked, a.start, a.points, *args)
        else:
            (outcome, _), = reference.walk(f.u, f.locked, [a.start], *args)
            gap = 0.0 if outcome != reference.OK else missing
        out["path_gap"] = max(out["path_gap"], min(gap, missing))
    return out


def verdict(numbers: dict[str, float]) -> bool:
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)


def control(answers: list[Answer], obstacle: np.ndarray, config: dict, walk: dict, device,
            dtype=torch.bfloat16) -> dict[str, float]:
    """The control: the replay computed in ``dtype`` put in the program's
    place at the answers' cycles (its field, its counter, and its own walk
    from the answer's start), compared as a run's answers are."""
    frames = _frames(answers, obstacle, config, device)
    low = _frames(answers, obstacle, config, device, dtype)
    args = check.walk_args(obstacle, walk)
    stand_in = []
    for a in answers:
        f = low[a.cycle]
        (outcome, pts), = reference.walk(f.u, f.locked, [a.start], *args)
        stand_in.append(dataclasses.replace(a, field=f.u, sweeps=f.iteration,
                                            points=pts if outcome == reference.OK else None))
    return compare(stand_in, obstacle, config, walk, device, frames=frames)
