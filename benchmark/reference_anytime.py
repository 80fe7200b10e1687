"""The plain reference of the anytime mix: the upstream node's loop replayed
from its recorded inputs, in plain PyTorch.

This module is part of the yardstick, beside :mod:`benchmark.reference`,
whose update and walk it uses. It imports torch and NumPy only, nothing of
the program under test, and takes nothing the program made: it starts from
the configuration's map and replays what the benchmark sent, cycle by cycle
(:class:`Cycle`), in the order the node receives it, with the semantics of
the upstream node (kylewray/epic, ``epic_navigation_node_harmonic.cpp``):

- ``srvRemoveGoals``: each world point to its map cell (truncated), written
  FREE (-1e6, unlocked); a point off the map is skipped.
- ``srvAddGoals``: a point off the map, or whose rounded cell is an
  obstacle (locked at -1e6), is skipped; the others' truncated cells are
  written GOAL (0, locked).
- ``srvSetCells``: ``(x, y, type)`` writes in order (a later write to a
  cell wins), GOAL 0 locked, OBSTACLE -1e6 locked, FREE -1e6 unlocked;
  cells off the map and unknown types are skipped.
- ``update``: ``sweeps`` red-black sweeps from the running iteration count
  (:func:`benchmark.reference.solve`'s sweep: the cells with ``(y + x) % 2
  != t % 2`` at iteration ``t``), which then grows by ``sweeps``.

The field starts where the window starts: every cell -1e6, locked at the
map's obstacles and its edge, iteration 0.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import reference

GOAL, OBSTACLE, FREE = 0, 1, 2      # cell types, as srvSetCells numbers them
_VALUE = {GOAL: reference.GOAL, OBSTACLE: reference.OBSTACLE, FREE: reference.OBSTACLE}
_LOCKED = {GOAL: True, OBSTACLE: True, FREE: False}


@dataclasses.dataclass
class Cycle:
    """One cycle's inputs, in the order the node takes them."""

    cells: np.ndarray       # srvSetCells: [n, 2] int (x, y)
    types: np.ndarray       # and [n] int
    remove_goals: list      # world points (x, y)
    add_goals: list         # world points (x, y)
    sweeps: int


@dataclasses.dataclass
class Frame:
    """The replay's state after a cycle's tick, on the host."""

    u: np.ndarray           # float32 [H, W]
    locked: np.ndarray      # bool [H, W]
    iteration: int


class Replay:
    """The node's field on ``device`` in ``dtype``, driven by
    :meth:`cycle`."""

    def __init__(self, obstacle: np.ndarray, resolution: float, origin, device,
                 dtype=torch.float32):
        obstacle = np.asarray(obstacle, dtype=bool)
        self.h, self.w = obstacle.shape
        self.resolution, self.origin = float(resolution), tuple(map(float, origin))
        locked = np.array(obstacle)
        locked[0, :] = locked[-1, :] = locked[:, 0] = locked[:, -1] = True
        self.u = torch.full(obstacle.shape, reference.OBSTACLE, device=device).to(dtype)
        self.locked = torch.tensor(locked, device=device)
        self.iteration = 0

    def _to_map(self, wx: float, wy: float):
        """The world point's map coordinates, or None off the map."""
        ox, oy = self.origin
        if not (ox <= wx < ox + self.w * self.resolution
                and oy <= wy < oy + self.h * self.resolution):
            return None
        return (wx - ox) / self.resolution, (wy - oy) / self.resolution

    def _write(self, writes: dict) -> None:
        """Write ``{(x, y): type}`` into the field."""
        if not writes:
            return
        (xs, ys), types = zip(*writes.keys()), list(writes.values())
        idx = (torch.tensor(ys, device=self.u.device), torch.tensor(xs, device=self.u.device))
        self.u[idx] = torch.tensor([_VALUE[t] for t in types], device=self.u.device
                                   ).to(self.u.dtype)
        self.locked[idx] = torch.tensor([_LOCKED[t] for t in types], device=self.u.device)

    def remove_goals(self, points) -> None:
        writes = {}
        for wx, wy in points:
            m = self._to_map(wx, wy)
            if m is not None:
                writes[(int(m[0]), int(m[1]))] = FREE
        self._write(writes)

    def add_goals(self, points) -> None:
        writes = {}
        for wx, wy in points:
            m = self._to_map(wx, wy)
            if m is None:
                continue
            cx, cy = int(m[0] + 0.5), int(m[1] + 0.5)
            if not (0 <= cx < self.w and 0 <= cy < self.h) or (
                    bool(self.locked[cy, cx]) and float(self.u[cy, cx]) ==
                    float(torch.tensor(reference.OBSTACLE).to(self.u.dtype))):
                continue
            writes[(int(m[0]), int(m[1]))] = GOAL
        self._write(writes)

    def set_cells(self, cells, types) -> None:
        writes = {}
        for (x, y), t in zip(np.asarray(cells).reshape(-1, 2).tolist(),
                             np.asarray(types).reshape(-1).tolist()):
            if 0 <= x < self.w and 0 <= y < self.h and t in _VALUE:
                writes[(x, y)] = t      # a later write to the cell wins
        self._write(writes)

    def update(self, sweeps: int) -> None:
        u = self.u[None]
        inner = u[:, 1:-1, 1:-1]
        masks = reference._class_masks(self.locked[None])
        for t in range(self.iteration, self.iteration + sweeps):
            val = reference._lse4(u[:, :-2, 1:-1], u[:, 2:, 1:-1], u[:, 1:-1, :-2],
                                  u[:, 1:-1, 2:])
            inner.copy_(torch.where(masks[t % 2], val, inner))
        self.iteration += sweeps

    def edit(self, c: Cycle) -> None:
        """A cycle's writes: its cell edits, then its goal changes."""
        self.set_cells(c.cells, c.types)
        self.remove_goals(c.remove_goals)
        self.add_goals(c.add_goals)

    def cycle(self, c: Cycle) -> None:
        self.edit(c)
        self.update(c.sweeps)

    def frame(self) -> Frame:
        """A copy of the state (on a CPU device too, where ``.cpu()`` would
        share the replay's memory)."""
        return Frame(u=self.u.float().cpu().numpy().copy(),
                     locked=self.locked.cpu().numpy().copy(), iteration=self.iteration)


def replay(obstacle: np.ndarray, resolution: float, origin, cycles: list[Cycle],
           wanted, device, dtype=torch.float32) -> dict[int, Frame]:
    """Replay ``cycles`` from the window's start and return the state after
    each cycle index in ``wanted``."""
    wanted = set(wanted)
    r = Replay(obstacle, resolution, origin, device, dtype)
    out = {}
    for k, c in enumerate(cycles[:max(wanted, default=-1) + 1]):
        r.cycle(c)
        if k in wanted:
            out[k] = r.frame()
    return out
