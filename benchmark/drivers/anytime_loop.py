"""The upstream navigation node's own loop: one node, open loop, at the
configuration's update rate (``update_rate_hz``, ``steps_per_update``).

Cycle ``k`` of the window is due ``k / update_rate_hz`` after the window's
start; it never starts before then, and a late cycle starts at once (its
lateness counts in its latency, which runs from the due time to the poses
returned). Every ``goal_every_cycles`` cycles from the first an rviz user
sets a new start and goal. Each cycle, in this order:

1. The edit: one ``set_cells`` call sets a seeded patch of
   ``patch_cells`` cells (the count uniform) around a seeded centre to
   OBSTACLE, and the patch placed ``patch_life_cycles`` cycles earlier back
   to FREE: the people and objects a costmap marks and clears. A patch
   takes only cells free on the map and in no live patch, none within
   ``clearance_m`` of the goal or of the robot's cell.
2. Goals, on an episode's first cycle: the goal replaced (``remove_goals``,
   then ``add_goals``, as the rviz node's ``set_goal`` does), and the robot
   placed at the episode's start. A live patch within ``clearance_m`` of
   the new start or goal is cleared in that cycle's edit.
3. The tick: ``update()``, ``steps_per_update`` sweeps. The field is never
   reset: the anytime warm start, across goal changes too.
4. The path: ``compute_path`` from the robot's pose (world poses), with
   upstream's point budget, ``w * h / step_size``.

The robot moves ``robot_speed_m_s / update_rate_hz`` along its newest path
each cycle; it stays put when there is no path.

Every draw comes from the run's seed: each episode's goal and start from
:class:`benchmark.inputs.Stream` (episode ``e`` is the stream's request
``e``), the patches from their own generator. A cycle's inputs are drawn
after the cycle before it has returned, before the wait for its due time,
so that only the node's verbs lie between the due time and the poses.

A cycle fails if a verb raises or refuses its goal. A walk that finds no
path, or stops short of the goal, on the field as it stands is not a
failure: the node's field is not converged, and the check holds the walk to
the reference's on the replayed field (``reached`` in a cycle's record says
whether its path ended in the goal cell).

Set-up runs ``warmup_cycles`` cycles, unpaced, drawn from the mix's
``warmup_seed``, then clears their patches and goal and resets the free
cells, so the window starts from the map's initial field at iteration 0,
where the reference's replay starts.

Traffic keys: ``warmup_seed``, ``warmup_cycles``, ``goal_every_cycles``,
``patch_cells`` ([least, most]), ``patch_radius`` (cells around the centre
a patch may take), ``patch_life_cycles``, ``robot_speed_m_s``,
``step_size``, ``cd_precision``, ``interpolation``, ``check_sample``.
"""

from __future__ import annotations

import time

import numpy as np

from .. import inputs
from ..checks.anytime import Answer
from ..reference_anytime import FREE, OBSTACLE, Cycle
from .planner_goal import cell

SPIN_S = 1e-3   # sleep to within this of a due time, then spin


def offsets(radius: int) -> np.ndarray:
    """The ``(dx, dy)`` offsets within ``radius`` cells of a centre."""
    r = np.arange(-radius, radius + 1)
    dx, dy = np.meshgrid(r, r)
    keep = dx * dx + dy * dy <= radius * radius
    return np.stack([dx[keep], dy[keep]], axis=1)


class Session:
    """The benchmark's side of one node session, drawn from ``seed``: the
    robot, the goal, the live patches, the next cycle's inputs, and the
    inputs sent so far (``cycles``)."""

    def __init__(self, ctx, planner, seed: int):
        mix, m = ctx.traffic, ctx.map
        self.ctx, self.planner, self.m, self.mix = ctx, planner, m, mix
        self.clear_cells = ctx.config["clearance_m"] / m.resolution
        self.offsets = offsets(mix["patch_radius"])
        self.free = ~m.obstacle
        self.free[0, :] = self.free[-1, :] = self.free[:, 0] = self.free[:, -1] = False
        self._episodes = inputs.Stream(m, seed)
        self._draws = inputs.rng(seed, 3)
        self.robot = (0.0, 0.0)
        self.goal: tuple[int, int] | None = None
        self.patches: list[np.ndarray] = []      # live, oldest first
        self.taken = np.zeros(m.shape, bool)     # their cells
        self.cycles: list[Cycle] = []
        self.step_m = mix["robot_speed_m_s"] / ctx.config["update_rate_hz"]
        self._next = self._prepare(0)

    def _goal_world(self, goal) -> tuple[float, float]:
        # A quarter cell in from the corner: upstream truncates the map
        # coordinates to the goal's cell and rounds them for its obstacle test.
        return self.m.to_world(goal[0] + 0.25, goal[1] + 0.25)

    def _near(self, cells: np.ndarray, x: float, y: float) -> np.ndarray:
        return np.hypot(cells[:, 0] - x, cells[:, 1] - y) <= self.clear_cells

    def _robot_cell(self) -> tuple[int, int]:
        rx, ry = self.m.to_map(*self.robot)
        return cell(rx), cell(ry)

    def _patch(self) -> np.ndarray:
        """The next patch's cells ``[n, 2]``; the draws of every cycle are
        the same in number, whatever the patch takes."""
        lo, hi = self.mix["patch_cells"]
        g = self._draws
        centre = self.m.cells[g.integers(len(self.m.cells))]
        n = int(g.integers(lo, hi + 1))
        jitter = g.random(len(self.offsets))
        order = np.argsort((self.offsets ** 2).sum(axis=1) + jitter, kind="stable")
        cells = centre + self.offsets[order]
        h, w = self.m.shape
        inside = (cells[:, 0] >= 0) & (cells[:, 0] < w) & (cells[:, 1] >= 0) & (cells[:, 1] < h)
        cells = cells[inside]
        ok = self.free[cells[:, 1], cells[:, 0]] & ~self.taken[cells[:, 1], cells[:, 0]]
        ok &= ~self._near(cells, *self._robot_cell()) & ~self._near(cells, *self.goal)
        return cells[ok][:n]

    def _prepare(self, k: int) -> tuple[Cycle, tuple[float, float]]:
        """Cycle ``k``'s inputs and the robot's start in map cells, drawn
        before the cycle is due."""
        m, mix = self.m, self.mix
        remove, add = [], []
        episode, at = divmod(k, mix["goal_every_cycles"])
        expired = (self.patches[:1] if len(self.patches) == mix["patch_life_cycles"] else [])
        if at == 0:
            if self.goal is not None:
                remove = [self._goal_world(self.goal)]
            (g,), (s,) = self._episodes.take(episode)
            self.goal = (int(g[0]), int(g[1]))
            add = [self._goal_world(self.goal)]
            self.robot = m.to_world(float(s[0]), float(s[1]))
            start = self._robot_cell()
            expired = expired + [p for p in self.patches[len(expired):] if (
                self._near(p, *self.goal) | self._near(p, *start)).any()]
        self.patches = [p for p in self.patches if not any(p is e for e in expired)]
        expired = np.concatenate(expired) if expired else np.empty((0, 2), int)
        self.taken[expired[:, 1], expired[:, 0]] = False
        patch = self._patch()      # off the expired cells too: no cell is written twice
        self.patches.append(patch)
        self.taken[patch[:, 1], patch[:, 0]] = True
        cells = np.concatenate([expired, patch]).astype(np.int64)
        types = np.array([FREE] * len(expired) + [OBSTACLE] * len(patch), dtype=np.int64)
        c = Cycle(remove_goals=remove, add_goals=add, cells=cells, types=types,
                  sweeps=self.ctx.config["steps_per_update"])
        return c, tuple(map(float, m.to_map(*self.robot)))

    def _move(self, poses) -> None:
        """Move the robot ``step_m`` along ``poses`` from their start."""
        k = min(len(poses), 64)
        x, y = poses.x[:k], poses.y[:k]
        run = np.concatenate([[0.0], np.cumsum(np.hypot(np.diff(x), np.diff(y)))])
        i = int(np.searchsorted(run, self.step_m))
        if i >= k:
            self.robot = (float(x[-1]), float(y[-1]))
            return
        f = (self.step_m - run[i - 1]) / (run[i] - run[i - 1])
        self.robot = (float(x[i - 1] + f * (x[i] - x[i - 1])),
                      float(y[i - 1] + f * (y[i] - y[i - 1])))

    def cycle(self, k: int, due: float) -> None:
        """Run cycle ``k``, record it (its latency runs from ``due``) and
        draw cycle ``k + 1``'s inputs."""
        from epic_tpu_torch.errors import EpicError

        ctx, planner, m = self.ctx, self.planner, self.m
        c, start = self._next
        t0 = time.perf_counter()
        ok = True
        poses = None
        with ctx.spans("cycle"):
            try:
                with ctx.spans("edit"):
                    planner.set_cells(c.cells, c.types)
                with ctx.spans("goals"):
                    if c.remove_goals:
                        planner.remove_goals(c.remove_goals)
                    if c.add_goals:
                        ok = planner.add_goals(c.add_goals)
                with ctx.spans("tick"):
                    planner.update(c.sweeps)
            except EpicError:
                ok = False
            with ctx.spans("walker"):
                try:
                    poses = planner.compute_path(self.robot, step_size=self.mix["step_size"],
                                                 cd_precision=self.mix["cd_precision"])
                except EpicError:
                    poses = None
        t1 = time.perf_counter()
        self.cycles.append(c)
        points = np.stack(m.to_map(poses.x, poses.y), axis=1) if poses else None
        n = 0 if points is None else len(points)
        reached = n > 0 and (cell(points[-1, 0]), cell(points[-1, 1])) == self.goal
        ctx.record(start=due, end=t1, late=t0 - due, ok=ok, reached=reached, inputs=c, points=n)
        state = planner.state
        self.last = (k, start, points)
        ctx.answer(n, lambda: Answer(
            cycle=k, start=start, field=state.u.clone(), sweeps=int(state.iteration),
            points=points, cycles=self.cycles))
        if poses:
            self._move(poses)
        self._next = self._prepare(k + 1)

    def clear(self) -> None:
        """Take the session's patches and goal off the map and reset the
        free cells: the map's initial field, at iteration 0. The drawn but
        unsent next cycle has already taken its expired patch and, at an
        episode's start, the old goal off the session's books: they are
        cleared from its inputs."""
        from epic_tpu_torch import constants as C

        c = self._next[0]
        live = np.concatenate(self.patches + [c.cells[c.types == FREE]])
        self.planner.set_cells(live, [C.CELL_TYPE_FREE] * len(live))
        self.planner.remove_goals(c.remove_goals + [self._goal_world(self.goal)])
        self.planner.reset_free_cells()


def make_planner(ctx):
    """The node's Planner at the configuration's settings, holding the map
    as its OccupancyGrid subscriber receives it."""
    from epic_tpu_torch.planner import Planner, PlannerConfig

    cfg, m = ctx.config, ctx.map
    planner = Planner(PlannerConfig(
        epsilon=cfg["epsilon"], stagger=cfg["stagger"],
        steps_per_update=cfg["steps_per_update"], resolution=m.resolution,
        origin_x=m.origin[0], origin_y=m.origin[1],
        interpolation=ctx.traffic["interpolation"]), device=ctx.device)
    planner.update_occupancy(np.where(m.obstacle, 100, 0).astype(np.int16), m.resolution,
                             m.origin)
    return planner


def run(ctx) -> None:
    cfg, mix = ctx.config, ctx.traffic
    planner = make_planner(ctx)
    ctx.mark("program")

    # Set-up: this traffic's shapes, every verb, unpaced; then the map's
    # initial field again.
    warm = Session(ctx, planner, mix["warmup_seed"])
    for k in range(mix["warmup_cycles"]):
        warm.cycle(k, time.perf_counter())
    warm.clear()
    ctx.clear()
    ctx.mark("warm")

    period = 1.0 / cfg["update_rate_hz"]
    session = Session(ctx, planner, ctx.seed)

    def step(k: int) -> None:
        start, end = ctx.run.window_start, ctx.run.window_start + ctx.seconds
        due = start + k * period
        with ctx.spans("wait"):
            wait_until(min(due, end))
        if due < end:
            session.cycle(k, due)

    ctx.window(step)
    if session.cycles:
        k, start, points = session.last
        ctx.keep(Answer(cycle=k, start=start, field=planner.state.u,
                        sweeps=int(planner.state.iteration), points=points,
                        cycles=session.cycles))


def wait_until(t: float) -> None:
    """Sleep to within :data:`SPIN_S` of ``t``, then spin to it."""
    left = t - time.perf_counter()
    if left > SPIN_S:
        time.sleep(left - SPIN_S)
    while time.perf_counter() < t:
        pass
