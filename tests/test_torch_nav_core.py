"""The port's nav_core plugin (epic_tpu_torch.services.nav_core) on the CPU,
against epic_tpu's: the same costmap ingest, single-goal edits and world
transforms, solves with the iterations of epic_tpu's core.solve and fields
within tests/test_torch_solver.py's FIELD tolerance, and plans of the same
length whose poses agree within 1e-3. epic_tpu's plugin walks with its NumPy
walker here (no test calls epic_tpu.native)."""

import functools

import numpy as np
import pytest
import torch

import epic_tpu.services.nav_core as jnav_core
from epic_tpu import maps
from epic_tpu import path as jpath
from epic_tpu_torch.errors import EpicError
from epic_tpu_torch.services import EpicNavCorePlugin
from epic_tpu_torch.solver import core

FIELD = dict(rtol=2e-6, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jplugin_numpy_walk(monkeypatch):
    monkeypatch.setattr(jnav_core, "compute_path",
                        functools.partial(jpath.compute_path, impl="numpy"))
    return jnav_core.EpicNavCorePlugin


def _costmap(img):
    costmap = np.zeros(img.shape, dtype=np.uint8)
    costmap[img == 0] = 254
    return costmap


def _same_plans(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert len(a) == len(b)
    np.testing.assert_allclose([(p.x, p.y, p.yaw) for p in a], [(p.x, p.y, p.yaw) for p in b],
                               atol=1e-3)


def test_make_plan_end_to_end():
    """tests/test_planner.py's session: the plan starts at the start and ends
    at the goal pose; a replan with a new goal clears the old one."""
    img = maps.open_room(48, 48)
    plugin = EpicNavCorePlugin(interpolation="bilinear", device="cpu")
    plugin.initialize(_costmap(img), resolution=0.5, origin=(-2.0, -3.0))
    goal = (plugin.origin_x + 20 * 0.5, plugin.origin_y + 30 * 0.5)
    plan = plugin.make_plan(start_world=(0.0, 0.0), goal_world=goal)
    assert plan is not None and len(plan) > 3
    assert plan[0].x == 0.0 and plan[0].y == 0.0
    assert plan[-1].x == pytest.approx(goal[0])
    assert plugin.last_plan is plan
    plan2 = plugin.make_plan((0.0, 0.0), (plugin.origin_x + 10 * 0.5, plugin.origin_y + 8 * 0.5))
    assert plan2 is not None
    assert int((plugin.state.u == 0.0).sum()) == 1   # exactly one goal cell
    assert plugin.state.u.device == torch.device("cpu")


@pytest.mark.parametrize("interpolation", ["reference", "bilinear"])
def test_plans_match_epic_tpu(jplugin_numpy_walk, interpolation):
    """The maze, two replans: the same solves (iterations equal, fields
    within FIELD) and the same plans as epic_tpu's plugin."""
    img = maps.recursive_maze(64, 64, seed=7)
    ours = EpicNavCorePlugin(interpolation=interpolation, device="cpu")
    theirs = jplugin_numpy_walk(interpolation=interpolation)
    free = np.argwhere(img == 128)
    goals = [tuple(map(float, free[i][::-1])) for i in (5, len(free) // 2)]
    starts = [tuple(map(float, free[i][::-1])) for i in (len(free) - 3, 17)]
    for pl in (ours, theirs):
        pl.initialize(_costmap(img), resolution=1.0, origin=(0.0, 0.0))
    for start, goal in zip(starts, goals):
        a, b = ours.make_plan(start, goal), theirs.make_plan(start, goal)
        assert int(ours.state.iteration) == int(theirs.state.iteration)
        np.testing.assert_allclose(ours.state.u.numpy(), np.asarray(theirs.state.u), **FIELD)
        _same_plans(a, b)
    assert a is not None


def test_solve_fn_and_initialize_match_epic_tpu(jplugin_numpy_walk):
    """solve_fn swaps the solve (the plain core.solve here: the same bits as
    the default on the CPU); initialize's thresholds and ring, set_goal's
    single-goal rule (even on an obstacle) equal epic_tpu's."""
    img = maps.random_obstacles(40, 36, density=0.15, seed=3)
    costmap = (np.random.default_rng(0).random(img.shape) * 256).astype(np.uint8)
    ours = EpicNavCorePlugin(device="cpu")
    plain = EpicNavCorePlugin(device="cpu", solve_fn=core.solve)
    theirs = jplugin_numpy_walk()
    for pl in (ours, plain, theirs):
        pl.initialize(costmap, resolution=0.25, origin=(1.0, -1.0))
    np.testing.assert_array_equal(ours.state.u.numpy(), np.asarray(theirs.state.u))
    np.testing.assert_array_equal(ours.state.locked.numpy(), np.asarray(theirs.state.locked))
    oy, ox = np.argwhere(costmap[1:-1, 1:-1] >= 250)[0] + 1
    for pl in (ours, plain, theirs):
        pl.set_goal(3, 4)
        pl.set_goal(int(ox), int(oy))   # the reference's unconditional assignment
    np.testing.assert_array_equal(ours.state.u.numpy(), np.asarray(theirs.state.u))
    assert ours.world_to_map(1.5, 0.0) == theirs.world_to_map(1.5, 0.0)
    assert ours.map_to_world(3.0, 4.0) == theirs.map_to_world(3.0, 4.0)
    a = ours.make_plan((2.0, 0.5), (6.0, 5.0))
    b = plain.make_plan((2.0, 0.5), (6.0, 5.0))
    assert torch.equal(ours.state.u, plain.state.u)
    _same_plans(a, b)


def test_make_plan_failure_and_uninitialized():
    plugin = EpicNavCorePlugin(device="cpu")
    with pytest.raises(EpicError):
        plugin.make_plan((0.0, 0.0), (1.0, 1.0))
    img = maps.open_room(24, 24)
    plugin.initialize(_costmap(img))
    # A start inside the boundary obstacle gives no plan (the reference
    # returns false).
    assert plugin.make_plan((0.0, 0.0), (12.0, 12.0)) is None
