"""The port's sampling-based node (epic_tpu_torch.services.sampling_node, a
NumPy copy of epic_tpu's) and the server's sampling_* verbs: the cases of
tests/test_sampling_node.py and tests/test_server.py's sampling session on
the port, and the same seeded searches as epic_tpu's node, point for point."""

from __future__ import annotations

import threading
import time

import numpy as np
import pytest
import torch

from epic_tpu.services import messages as jmsg
from epic_tpu.services import sampling_node as jsampling_node
from epic_tpu_torch import constants as C
from epic_tpu_torch.planner import PlannerConfig
from epic_tpu_torch.services import messages as msg
from epic_tpu_torch.services import sampling_node
from epic_tpu_torch.services.navigation_node import EpicNavigationNodeRviz
from epic_tpu_torch.services.sampling_node import (
    ALGORITHM_LAZY_PRM,
    ALGORITHM_RRT_CONNECT,
    ALGORITHM_RRT_STAR,
    EpicNavigationNodeSampling,
    SamplingPlanner,
)
from epic_tpu_torch.services.server import EpicClient, EpicServiceServer

ALL = [ALGORITHM_RRT_CONNECT, ALGORITHM_RRT_STAR, sampling_node.ALGORITHM_LAZY_RRT,
       ALGORITHM_LAZY_PRM, sampling_node.ALGORITHM_PRM_STAR,
       sampling_node.ALGORITHM_LAZY_PRM_STAR]


def _grid_with_wall(m=msg, n=32):
    data = np.zeros((n, n), dtype=np.int8)
    data[:, n // 2] = 100
    data[n // 2 - 2: n // 2 + 2, n // 2] = 0   # gap
    return m.OccupancyGrid(width=n, height=n, resolution=1.0, origin_x=0.0, origin_y=0.0,
                           data=data.reshape(-1).tolist())


def _pose(x, y, m=msg):
    return m.PoseStamped(x=x, y=y, yaw=0.0, frame_id="map", stamp=0.0)


def _walled_obstacle(h=24, w=24):
    obstacle = np.zeros((h, w), dtype=bool)
    obstacle[0, :] = obstacle[-1, :] = obstacle[:, 0] = obstacle[:, -1] = True
    obstacle[h // 2, :] = True
    obstacle[h // 2, w - 6: w - 2] = False   # the door
    return obstacle


def _segments_collision_free(pts, obstacle):
    for a, b in zip(pts[:-1], pts[1:]):
        n = max(2, int(np.ceil(np.linalg.norm(b - a) / 0.25)) + 1)
        for t in np.linspace(0, 1, n):
            p = a + t * (b - a)
            if obstacle[int(p[1]), int(p[0])]:
                return False
    return True


@pytest.mark.parametrize("alg", ALL)
def test_every_algorithm_matches_epic_tpu(alg):
    """The same seed gives the same search in both packages: the same
    solution path, bit for bit, and the same iteration count."""
    obstacle = _walled_obstacle()
    ours, theirs = SamplingPlanner(alg, seed=9), jsampling_node.SamplingPlanner(alg, seed=9)
    for p in (ours, theirs):
        p.setup(obstacle, start=(3.0, 3.0), goal=(20.0, 20.0))
        assert p.solve(iterations=1500)
    a, b = ours.solution_path(), theirs.solution_path()
    np.testing.assert_array_equal(a, b)
    assert ours.iterations == theirs.iterations
    np.testing.assert_allclose(a[0], (3.0, 3.0))
    np.testing.assert_allclose(a[-1], (20.0, 20.0))
    for p, q in zip(a, a[1:]):
        assert ours._motion_valid(p, q), (p, q)


@pytest.mark.parametrize("algorithm", [ALGORITHM_RRT_CONNECT, ALGORITHM_RRT_STAR])
def test_planner_finds_collision_free_path(algorithm):
    n = 32
    obstacle = np.zeros((n, n), dtype=bool)
    obstacle[:, 16] = True
    obstacle[14:18, 16] = False
    obstacle[0, :] = obstacle[-1, :] = obstacle[:, 0] = obstacle[:, -1] = True
    p = SamplingPlanner(algorithm, seed=3)
    p.setup(obstacle, start=(4.0, 4.0), goal=(27.0, 27.0))
    assert p.solve(iterations=4000)
    pts = p.solution_path()
    assert pts is not None and len(pts) >= 2
    np.testing.assert_allclose(pts[0], [4.0, 4.0])
    np.testing.assert_allclose(pts[-1], [27.0, 27.0])
    assert _segments_collision_free(pts, obstacle)


@pytest.mark.parametrize("alg,early,late", [(ALGORITHM_RRT_STAR, 600, 4000),
                                            (sampling_node.ALGORITHM_PRM_STAR, 500, 3000)])
def test_optimizing_planners_keep_optimizing(alg, early, late):
    n = 24
    obstacle = np.zeros((n, n), dtype=bool)
    obstacle[0, :] = obstacle[-1, :] = obstacle[:, 0] = obstacle[:, -1] = True
    p = SamplingPlanner(alg, seed=11 if alg == ALGORITHM_RRT_STAR else 3)
    p.setup(obstacle, start=(2.0, 2.0), goal=(21.0, 21.0))
    assert p.solve(iterations=early)
    len_early = p._path_len(p.solution_path())
    p.solve(iterations=late)
    len_late = p._path_len(p.solution_path())
    assert len_late <= len_early + 1e-9
    assert len_late <= float(np.hypot(19.0, 19.0)) * 1.15


def test_unknown_algorithm_raises():
    with pytest.raises(ValueError):
        SamplingPlanner(17)


def test_node_state_machine_and_path_population():
    node = EpicNavigationNodeSampling(seed=5)
    assert node.srv_compute_path(msg.ComputePathRequest(start=_pose(3.0, 3.0))).path.poses == []
    node.sub_occupancy_grid(_grid_with_wall())
    assert not node.srv_add_goals(msg.ModifyGoalsRequest(goals=[_pose(1, 1), _pose(2, 2)])).success
    assert not node.srv_add_goals(msg.ModifyGoalsRequest(goals=[_pose(16.2, 2.0)])).success
    assert node.srv_add_goals(msg.ModifyGoalsRequest(goals=[_pose(28.0, 28.0)])).success
    res = node.srv_compute_path(msg.ComputePathRequest(start=_pose(3.0, 3.0)))
    assert node.planner is not None and res.path.poses == []
    node.update(iterations=4000)
    poses = node.srv_compute_path(msg.ComputePathRequest(start=_pose(3.0, 3.0))).path.poses
    assert len(poses) >= 2 and poses[0] == _pose(3.0, 3.0)
    assert np.hypot(poses[-1].x - 28.0, poses[-1].y - 28.0) < 1e-6
    p1, p2 = poses[-2], poses[-1]
    assert poses[-1].yaw == pytest.approx(np.arctan2(p2.y - p1.y, p2.x - p1.x))


def test_node_session_matches_epic_tpu():
    """The node's whole session in both packages: the same poses."""
    out = []
    for node_cls, m in ((EpicNavigationNodeSampling, msg),
                        (jsampling_node.EpicNavigationNodeSampling, jmsg)):
        node = node_cls(seed=5)
        node.sub_occupancy_grid(_grid_with_wall(m))
        assert node.srv_add_goals(m.ModifyGoalsRequest(goals=[_pose(28.0, 28.0, m)])).success
        node.srv_compute_path(m.ComputePathRequest(start=_pose(3.0, 3.0, m)))
        node.update(iterations=2500)
        poses = node.srv_compute_path(m.ComputePathRequest(start=_pose(3.0, 3.0, m))).path.poses
        out.append([(p.x, p.y, p.yaw) for p in poses])
    assert out[0] == out[1] and len(out[0]) >= 2


def test_node_goal_remove_and_map_reset():
    node = EpicNavigationNodeSampling(seed=5)
    node.sub_occupancy_grid(_grid_with_wall())
    assert node.srv_add_goals(msg.ModifyGoalsRequest(goals=[_pose(28.0, 28.0)])).success
    node.srv_compute_path(msg.ComputePathRequest(start=_pose(3.0, 3.0)))
    node.update(iterations=3000)
    assert node.planner is not None and node.planner.solved
    node.srv_remove_goals(msg.ModifyGoalsRequest(goals=[_pose(5.0, 5.0)]))
    assert node.goal is not None
    node.srv_remove_goals(msg.ModifyGoalsRequest(goals=[_pose(28.0, 28.0)]))
    assert node.goal is None and node.planner is None
    assert node.srv_set_cells(msg.SetCellsRequest(v=[26, 26], types=[C.CELL_TYPE_GOAL])).success
    assert node.goal == (26.0, 26.0)
    node.srv_compute_path(msg.ComputePathRequest(start=_pose(3.0, 3.0)))
    node.update(iterations=2000)
    assert node.planner is not None
    node.sub_occupancy_grid(_grid_with_wall())
    assert node.planner is None and node.goal == (26.0, 26.0)
    assert node.set_goal(_pose(20.0, 8.0))
    node.srv_compute_path(msg.ComputePathRequest(start=_pose(3.0, 3.0)))
    node.update(iterations=4000)
    assert len(node.set_start(_pose(3.0, 3.0)).path.poses) >= 2


def test_obstacle_edits_respected():
    node = EpicNavigationNodeSampling(seed=9)
    n = 32
    node.sub_occupancy_grid(msg.OccupancyGrid(
        width=n, height=n, resolution=1.0, origin_x=0.0, origin_y=0.0,
        data=np.zeros(n * n, dtype=np.int8).tolist()))
    xs, types = [], []
    for y in range(5, n - 1):
        xs += [16, y]
        types.append(C.CELL_TYPE_OBSTACLE)
    node.srv_set_cells(msg.SetCellsRequest(v=xs, types=types))
    assert node.srv_add_goals(msg.ModifyGoalsRequest(goals=[_pose(28.0, 28.0)])).success
    node.srv_compute_path(msg.ComputePathRequest(start=_pose(3.0, 28.0)))
    node.update(iterations=8000)
    res = node.srv_compute_path(msg.ComputePathRequest(start=_pose(3.0, 28.0)))
    pts = np.array([[p.x, p.y] for p in res.path.poses])
    assert len(pts) >= 2
    crossing_y = None
    for a, b in zip(pts[:-1], pts[1:]):
        if (a[0] - 16.0) * (b[0] - 16.0) <= 0 and a[0] != b[0]:
            crossing_y = a[1] + (16.0 - a[0]) / (b[0] - a[0]) * (b[1] - a[1])
            break
    assert crossing_y is not None and crossing_y <= 5.5


@pytest.fixture()
def server_client():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    node = EpicNavigationNodeRviz(PlannerConfig(epsilon=1e-2, steps_per_update=25), device="cpu")
    server = EpicServiceServer(node, port=0)
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            server.spin_once()

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    client = EpicClient(port=server.port)
    yield server, client
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive()
    client.close()
    server.close()
    torch.set_num_threads(n)


def test_sampling_verb_family(server_client):
    """tests/test_server.py's sampling session on the port's server: ingest
    -> goal -> start -> the anytime budget a tick -> a populated path; the
    info block; a goal edit resets the planner."""
    server, client = server_client
    assert server.sampling_budget_s == 0.02
    n = 32
    data = np.zeros((n, n), dtype=np.int8)
    data[:, 16] = 100
    data[14:18, 16] = 0
    r = client.call("sampling_compute_path", start=[3.0, 3.0])
    assert not r["success"] and "sampling" in r["error"]
    assert "sampling" not in client.call("info")
    assert client.call("sampling_occupancy", width=n, height=n, seed=3,
                       data=data.reshape(-1).tolist())["success"]
    assert client.call("sampling_add_goals", goals=[[27.0, 27.0]])["success"]
    assert not client.call("sampling_add_goals", goals=[[16.0, 2.0]])["success"]
    assert client.call("sampling_compute_path", start=[3.0, 3.0])["success"]
    deadline = time.time() + 30
    while time.time() < deadline:
        r = client.call("sampling_compute_path", start=[3.0, 3.0])
        if r["solved"] and len(r["path"]) >= 2:
            break
        time.sleep(0.1)
    assert r["solved"] and len(r["path"]) >= 2
    assert np.hypot(r["path"][-1][0] - 27.0, r["path"][-1][1] - 27.0) < 1e-6
    info = client.call("info")
    assert info["sampling"]["solved"] and info["sampling"]["iterations"] > 0
    assert info["sampling"]["algorithm"] == 0 and info["sampling"]["goal"] == [27.0, 27.0]
    assert client.call("sampling_set_cells", v=[26, 8], types=[0])["success"]
    r = client.call("sampling_compute_path", start=[3.0, 3.0])
    assert r["success"] and not r["solved"]
    assert client.call("sampling_remove_goals", goals=[[26.0, 8.0]])["success"]
    assert client.call("info")["sampling"]["goal"] is None
