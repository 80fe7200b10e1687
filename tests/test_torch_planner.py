"""epic_tpu_torch.Planner against epic_tpu.Planner: one session, step by
step, on a small map. The JAX planner runs with backend="pallas", which on
the CPU runs the two Pallas kernels the port replaces (K1 for ticks, K2 for
the solve) in interpret mode; the port runs its plain version on the CPU.

Tolerances: fields rtol=2e-6, atol=1e-3 (tests/test_pallas.py's rule; the
packages' CPU exp differ by an ulp), solve iterations by the stagger rule.
Walks on the same field bits are bit-exact through the port's walker.
"""

import pathlib

import numpy as np
import pytest
import torch

from epic_tpu import constants as JC
from epic_tpu import maps
from epic_tpu.planner import Planner as JPlanner
from epic_tpu.planner import PlannerConfig as JPlannerConfig
from epic_tpu_torch import path
from epic_tpu_torch.config import EpicConfig, SolverConfig
from epic_tpu_torch.errors import EpicError, InvalidLocationError
from epic_tpu_torch.planner import Planner, PlannerConfig
from epic_tpu_torch.services import messages as msg
from epic_tpu_torch.services.navigation_node import EpicNavigationNode, EpicNavigationNodeRviz

ROOT = pathlib.Path(__file__).resolve().parents[1]
GOLDENS = ROOT / "tests" / "goldens"
FIELD = dict(rtol=2e-6, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and torch's default of one OpenMP thread per core oversubscribes them
    (spin-waiting threads slowed this file about 30-fold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _occupancy(img):
    occ = np.zeros(img.shape, dtype=np.int8)
    occ[img == 0] = 100
    return occ


def _pair(**kw):
    jp = JPlanner(JPlannerConfig(backend="pallas", **kw))
    tp = Planner(PlannerConfig(**kw), device="cpu")
    return jp, tp


def _assert_fields(jp, tp):
    np.testing.assert_allclose(tp.state.u.numpy(), np.asarray(jp.state.u), **FIELD)
    np.testing.assert_array_equal(tp.state.locked.numpy(), np.asarray(jp.state.locked))
    assert int(tp.state.iteration) == int(jp.state.iteration)


def test_session_matches_jax_planner_on_its_pallas_kernels():
    img = maps.random_obstacles(32, 48, density=0.15, seed=5)
    jp, tp = _pair(epsilon=1e-2, steps_per_update=25, interpolation="bilinear")
    for p in (jp, tp):
        p.update_occupancy(_occupancy(img), resolution=1.0, origin=(0.0, 0.0))
        assert p.add_goals([(24.0, 16.0)])
        assert not p.add_goals([(0.0, 0.0)])      # the boundary ring is an obstacle
    _assert_fields(jp, tp)
    for _ in range(4):
        jp.update()
        tp.update()
    _assert_fields(jp, tp)
    for p in (jp, tp):                            # an obstacle edit mid-session
        p.set_cells([(10, 10), (11, 10)], [JC.CELL_TYPE_OBSTACLE] * 2)
        p.update(13)
    _assert_fields(jp, tp)
    assert tp.get_cell(10, 10) == jp.get_cell(10, 10) == -1e6
    jp.solve()
    tp.solve()
    assert bool(tp.state.converged) and bool(jp.state.converged)
    if int(tp.state.iteration) == int(jp.state.iteration):
        _assert_fields(jp, tp)
    else:
        assert (int(tp.state.iteration) - int(jp.state.iteration)) % 100 == 0
    assert tp.get_cell(24, 16) == 0.0
    for start in [(5.0, 5.0), (40.0, 25.0)]:
        ours = tp.compute_path(start, step_size=0.2, cd_precision=0.4)
        theirs = jp.compute_path(start, step_size=0.2, cd_precision=0.4)
        assert abs(ours[-1].x - theirs[-1].x) < 1.0 and abs(ours[-1].y - theirs[-1].y) < 1.0
        assert abs(ours[-1].x - 24) < 2 and abs(ours[-1].y - 16) < 2


def test_walks_on_jax_field_bits_are_bit_exact():
    """The same field bits through both walkers give the same points."""
    img = maps.recursive_maze(40, 40, seed=2)
    jp = JPlanner(JPlannerConfig(backend="xla", epsilon=1e-2))
    jp.update_occupancy(_occupancy(img))
    gy, gx = np.argwhere(img == 255)[0]
    jp.add_goals([(float(gx), float(gy))])
    jp.solve()
    u, locked = np.asarray(jp.state.u), np.asarray(jp.state.locked)
    from epic_tpu import path as jpath

    ys, xs = np.nonzero(~locked)
    compared = 0
    for i in range(0, len(ys), max(1, len(ys) // 12)):
        for mode in ("reference", "bilinear"):
            args = (float(xs[i]) + 0.3, float(ys[i]) + 0.2, 0.2, 0.4, 100_000)
            try:
                theirs = jpath.compute_path(u, locked, *args, mode=mode, impl="numpy")
            except Exception as e:  # the port raises its own class of the same name
                with pytest.raises(EpicError) as ours_err:
                    path.compute_path(u, locked, *args, mode=mode)
                assert type(ours_err.value).__name__ == type(e).__name__
                continue
            ours = path.compute_path(u, locked, *args, mode=mode)
            assert ours.shape == theirs.shape
            assert np.max(np.abs(ours - theirs)) == 0.0
            compared += 1
    assert compared >= 8


@pytest.mark.parametrize("name", ["paths2d_seed7", "maze", "umass"])
def test_walks_on_reference_goldens_are_bit_exact(name):
    """The port's walker reproduces the reference binary's recorded
    streamlines on its own field bits (tests/test_goldens.py's rule)."""
    g = np.load(GOLDENS / f"{name}.npz")
    locked = g["locked"].astype(bool) if "locked" in g.files else (g["img"] == 0) | (g["img"] == 255)
    off, compared = 0, 0
    for (x, y), n in zip(g["starts"], g["path_lens"]):
        ref = g["paths_concat"][off:off + int(n)]
        off += int(n)
        if n == 0:
            with pytest.raises(EpicError):
                path.compute_path(g["ref_u"], locked, float(x), float(y), 0.2, 0.4, int(1e6))
            continue
        ours = path.compute_path(g["ref_u"], locked, float(x), float(y), 0.2, 0.4, int(1e6))
        assert ours.shape == ref.shape and np.max(np.abs(ours - ref)) == 0.0
        compared += 1
    assert compared >= 2


@pytest.mark.parametrize("mode", ["reference", "bilinear"])
def test_compute_paths_batch_matches_jax_planner(mode):
    """Batched paths through both planners on one field: the same lanes are
    None (off-map and obstacle starts), the rest reach the goal, with the
    same number of points, and end within 0.05 of each other (the walkers
    agree bit for bit op by op; XLA's fusion moves the last bits:
    tests/test_torch_batched_path.py)."""
    img = maps.random_obstacles(32, 48, density=0.15, seed=5)
    jp, tp = _pair(epsilon=1e-2, interpolation=mode)
    for p in (jp, tp):
        p.update_occupancy(_occupancy(img))
        p.add_goals([(24.0, 16.0)])
        p.solve()
    oy, ox = np.argwhere(img == 0)[3]
    starts = [(5.0, 5.0), (-2.0, 3.0), (40.0, 25.0), (float(ox), float(oy)), (30.0, 5.0)]
    ours = tp.compute_paths_batch(starts, step_size=0.2, cd_precision=0.4, max_steps=800)
    theirs = jp.compute_paths_batch(starts, step_size=0.2, cd_precision=0.4, max_steps=800)
    assert [p is None for p in ours] == [p is None for p in theirs]
    assert ours[1] is None and ours[3] is None
    for a, b in zip(ours, theirs):
        if a is not None:
            assert len(a) == len(b) and (a[0].x, a[0].y) == (b[0].x, b[0].y)
            assert abs(a[-1].x - b[-1].x) < 0.05 and abs(a[-1].y - b[-1].y) < 0.05
            assert abs(a[-1].x - 24) < 2 and abs(a[-1].y - 16) < 2


@pytest.fixture()
def node():
    n = EpicNavigationNode(PlannerConfig(epsilon=1e-2, steps_per_update=50), device="cpu")
    img = maps.open_room(40, 40)
    n.sub_occupancy_grid(msg.OccupancyGrid(40, 40, 1.0, 0.0, 0.0, _occupancy(img)))
    return n


def test_node_verbs(node):
    """The reference's verbs through the node, as tests/test_planner.py
    drives epic_tpu's."""
    assert node.srv_add_goals(msg.ModifyGoalsRequest([msg.PoseStamped(20.0, 20.0)])).success
    assert node.srv_get_cell(msg.GetCellRequest(20, 20)).value == 0.0
    assert not node.srv_get_cell(msg.GetCellRequest(40, 3)).success
    node.srv_set_status(msg.SetStatusRequest(paused=True))
    node.update()
    assert int(node.planner.state.iteration) == 0
    node.srv_set_status(msg.SetStatusRequest(paused=False))
    for _ in range(20):
        node.update()
    assert int(node.planner.state.iteration) == 1000
    r = node.srv_compute_path(msg.ComputePathRequest(msg.PoseStamped(5.0, 5.0), 0.2, 0.4))
    assert r.path.poses[0].x == 5.0 and len(r.path.poses) > 2
    assert abs(r.path.poses[-1].x - 20) < 2 and abs(r.path.poses[-1].y - 20) < 2
    assert node.srv_set_cells(msg.SetCellsRequest([7, 9, 8, 9], [1, 0])).success
    assert node.planner.get_cell(7, 9) == -1e6 and node.planner.get_cell(8, 9) == 0.0
    node.srv_remove_goals(msg.ModifyGoalsRequest([msg.PoseStamped(20.0, 20.0)]))
    assert not bool(node.planner.state.locked[20, 20])
    assert node.srv_reset_free_cells(msg.ResetFreeCellsRequest()).success
    assert node.planner.get_cell(19, 20) == -1e6 and int(node.planner.state.iteration) == 0


def test_rviz_goal_replacement():
    n = EpicNavigationNodeRviz(PlannerConfig(epsilon=1e-2), device="cpu")
    n.sub_occupancy_grid(msg.OccupancyGrid(30, 30, 1.0, 0.0, 0.0, _occupancy(maps.open_room(30, 30))))
    assert n.set_goal(msg.PoseStamped(10.0, 10.0))
    assert n.set_goal(msg.PoseStamped(20.0, 20.0))
    assert n.planner.get_cell(10, 10) == -1e6 and n.planner.get_cell(20, 20) == 0.0


def test_occupancy_refresh_keeps_goals_unless_resized():
    tp = Planner(PlannerConfig(epsilon=1e-2), device="cpu")
    img = maps.open_room(24, 24)
    tp.update_occupancy(_occupancy(img))
    tp.add_goals([(12.0, 12.0)])
    tp.update_occupancy(_occupancy(img))
    assert tp.get_cell(12, 12) == 0.0
    tp.update_occupancy(_occupancy(maps.open_room(20, 24)))
    assert tuple(tp.state.u.shape) == (20, 24) and tp.get_cell(12, 12) == -1e6


def test_world_transforms_and_errors():
    tp = Planner(PlannerConfig(epsilon=1e-2, resolution=0.5, origin_x=-2.0, origin_y=1.0), device="cpu")
    with pytest.raises(EpicError):
        tp.get_cell(0, 0)
    tp.init(10, 8)
    assert tp.world_to_map(-1.0, 2.0) == (2.0, 2.0)
    assert tp.map_to_world(2.0, 2.0) == (-1.0, 2.0)
    with pytest.raises(InvalidLocationError):
        tp.world_to_map(3.0, 2.0)
    with pytest.raises(EpicError):
        tp.compute_path((0.0, 3.0))  # an unrelaxed field gives no path


def test_config_surface():
    """configs/*.yaml load unchanged; only backend="auto" is accepted; a
    cascade solve runs (tests/test_torch_cascade.py holds it to
    epic_tpu's)."""
    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    tp = Planner(cfg, device="cpu")
    assert tp.config.epsilon == 1e-3 and tp.config.steps_per_update == 50
    assert tp.config.stagger == 100
    with pytest.raises(ValueError):
        SolverConfig(backend="pallas")
    with pytest.raises(ValueError):
        PlannerConfig(backend="xla")
    with pytest.raises(ValueError):
        EpicConfig.from_dict({"solver": {"backend": "xla"}})
    tp.init(16, 16)
    # compute_paths_batch is ported: an unrelaxed field gives no path.
    assert tp.compute_paths_batch([(3.0, 3.0), (-1.0, 3.0)]) == [None, None]
    casc = Planner(PlannerConfig(cascade=True, epsilon=1e-2), device="cpu")
    casc.init(24, 24)
    casc.add_goals([(12.0, 12.0)])
    casc.solve()
    assert bool(casc.state.converged) and int(casc.state.iteration) % 100 == 1
    with pytest.raises(ValueError):
        EpicNavigationNode(PlannerConfig())
