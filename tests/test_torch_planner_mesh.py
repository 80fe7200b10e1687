"""The port's MeshPlanner (service verbs over mesh-resident shards) on a CPU
mesh, in the five sessions of tests/test_planner_mesh.py: against the
port's single-device Planner bit for bit, and against epic_tpu's MeshPlanner
on the conftest's virtual 8-device mesh (fields rtol=2e-6, atol=1e-3 as in
tests/test_torch_solver.py; iterations equal)."""

import numpy as np
import pytest
import torch

import jax

from epic_tpu import maps
from epic_tpu.parallel import make_mesh as jmake_mesh
from epic_tpu.planner import PlannerConfig as JPlannerConfig
from epic_tpu.planner_mesh import MeshPlanner as JMeshPlanner
from epic_tpu_torch.parallel import make_mesh
from epic_tpu_torch.planner import Planner, PlannerConfig
from epic_tpu_torch.planner_mesh import MeshPlanner
from epic_tpu_torch.parallel import hopper_resident2d, hopper_shard2d

FIELD = dict(rtol=2e-6, atol=1e-3)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jmake_mesh((2, 4))


def _mesh():
    return make_mesh((2, 4), devices=[CPU] * 8)


def _three(cfg_kw, jmesh8):
    """The port's Planner and MeshPlanner, and epic_tpu's MeshPlanner."""
    return (Planner(PlannerConfig(**cfg_kw), device="cpu"),
            MeshPlanner(PlannerConfig(**cfg_kw), mesh=_mesh()),
            JMeshPlanner(JPlannerConfig(**cfg_kw), mesh=jmesh8))


def _ingest(pl, img):
    occ = np.where(np.asarray(img) != 0, np.int8(0), np.int8(100))
    h, w = img.shape
    pl.init(w, h)
    pl.update_occupancy(occ)
    gy, gx = [int(v) for v in np.argwhere(np.asarray(img) == 255)[0]]
    assert pl.add_goals([(gx, gy)])


def _session(pl, img, ticks=6, steps=25):
    """ingest -> goal -> ticks -> edit -> ticks (test_planner_mesh.py)."""
    _ingest(pl, img)
    for _ in range(ticks):
        pl.update(steps)
    assert pl.set_cells([(5, 7), (9, 3)], [1, 1])
    for _ in range(ticks):
        pl.update(steps)
    return pl


def _same(mesh_pl, pl):
    """MeshPlanner vs Planner: the same bits (the ring comes back locked
    from the shards, so locked is compared inside it)."""
    a, b = mesh_pl.state, pl.state
    assert torch.equal(a.u, b.u)
    assert torch.equal(a.locked[1:-1, 1:-1], b.locked[1:-1, 1:-1])
    assert int(a.iteration) == int(b.iteration)
    assert torch.equal(a.delta, b.delta)
    assert bool(a.converged) == bool(b.converged)


def _close_to_reference(mesh_pl, jpl):
    assert int(mesh_pl.state.iteration) == int(jpl.state.iteration)
    np.testing.assert_allclose(mesh_pl.state.u.numpy(), np.asarray(jpl.state.u), **FIELD)


def test_mesh_session_matches_planner(jmesh8):
    img = maps.recursive_maze(64, 64, seed=4)
    p1, p2, p3 = (_session(p, img) for p in _three(dict(epsilon=1e-2), jmesh8))
    _same(p2, p1)
    _close_to_reference(p2, p3)
    assert p2.get_cell(5, 7) == p1.get_cell(5, 7)
    free = np.argwhere(~p1.state.locked.numpy())
    sy, sx = free[len(free) // 2]
    paths = [p.compute_path((float(sx), float(sy)), 0.2, 0.4) for p in (p1, p2)]
    assert [(q.x, q.y) for q in paths[0]] == [(q.x, q.y) for q in paths[1]]


def test_mesh_solve_matches_planner(jmesh8):
    img = maps.recursive_maze(64, 64, seed=9)
    p1, p2, p3 = _three(dict(epsilon=1e-2), jmesh8)
    for pl in (p1, p2, p3):
        _ingest(pl, img)
        pl.solve()
    assert bool(p1.state.converged) and bool(p2.state.converged) and bool(p3.state.converged)
    _same(p2, p1)
    _close_to_reference(p2, p3)


def test_mesh_reset_and_goal_guard(jmesh8):
    img = maps.recursive_maze(64, 64, seed=4)
    p1, p2, p3 = (_session(p, img) for p in _three(dict(epsilon=1e-2), jmesh8))
    # Goals inside obstacles are refused (the reference's obstacle guard).
    locked, u = p2.state.locked.numpy(), p2.state.u.numpy()
    oy, ox = np.argwhere(locked & (u == np.float32(-1e6)))[0]
    for p in (p1, p2, p3):
        assert not p.add_goals([(float(ox), float(oy))])
    for p in (p1, p2, p3):
        assert p.reset_free_cells()
    st = p2.state
    assert (st.u.numpy()[~st.locked.numpy()] == np.float32(-1e6)).all()
    np.testing.assert_array_equal(st.u.numpy(), np.asarray(p3.state.u))
    # Like grid.reset_free_cells (the Planner's), the reset restarts the
    # iteration; epic_tpu's MeshPlanner keeps it, so the sessions part here.
    assert int(st.iteration) == 0
    for p in (p1, p2):
        p.update(10)
    _same(p2, p1)
    assert int(p2.state.iteration) == 10


def test_mesh_single_step_convergence_verdict(jmesh8):
    img = maps.recursive_maze(64, 64, seed=9)
    p1, p2, p3 = _three(dict(epsilon=1e-2), jmesh8)
    for pl in (p1, p2, p3):
        _ingest(pl, img)
        pl.solve()
        assert bool(pl.state.converged)
        pl.update(1)   # relaxation continues; a converged field stays converged
        assert bool(pl.state.converged)
    _same(p2, p1)
    _close_to_reference(p2, p3)


def test_navigation_node_runs_on_mesh_planner(jmesh8):
    """The node is planner-agnostic: an injected MeshPlanner (the server's
    --mesh) runs the same verb session as the single-device Planner."""
    from epic_tpu.services import messages as jmsg
    from epic_tpu.services.navigation_node import EpicNavigationNodeRviz as JNode
    from epic_tpu_torch.services import messages as msg
    from epic_tpu_torch.services.navigation_node import EpicNavigationNodeRviz

    cfg = PlannerConfig(epsilon=1e-2, steps_per_update=10)
    jcfg = JPlannerConfig(epsilon=1e-2, steps_per_update=10)
    n1 = EpicNavigationNodeRviz(cfg, device="cpu")
    n2 = EpicNavigationNodeRviz(cfg, planner=MeshPlanner(cfg, mesh=_mesh()))
    n3 = JNode(jcfg, planner=JMeshPlanner(jcfg, mesh=jmesh8))
    occ = np.zeros((24, 32), dtype=np.int8)
    occ[0, :] = occ[-1, :] = occ[:, 0] = occ[:, -1] = 100
    for n, m in ((n1, msg), (n2, msg), (n3, jmsg)):
        n.sub_occupancy_grid(m.OccupancyGrid(32, 24, 1.0, 0.0, 0.0, occ))
        assert n.srv_add_goals(m.ModifyGoalsRequest([m.PoseStamped(16.0, 12.0)])).success
        n.update()
        assert n.srv_set_cells(m.SetCellsRequest([5, 5], [1])).success
        n.update()
        assert n.srv_get_cell(m.GetCellRequest(16, 12)).success
    _same(n2.planner, n1.planner)
    _close_to_reference(n2.planner, n3.planner)


def test_mesh_planner_never_runs_the_kernel_on_the_cpu_and_refuses_resident():
    """On a CPU mesh no CUDA entry runs; a solve in resumable segments runs
    on the resident route (K16/K17's) and gives the Planner's bits, and is
    refused on the per-shard route."""
    before = dict(hopper_shard2d.launches), dict(hopper_resident2d.launches)
    img = maps.recursive_maze(32, 48, seed=2)
    pl = _session(MeshPlanner(PlannerConfig(epsilon=1e-2), mesh=_mesh(), kernel="resident"), img,
                  ticks=2, steps=7)
    ref = _session(Planner(PlannerConfig(epsilon=1e-2), device="cpu"), img, ticks=2, steps=7)
    pl.solve(segment_iterations=100)
    ref.solve()
    _same(pl, ref)
    assert (dict(hopper_shard2d.launches), dict(hopper_resident2d.launches)) == before
    per_shard = _session(MeshPlanner(PlannerConfig(epsilon=1e-2), mesh=_mesh(), kernel="xla"),
                         img, ticks=2, steps=7)
    with pytest.raises(ValueError, match="resident route"):
        per_shard.solve(segment_iterations=100)
    with pytest.raises(ValueError, match="CUDA entry"):
        MeshPlanner(PlannerConfig(epsilon=1e-2), mesh=_mesh(), kernel="pallas")
