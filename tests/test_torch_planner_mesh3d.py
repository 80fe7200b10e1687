"""The port's MeshVolumePlanner (the 3D service verbs over mesh-resident
shards) on CPU meshes, in the sessions of tests/test_planner_mesh3d.py:
against the port's single-device VolumePlanner bit for bit, and against
epic_tpu's MeshVolumePlanner on the conftest's virtual 8-device z mesh
(K21 in interpret mode; fields rtol=2e-6, atol=1e-3 as in
tests/test_torch_solver.py; iterations equal)."""

import numpy as np
import pytest
import torch

import jax

from epic_tpu import grid as JG
from epic_tpu.parallel.sharded3d import make_mesh3d as jmake_mesh3d
from epic_tpu.planner3d import VolumePlannerConfig as JVolumePlannerConfig
from epic_tpu.planner_mesh import MeshVolumePlanner as JMeshVolumePlanner
from epic_tpu_torch import constants as C
from epic_tpu_torch import grid as TG
from epic_tpu_torch.parallel import hopper_resident3d, hopper_shard3d, make_mesh, make_mesh3d
from epic_tpu_torch.planner3d import VolumePlanner, VolumePlannerConfig
from epic_tpu_torch.planner_mesh import MeshVolumePlanner
from epic_tpu_torch.solver import core

FIELD = dict(rtol=2e-6, atol=1e-3)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(d=24, h=24, w=128, density=0.08, seed=3):
    """tests/test_planner_mesh3d.py's volume."""
    rng = np.random.default_rng(seed)
    u = np.full((d, h, w), -1e6, dtype=np.float32)
    locked = np.zeros((d, h, w), dtype=bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    locked |= rng.random((d, h, w)) < density
    u[d // 2, h // 2, w // 2] = 0.0
    locked[d // 2, h // 2, w // 2] = True
    return u, locked


def _mesh(shape):
    n = int(np.prod(shape))
    maker = make_mesh3d if len(shape) == 3 else make_mesh
    return maker(shape, devices=[CPU] * n)


def _pair(cfg_kw, shape, **kw):
    """The port's VolumePlanner and a MeshVolumePlanner on a CPU mesh."""
    return (VolumePlanner(VolumePlannerConfig(**cfg_kw), device="cpu"),
            MeshVolumePlanner(VolumePlannerConfig(**cfg_kw), mesh=_mesh(shape), **kw))


def _same(mesh_pl, pl):
    """MeshVolumePlanner vs VolumePlanner: the same bits (the shell comes
    back locked from the shards, so locked is compared inside it)."""
    a, b = mesh_pl.state, pl.state
    assert torch.equal(a.u, b.u)
    assert torch.equal(a.locked[1:-1, 1:-1, 1:-1], b.locked[1:-1, 1:-1, 1:-1])
    assert int(a.iteration) == int(b.iteration)
    assert torch.equal(a.delta, b.delta)
    assert bool(a.converged) == bool(b.converged)


def _session(pl, state):
    """tests/test_planner_mesh3d.py's verb session: state ingest, a goal by
    set_cells, ticks, a warm solve."""
    pl.state = state
    pl.update()
    assert pl.set_cells([(9, 9, 9)], [C.CELL_TYPE_GOAL])
    pl.update(7)
    pl.solve(max_iterations=2000)
    return pl


@pytest.mark.parametrize("shape,kernel", [((8, 1, 1), "resident"), ((2, 4), "auto"),
                                          ((2, 2, 2), "auto")],
                         ids=["z8-resident", "2x4-auto", "2x2x2-auto"])
def test_session_matches_volume_planner(shape, kernel):
    u, locked = _arrays()
    p1, p2 = _pair(dict(epsilon=1e-2, steps_per_update=6), shape, kernel=kernel)
    for pl in (p1, p2):
        _session(pl, TG.make_state(u, locked, 1e-2, device="cpu"))
    assert bool(p1.state.converged)
    _same(p2, p1)
    # reset_free_cells on the resident blocks == grid.reset_free_cells.
    p1.reset_free_cells()
    p2.reset_free_cells()
    _same(p2, p1)
    assert int(p2.state.iteration) == 0
    for pl in (p1, p2):
        pl.update(10)
    _same(p2, p1)


def test_session_matches_epic_tpu():
    """The same session on epic_tpu's MeshVolumePlanner (the z-resident
    route, K21 in interpret mode on the 8-device z mesh)."""
    u, locked = _arrays()
    jp = JMeshVolumePlanner(JVolumePlannerConfig(epsilon=1e-2, steps_per_update=6),
                            mesh=jmake_mesh3d((8, 1, 1)), kernel="resident_interpret")
    _session(jp, JG.make_state(u, locked, epsilon=1e-2))
    p = MeshVolumePlanner(VolumePlannerConfig(epsilon=1e-2, steps_per_update=6),
                          mesh=_mesh((8, 1, 1)), kernel="resident")
    _session(p, TG.make_state(u, locked, 1e-2, device="cpu"))
    assert bool(jp.state.converged) and bool(p.state.converged)
    assert int(jp.state.iteration) == int(p.state.iteration)
    np.testing.assert_allclose(p.state.u.numpy(), np.asarray(jp.state.u), **FIELD)
    # reset_free_cells: the same field; epic_tpu keeps the iteration, the
    # port (like its VolumePlanner) restarts it (ROADMAP, known divergences).
    jp.reset_free_cells()
    p.reset_free_cells()
    np.testing.assert_array_equal(p.state.u.numpy(), np.asarray(jp.state.u))
    assert int(p.state.iteration) == 0


def test_occupancy_goals_and_paths_match_volume_planner():
    """Ingest by update_occupancy, goals by world points (one refused in an
    obstacle), GetCell, ticks, remove_goals, and the walkers: the same as
    the VolumePlanner."""
    d, h, w = 12, 20, 28
    rng = np.random.default_rng(4)
    occ = np.where(rng.random((d, h, w)) < 0.1, 100, 0).astype(np.int8)
    occ[6, 10, 14] = 0
    cfg = dict(epsilon=1e-2, steps_per_update=20, resolution=0.5, origin_x=1.0)
    p1, p2 = _pair(cfg, (2, 4))
    wall = tuple(int(v) for v in np.argwhere(occ[1:-1, 1:-1, 1:-1] == 100)[0] + 1)
    for pl in (p1, p2):
        pl.init(w, h, d)
        pl.update_occupancy(occ)
        assert pl.add_goals([(1.0 + 14 * 0.5, 10 * 0.5, 6 * 0.5)])
        assert not pl.add_goals([(1.0 + wall[2] * 0.5, wall[1] * 0.5, wall[0] * 0.5)])
        assert not pl.add_goals([(-5.0, 0.0, 0.0)])
        for _ in range(3):
            pl.update()
    _same(p2, p1)
    assert p2.get_cell(14, 10, 6) == p1.get_cell(14, 10, 6) == 0.0
    assert p2.get_cell(3, 4, 5) == p1.get_cell(3, 4, 5)
    start = (1.0 + 20 * 0.5, 12 * 0.5, 5 * 0.5)
    paths = [pl.compute_path(start, 0.2, 0.4, max_length=500) for pl in (p1, p2)]
    assert [(q.x, q.y, q.z) for q in paths[0]] == [(q.x, q.y, q.z) for q in paths[1]]
    batch = [pl.compute_paths_batch([start, (-9.0, 0.0, 0.0)], max_steps=64) for pl in (p1, p2)]
    assert batch[1][1] is None
    assert [(q.x, q.y, q.z) for q in batch[0][0]] == [(q.x, q.y, q.z) for q in batch[1][0]]
    for pl in (p1, p2):
        assert pl.remove_goals([(1.0 + 14 * 0.5, 10 * 0.5, 6 * 0.5)])
        pl.update(3)
    _same(p2, p1)
    # A resize reinitialises the volume (goals lost), as the VolumePlanner's.
    for pl in (p1, p2):
        pl.update_occupancy(np.zeros((8, 10, 12), np.int8))
    _same(p2, p1)
    assert p2.state.u.shape == (8, 10, 12)


def test_solve_resident_segments_and_single_step_verdict():
    u, locked = _arrays(d=16, h=16, w=40)
    ref = core.solve(TG.make_state(u, locked, 1e-2, device="cpu"), 10)
    for seg in (None, 93):
        p = MeshVolumePlanner(VolumePlannerConfig(epsilon=1e-2, stagger=10),
                              mesh=_mesh((4, 1, 1)), kernel="resident")
        p.state = TG.make_state(u, locked, 1e-2, device="cpu")
        p.solve(segment_iterations=seg)
        assert bool(p.state.converged) and torch.equal(p.state.u, ref.u)
        assert int(p.state.iteration) == int(ref.iteration)
    p.update(1)      # relaxation continues; a converged field stays converged
    assert bool(p.state.converged)


def test_mesh_volume_planner_never_runs_the_kernel_on_the_cpu_and_refuses_names():
    before = (dict(hopper_shard3d.launches), dict(hopper_resident3d.launches))
    calls = hopper_resident3d.calls["cycle"]
    u, locked = _arrays(d=10, h=12, w=16)
    p = MeshVolumePlanner(VolumePlannerConfig(epsilon=1e-2), mesh=_mesh((2, 2, 2)))
    p.state = TG.make_state(u, locked, 1e-2, device="cpu")
    p.update(9)     # "auto" on one device: the device route's plain version
    assert (dict(hopper_shard3d.launches), dict(hopper_resident3d.launches)) == before
    assert hopper_resident3d.calls["cycle"] > calls
    assert p.device == CPU and p.initialized
    with pytest.raises(ValueError, match="unknown sharded 3D kernel"):
        MeshVolumePlanner(mesh=_mesh((2, 4)), kernel="bogus")
    with pytest.raises(ValueError, match="CUDA entry"):
        MeshVolumePlanner(mesh=_mesh((2, 4)), kernel="pallas")
    mixed = MeshVolumePlanner(mesh=_mesh((2, 2, 2)), kernel="resident")
    mixed.init(16, 12, 10)
    with pytest.raises(ValueError, match="no resident 3D layout"):
        mixed.update(3)
    if not torch.cuda.is_available():
        # mesh=None chooses the orientation over every visible card: none here.
        with pytest.raises(RuntimeError, match="no CUDA device"):
            MeshVolumePlanner()
    assert len(jax.devices()) == 8
