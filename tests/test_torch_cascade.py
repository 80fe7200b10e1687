"""The port's coarse-to-fine cascade (epic_tpu_torch.solver.cascade) against
epic_tpu's on the CPU: the same pyramid (per-level iterations and shapes
equal) and fine fields within tests/test_torch_solver.py's FIELD tolerance;
Planner(cascade=True) in both packages; the mesh planners, which solve cold
with cascade=True in both packages; and the R9 rule that a Planner built
from an EpicConfig drops solver.cascade in both (ROADMAP, known
divergences). Plus the cases of tests/test_cascade.py on the port, with the
maps cut to 128^2. No test here calls epic_tpu.native: where epic_tpu's
cascade needs a native coarse solver, it is handed the port's."""

import numpy as np
import pytest
import torch

import epic_tpu
import epic_tpu.planner as jplanner_mod
from epic_tpu import maps
from epic_tpu.config import EpicConfig as JEpicConfig
from epic_tpu.parallel import make_mesh as jmake_mesh
from epic_tpu.planner import Planner as JPlanner
from epic_tpu.planner import PlannerConfig as JPlannerConfig
from epic_tpu.planner_mesh import MeshPlanner as JMeshPlanner
from epic_tpu.solver import cascade as jcascade
from epic_tpu.solver import core as jcore
import epic_tpu_torch as T
from epic_tpu_torch import analysis, native
from epic_tpu_torch.config import EpicConfig
from epic_tpu_torch.parallel import make_mesh
from epic_tpu_torch.planner import Planner, PlannerConfig
from epic_tpu_torch.planner_mesh import MeshPlanner
from epic_tpu_torch.solver import cascade, core

FIELD = dict(rtol=2e-6, atol=1e-3)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jcore(st, stagger, max_iterations):
    return jcore.solve(st, stagger, max_iterations)


def _port(img, eps=1e-3):
    return T.from_occupancy_image(img, eps, device="cpu")


def _jax(img, eps=1e-3):
    return epic_tpu.from_occupancy_image(img, epsilon=eps)


def _same_cascade(j, t):
    (jw, js), (tw, ts) = j, t
    assert ts.shapes == js.shapes
    assert ts.iterations == js.iterations
    assert int(tw.iteration) == int(jw.iteration) == ts.iterations[-1]
    assert bool(tw.converged) and bool(jw.converged)
    np.testing.assert_allclose(tw.u.numpy(), np.asarray(jw.u), **FIELD)
    np.testing.assert_array_equal(tw.locked.numpy(), np.asarray(jw.locked))


CASES = {
    "open128": (lambda: maps.open_room(128, 128), {}),
    "maze128": (lambda: maps.recursive_maze(128, 128, seed=7), {}),
    "random96x128": (lambda: maps.random_obstacles(96, 128, density=0.1, seed=2), {}),
    "room120x100_levels2": (lambda: maps.open_room(120, 100), dict(levels=2, min_extent=12)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cascade_matches_epic_tpu(name):
    """coarse_solver = each package's core.solve: the same pyramid, the same
    per-level iterations, fine fields within FIELD."""
    make, kw = CASES[name]
    img = make()
    j = jcascade.solve_cascade(_jax(img), solver=_jcore, coarse_solver=_jcore, **kw)
    t = cascade.solve_cascade(_port(img), solver=core.solve, coarse_solver=core.solve, **kw)
    _same_cascade(j, t)


def test_cascade_native_coarse_matches_epic_tpu():
    """Coarse levels on the port's native C++ solve in both packages' cascades
    (the same bits at every coarse level), fine level on each core."""
    img = maps.recursive_maze(128, 128, seed=7)
    j = jcascade.solve_cascade(_jax(img), solver=_jcore, coarse_solver=cascade.native_solver)
    t = cascade.solve_cascade(_port(img), solver=core.solve,
                              coarse_solver=cascade.native_solver)
    _same_cascade(j, t)
    assert len(t[1].iterations) == 2


def test_cascade_3d_volume_matches_epic_tpu():
    img = np.full((24, 48, 48), 128, np.uint8)
    img[12, 24, 24] = 255
    j = jcascade.solve_cascade(epic_tpu.from_occupancy_volume(img, epsilon=1e-2), levels=1,
                               min_extent=12, solver=_jcore, coarse_solver=_jcore)
    t = cascade.solve_cascade(T.from_occupancy_volume(img, 1e-2, device="cpu"), levels=1,
                              min_extent=12)
    _same_cascade(j, t)
    assert t[1].shapes == ((12, 24, 24), (24, 48, 48))


def test_planner_cascade_matches_epic_tpu(monkeypatch):
    """Planner(cascade=True) in both packages, coarse levels on the final
    solver (no native library on either side): equal iterations, fields
    within FIELD, and fewer fine sweeps than a cold solve."""
    monkeypatch.setattr(jplanner_mod, "_native_available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    img = maps.recursive_maze(128, 128, seed=7)
    jp = JPlanner(JPlannerConfig(epsilon=1e-3, cascade=True))
    jp.state = _jax(img)
    jp.solve()
    tp = Planner(PlannerConfig(epsilon=1e-3, cascade=True), device="cpu")
    tp.state = _port(img)
    tp.solve()
    assert int(tp.state.iteration) == int(jp.state.iteration)
    np.testing.assert_allclose(tp.state.u.numpy(), np.asarray(jp.state.u), **FIELD)
    assert int(tp.state.iteration) < int(core.solve(_port(img)).iteration)


def test_planner_cascade_runs_native_coarse_levels():
    """With the library built, the port's Planner runs the coarse levels on
    it: the same fine iterations and fields as epic_tpu's cascade handed
    the same coarse solver."""
    assert native.available()
    img = maps.random_obstacles(96, 128, density=0.1, seed=2)
    tp = Planner(PlannerConfig(epsilon=1e-3, cascade=True), device="cpu")
    tp.state = _port(img)
    tp.solve()
    jw, js = jcascade.solve_cascade(_jax(img), solver=_jcore,
                                    coarse_solver=cascade.native_solver)
    assert int(tp.state.iteration) == int(jw.iteration) == js.iterations[-1]
    np.testing.assert_allclose(tp.state.u.numpy(), np.asarray(jw.u), **FIELD)
    assert bool(tp.state.converged)


def test_planner_cascade_capped(monkeypatch):
    """max_iterations caps the fine level, as in epic_tpu (the cap ends the
    stagger cycle it falls in): a capped cascade leaves converged False,
    with epic_tpu's iteration count. Without the native library the coarse
    levels run on the capped final solver too, in both packages."""
    monkeypatch.setattr(jplanner_mod, "_native_available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    img = maps.recursive_maze(96, 96, seed=2)
    tp = Planner(PlannerConfig(epsilon=1e-3, cascade=True), device="cpu")
    tp.state = _port(img)
    tp.solve(max_iterations=150)
    jp = JPlanner(JPlannerConfig(epsilon=1e-3, cascade=True))
    jp.state = _jax(img)
    jp.solve(max_iterations=150)
    assert int(tp.state.iteration) == int(jp.state.iteration) == 200
    assert not bool(tp.state.converged) and not bool(jp.state.converged)
    np.testing.assert_allclose(tp.state.u.numpy(), np.asarray(jp.state.u), **FIELD)


def test_mesh_planner_with_cascade_solves_cold():
    """MeshPlanner(cascade=True) solves cold in both packages (epic_tpu's
    never reads the field): on a 2 x 2 mesh, the iterations of a cold
    single-device solve; the port's the same bits."""
    img = maps.recursive_maze(64, 64, seed=3)
    occ = np.where(img != 0, np.int8(0), np.int8(100))
    gy, gx = [int(v) for v in np.argwhere(img == 255)[0]]
    cfg = dict(epsilon=1e-3, cascade=True)
    jax_devices = __import__("jax").devices()[:4]
    planners = (MeshPlanner(PlannerConfig(**cfg), mesh=make_mesh((2, 2), devices=[CPU] * 4)),
                JMeshPlanner(JPlannerConfig(**cfg), mesh=jmake_mesh((2, 2), devices=jax_devices)),
                Planner(PlannerConfig(epsilon=1e-3), device="cpu"))
    for pl in planners:
        pl.init(64, 64)
        pl.update_occupancy(occ)
        assert pl.add_goals([(gx, gy)])
        pl.solve()
    tm, jm, cold = (pl.state for pl in planners)
    assert int(tm.iteration) == int(jm.iteration) == int(cold.iteration)
    assert torch.equal(tm.u, cold.u)
    np.testing.assert_allclose(tm.u.numpy(), np.asarray(jm.u), **FIELD)


def test_epic_config_drops_cascade_in_both_packages():
    """R9, copied on purpose: solver.cascade in an EpicConfig does not reach
    the Planner in either package, so both solve cold, with the iterations
    of a cold solve."""
    img = maps.random_obstacles(64, 80, density=0.1, seed=5)
    tcfg = EpicConfig.from_dict({"solver": {"cascade": True, "epsilon": 1e-3}})
    jcfg = JEpicConfig.from_dict({"solver": {"cascade": True, "epsilon": 1e-3}})
    assert tcfg.solver.cascade and jcfg.solver.cascade
    tp, jp = Planner(tcfg, device="cpu"), JPlanner(jcfg)
    assert not tp.config.cascade and not jp.config.cascade
    tp.state, jp.state = _port(img), _jax(img)
    tp.solve()
    jp.solve()
    cold = core.solve(_port(img))
    assert int(tp.state.iteration) == int(jp.state.iteration) == int(cold.iteration)
    assert torch.equal(tp.state.u, cold.u)


# tests/test_cascade.py's cases on the port.


def test_cascade_open_room_converges_with_far_fewer_sweeps():
    img = maps.open_room(128, 128)
    cold = core.solve(_port(img))
    warm, stats = cascade.solve_cascade(_port(img))
    assert bool(warm.converged) and int(warm.iteration) % 100 == 1
    assert stats.total_fine_equivalent < int(cold.iteration) / 5
    goal = img == 255
    pv_cold = analysis.percent_valid(cold.u.numpy(), cold.locked.numpy(), goal)
    pv_warm = analysis.percent_valid(warm.u.numpy(), warm.locked.numpy(), goal)
    assert pv_warm >= pv_cold - 1e-9


def test_cascade_certificate_matches_protocol():
    """One more protocol check-sweep from the cascade's result stays below
    epsilon."""
    img = maps.random_obstacles(96, 128, density=0.1, seed=2)
    warm, _ = cascade.solve_cascade(_port(img))
    assert bool(warm.converged)
    out = core.update_n(T.make_state(warm.u, warm.locked, 1e-3, device="cpu"), 1)
    assert float(out.delta) < 1e-3


def test_cascade_maze_stays_valid():
    img = maps.recursive_maze(128, 128, seed=7)
    cold = core.solve(_port(img))
    warm, _ = cascade.solve_cascade(_port(img), coarse_solver=cascade.native_solver)
    goal = img == 255
    pv_cold = analysis.percent_valid(cold.u.numpy(), cold.locked.numpy(), goal)
    pv_warm = analysis.percent_valid(warm.u.numpy(), warm.locked.numpy(), goal)
    assert bool(warm.converged) and pv_warm >= pv_cold - 1e-9


def test_cascade_explicit_levels_and_shapes():
    img = maps.open_room(120, 100)
    warm, stats = cascade.solve_cascade(_port(img), levels=2)
    assert stats.shapes == ((30, 25), (60, 50), (120, 100))
    assert bool(warm.converged)


def test_cascade_native_coarse_solver_open_room():
    img = maps.open_room(128, 128)
    warm, _ = cascade.solve_cascade(_port(img), coarse_solver=cascade.native_solver)
    assert bool(warm.converged)
    assert analysis.percent_valid(warm.u.numpy(), warm.locked.numpy(), img == 255) == 1.0


def test_level_states_live_on_the_input_device():
    """Every level's state is built on the input state's device, with a
    contiguous u (the kernels refuse a view)."""
    seen = []

    def spy(st, stagger, max_iterations):
        seen.append((st.u.device, st.u.is_contiguous(), tuple(st.u.shape)))
        return core.solve(st, stagger, max_iterations)

    img = maps.open_room(101, 99)   # odd sides: the upsample is cropped
    cascade.solve_cascade(_port(img), levels=1, min_extent=12, solver=spy)
    assert seen == [(CPU, True, (51, 50)), (CPU, True, (101, 99))]
