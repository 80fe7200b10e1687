"""The port's 2D resident mesh route (epic_tpu_torch.parallel.resident,
resident_tiled, hopper_resident2d, and sharded's kernel="resident") on CPU
meshes: the cases of tests/test_resident.py and tests/test_resident_tiled.py
at their shapes, against the port's own core and its per-shard route bit
for bit; the plan of a device and the host's copies; and against
epic_tpu.parallel.resident and resident_tiled on the conftest's virtual
8-device mesh, whose Pallas kernels K16/K17 run in interpret mode there.

Tolerances across the packages follow tests/test_torch_sharded.py: fields
rtol=2e-6, atol=1e-3; deltas rtol=1e-5, atol=1e-5 (torch's and XLA's CPU
exp differ by an ulp on some inputs); iteration counts equal. Within the
port: the same bits. The CUDA entries against the plain versions:
tests/test_torch_cuda.py.

A mesh whose devices are ``cpu:0`` and ``cpu:1`` stands for two devices of
one process: its plans copy the halos between them, as on two cards.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epic_tpu
from epic_tpu import maps
from epic_tpu.parallel import make_mesh as jmake_mesh
from epic_tpu.parallel import resident as jresident
from epic_tpu.parallel import resident_tiled as jresident_tiled
from epic_tpu_torch import grid as TG
from epic_tpu_torch.parallel import (hopper_resident2d, hopper_shard2d, make_mesh, resident,
                                     resident_tiled, sharded)
from epic_tpu_torch.parallel.hopper_resident2d import COPIED, DIRECT, OUTSIDE
from epic_tpu_torch.parallel.sharded import Mesh
from epic_tpu_torch.planner import PlannerConfig
from epic_tpu_torch.planner_mesh import MeshPlanner
from epic_tpu_torch.solver import core

FIELD = dict(rtol=2e-6, atol=1e-3)
DELTA = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
CPU0, CPU1 = torch.device("cpu", 0), torch.device("cpu", 1)
MODULES = {"resident": resident, "resident_tiled": resident_tiled}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once
    (see tests/test_torch_solver.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) == 8, "conftest must provide 8 virtual devices"
    return jmake_mesh((2, 4))


def _mesh(shape=(2, 4)):
    return make_mesh(shape, devices=[CPU] * (shape[0] * shape[1]))


def _mesh_of(devices, ranks, rank=0):
    """A mesh of the given device and rank grids (lists of rows)."""
    shape = (len(devices), len(devices[0]))
    devs = np.empty(shape, dtype=object)
    for idx in np.ndindex(*shape):
        devs[idx] = devices[idx[0]][idx[1]]
    return Mesh(devs, np.asarray(ranks), rank)


def _two_devices():
    """2 x 4 over two devices of one process, two columns each."""
    return _mesh_of([[CPU0, CPU0, CPU1, CPU1]] * 2, [[0] * 4] * 2)


def _img(h, w, seed=3, density=0.12):
    return maps.random_obstacles(h, w, density=density, seed=seed)


def _state(img, eps=1e-2, t0=0):
    return dataclasses.replace(TG.from_occupancy_image(img, eps, device="cpu"),
                               iteration=torch.tensor(t0, dtype=torch.int32))


def _jstate(img, eps=1e-2, t0=0):
    return dataclasses.replace(epic_tpu.from_occupancy_image(img, epsilon=eps),
                               iteration=jnp.int32(t0))


def _same(a, b):
    """Two port states: the same bits."""
    assert torch.equal(a.u, b.u)
    assert torch.equal(a.delta, b.delta)
    assert int(a.iteration) == int(b.iteration)
    assert bool(a.converged) == bool(b.converged)


def _close(ours, theirs, tol=FIELD):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), **tol)


# -- the cases of tests/test_resident.py and tests/test_resident_tiled.py ---------------------

@pytest.mark.parametrize("module,steps", [("resident", 1), ("resident", 5), ("resident", 16),
                                          ("resident", 37), ("resident_tiled", 1),
                                          ("resident_tiled", 2), ("resident_tiled", 17),
                                          ("resident_tiled", 33)])
def test_resident_update_bit_equals_per_shard_route(module, steps):
    """Every chunk count, from both parities: the resident route's bits are
    the per-shard route's (K14/K15's plain version) and core's."""
    img = _img(32, 512)
    for t0 in (0, 1):
        st = _state(img, t0=t0)
        out = MODULES[module].update_n(st, steps, _mesh())
        _same(out, sharded.update_n(st, steps, _mesh(), kernel="xla"))
        _same(out, core.update_n(st, steps))


@pytest.mark.parametrize("module,shape,seed", [("resident", (48, 1024), 7),
                                               ("resident_tiled", (64, 1024), 7)])
def test_resident_update_matches_core(module, shape, seed):
    st = _state(_img(*shape, seed=seed))
    _same(MODULES[module].update_n(st, 9, _mesh()), core.update_n(st, 9))


@pytest.fixture(scope="module")
def solved():
    """The 32 x 512 solve of tests/test_resident.py (stagger 10) at eps
    1e-1: core's and the resident route's, in one run and in segments of 37
    and 137 (core's bits are the per-shard route's: tests/test_torch_sharded.py)."""
    st = _state(_img(32, 512, seed=5, density=0.1), eps=1e-1)
    mesh = _mesh()
    return dict(core=core.solve(st, stagger=10),
                resident=resident.solve(st, mesh, stagger=10),
                seg37=resident.solve_segments(st, mesh, stagger=10, segment_iterations=37),
                seg137=resident_tiled.solve_segments(st, mesh, stagger=10,
                                                     segment_iterations=137))


def test_resident_solve_bit_equals_core(solved):
    out = solved["resident"]
    assert bool(out.converged) and int(out.iteration) % 10 == 1
    _same(out, solved["core"])


@pytest.mark.parametrize("segments", ["seg37", "seg137"])
def test_resident_solve_segments_bit_equals_solve(solved, segments):
    _same(solved[segments], solved["resident"])


def test_segments_route_through_sharded_and_refuse_the_per_shard_route():
    st = _state(_img(32, 512, seed=5, density=0.1), eps=1e-1)
    mesh = _mesh()
    out = sharded.solve(st, mesh, stagger=10, max_iterations=200, kernel="resident_interpret",
                        segment_iterations=37)
    _same(out, core.solve(st, stagger=10, max_iterations=200))
    for kernel in ("xla", "pallas_banded_interpret"):
        with pytest.raises(ValueError, match="resident route"):
            sharded.solve(st, mesh, stagger=10, kernel=kernel, segment_iterations=9)


@pytest.mark.parametrize("stagger,cap", [(10, 7), (10, 30), (10, 105), (20, 17), (20, 41)])
def test_resident_solve_cap_matches_per_shard_route(stagger, cap):
    """Capped exits, with stagger 10 and the reference's folded-check
    stagger 20, overshoot the cap to the end of the cycle as the per-shard
    route and core do."""
    st = _state(_img(16, 512, seed=2, density=0.05), eps=1e-6)
    out = resident.solve(st, _mesh(), stagger=stagger, max_iterations=cap)
    assert not bool(out.converged)
    _same(out, sharded.solve(st, _mesh(), stagger=stagger, max_iterations=cap, kernel="xla"))
    _same(out, core.solve(st, stagger=stagger, max_iterations=cap))


def test_resident_folded_check_solve_matches_core():
    """stagger > K (20 > 8 on 8 x 128 shards): the check chunk and the rest."""
    st = _state(_img(16, 512, seed=5, density=0.06), eps=1e-1)
    out = resident_tiled.solve(st, _mesh(), stagger=20)
    assert bool(out.converged)
    _same(out, core.solve(st, stagger=20))


@pytest.mark.parametrize("shape", [(8, 1), (1, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_resident_1d_mesh_and_shallow_shards(shape):
    """(8, 1): shards 8 rows tall cut the depth to the shard height."""
    st = _state(_img(64, 256, seed=4))
    _same(resident.update_n(st, 6, _mesh(shape), chunk_depth=16), core.update_n(st, 6))


def test_resident_maze_goal_field():
    img = maps.recursive_maze(32, 512, seed=9)
    st = _state(img, eps=1e-3)
    _same(resident.update_n(st, 50, _mesh()), sharded.update_n(st, 50, _mesh(), kernel="xla"))


def test_sharded_kernel_routing():
    """sharded.update_n(kernel="resident") and "auto" route to the resident
    route (prefers_resident); MeshPlanner passes its kernel on."""
    st = _state(_img(32, 512, seed=6))
    mesh = _mesh()
    calls = dict(hopper_resident2d.calls)
    out = resident.update_n(st, 5, mesh)
    assert hopper_resident2d.calls["cycle"] > calls["cycle"]
    for kernel in ("resident", "resident_interpret", "auto"):
        _same(sharded.update_n(st, 5, mesh, kernel=kernel), out)
    assert sharded.prefers_resident(mesh, 16, 128)
    before = dict(hopper_resident2d.calls)
    pl = MeshPlanner(PlannerConfig(epsilon=1e-2), mesh=mesh, kernel="xla")
    pl.init(64, 32)
    pl.update(7)
    assert hopper_resident2d.calls == before
    pl = MeshPlanner(PlannerConfig(epsilon=1e-2), mesh=mesh, kernel="resident")
    pl.init(64, 32)
    pl.update(7)
    assert hopper_resident2d.calls["cycle"] == before["cycle"] + 1


def test_misaligned_shards_take_the_route():
    """The port's route needs no alignment (the reference refuses 15 x 125
    shards): they run and give core's bits; an interpret flag that names
    the other device's route is refused."""
    st = _state(_img(30, 500, seed=8), eps=1e-1)
    mesh = _mesh()
    _same(resident.update_n(st, 3, mesh), core.update_n(st, 3))
    _same(resident_tiled.update_n(st, 3, mesh), core.update_n(st, 3))
    _same(resident.solve(st, mesh, stagger=10, max_iterations=60),
          core.solve(st, stagger=10, max_iterations=60))
    _same(resident.update_n(st, 3, mesh, interpret=True), core.update_n(st, 3))
    with pytest.raises(ValueError, match="other device's route"):
        resident.update_n(st, 3, mesh, interpret=False)
    with pytest.raises(ValueError, match="names the plain version"):
        sharded.check_kernel("resident_interpret", _mesh_of([[torch.device("cuda", 0)]], [[0]]))


def test_eligible_and_prefer_tiled_gates():
    """The port's shape rule: any shard with a cell; prefer_tiled_shards
    chooses nothing (one route serves every width)."""
    for h, w in ((2048, 2048), (2048, 2000), (2043, 2048), (2048, 256), (8, 512), (1, 1)):
        assert resident.eligible(h, w) and resident_tiled.eligible(h, w)
        assert resident_tiled.prefer_tiled_shards(h, w)
    assert not resident.eligible(0, 512)
    assert not resident_tiled.prefer_tiled_shards(2048, 0)


def test_auto_route_rule():
    """"auto" takes the resident route where one device holds the mesh and
    shards are at most 12M cells (PERF.md's times), else the per-shard
    route; both give the same bits."""
    for mesh in (_mesh(), _mesh((8, 1)), _mesh((1, 1))):
        for h_loc, w_loc in ((1, 1), (241, 121), (4096, 2048), (3000, 4000)):
            assert sharded.prefers_resident(mesh, h_loc, w_loc)
        for h_loc, w_loc in ((6144, 3072), (8192, 4096), (3000, 4001)):
            assert not sharded.prefers_resident(mesh, h_loc, w_loc)
    assert not sharded.prefers_resident(_two_devices(), 241, 121)
    two_processes = _mesh_of([[CPU] * 4] * 2, [[0] * 4, [1] * 4], rank=0)
    assert not sharded.prefers_resident(two_processes, 241, 121)
    st = _state(_img(24, 40, seed=5, density=0.1))
    calls = dict(hopper_resident2d.calls)
    _same(sharded.update_n(st, 7, _two_devices()), core.update_n(st, 7))
    assert hopper_resident2d.calls == calls


# -- the port's route on its own meshes: core's bits -------------------------------------------

@pytest.mark.parametrize("name", ["2x4", "8x1", "1x1", "2x4-two-devices"])
def test_resident_route_equals_core(name):
    """Ticks from both parities at three depths, solves (converged and
    capped) and a solve in segments: core's bits, on one device (one launch
    a tick) and on two (the host copies the halos between them)."""
    mesh = _two_devices() if name == "2x4-two-devices" else _mesh(tuple(map(int, name.split("x"))))
    img = _img(24, 40, seed=5, density=0.1)
    for t0 in (0, 1):
        st = _state(img, t0=t0)
        for n, depth in ((1, 16), (5, 4), (37, 16), (37, 1)):
            _same(sharded.update_n(st, n, mesh, chunk_depth=depth, kernel="resident"),
                  core.update_n(st, n))
    st = _state(img, eps=1e-1)
    for stagger, cap in ((10, 1_000_000), (7, 1_000_000), (10, 95)):
        _same(sharded.solve(st, mesh, stagger, cap, chunk_depth=4, kernel="resident"),
              core.solve(st, stagger, cap))
    _same(sharded.solve(st, mesh, 10, chunk_depth=16, kernel="resident", segment_iterations=30),
          core.solve(st, 10))


def test_route_switches_between_ticks_with_edits():
    """Resident and per-shard ticks interleaved with an edit on a grid
    sharded once: the per-shard route exchanges every halo first, so the
    resident route's stale direct halos never reach it."""
    img = _img(40, 56, seed=4, density=0.15)
    st = _state(img)
    mesh = _mesh()
    sh = sharded.shard_state(st, mesh, halo=2)
    edits = ([(10, 11), (20, 7)], [1, 2])
    sharded.update_n_resident(sh, 9, mesh, chunk_depth=4, kernel="resident")
    sharded.update_n_resident(sh, 8, mesh, chunk_depth=4, kernel="xla")
    sharded.set_cells_resident(sh, *edits)
    sharded.update_n_resident(sh, 13, mesh, chunk_depth=8, kernel="resident")
    sharded.update_n_resident(sh, 5, mesh, chunk_depth=8, kernel="xla")
    ref = core.update_n(TG.set_cells(core.update_n(st, 17), *edits), 18)
    back = sharded.unshard(sh)
    assert torch.equal(back.u, ref.u) and int(back.iteration) == int(ref.iteration)


# -- the plan and the host's copies -----------------------------------------------------------

def test_plan_classifies_neighbours_and_copies_only_copied_halos():
    """On a 2 x 4 mesh of two processes (rows) whose first process holds
    two devices (two columns each): same device and process is direct,
    another device or process copied, beyond the mesh outside; the copies
    between processes come first, for every pair of the mesh, then this
    process's copies between its devices."""
    mesh = _mesh_of([[CPU0, CPU0, CPU1, CPU1], [CPU0] * 4], [[0] * 4, [1] * 4], rank=0)
    plans = hopper_resident2d.plans(mesh)
    assert [(str(p.device), p.slots) for p in plans] == [
        ("cpu:0", [(0, 0), (0, 1)]), ("cpu:1", [(0, 2), (0, 3)])]
    assert not any(p.whole for p in plans)
    kinds = plans[0].kinds[(0, 1)]
    assert kinds[(0, -1)] == DIRECT and kinds[(0, 1)] == COPIED        # cpu:1
    assert kinds[(1, 0)] == kinds[(1, 1)] == kinds[(1, -1)] == COPIED  # process 1
    assert kinds[(-1, 0)] == kinds[(-1, -1)] == kinds[(-1, 1)] == OUTSIDE
    assert plans[1].kinds[(0, 3)][(0, 1)] == OUTSIDE
    h, w, H, k = 5, 7, 4, 3
    transfers = hopper_resident2d.copied_transfers(mesh, plans, h, w, H, k)
    between = [(s, d) for s, _, d, _ in transfers[:20]]
    assert all(mesh.ranks[s] != mesh.ranks[d] for s, d in between)
    assert len(between) == 20 and between[0] == ((1, 0), (0, 0))
    within = [(s, d) for s, _, d, _ in transfers[20:]]
    assert sorted(within) == [((0, 1), (0, 2)), ((0, 2), (0, 1))]
    # The corner strips come from the diagonal neighbour itself.
    s_idx, d_idx = next((si, di) for s, si, d, di in transfers if (s, d) == ((1, 2), (0, 1)))
    assert (s_idx, d_idx) == ((slice(4, 7), slice(4, 7)), (slice(9, 12), slice(11, 14)))
    # A single process: only the pairs between its two devices are copied.
    mesh2 = _two_devices()
    plans2 = hopper_resident2d.plans(mesh2)
    st = _state(_img(10, 28, seed=1))
    sh = sharded.shard_state(st, mesh2, halo=H)
    for b in sh.u_blocks.values():                           # halos: a sentinel
        centre = b[H:H + h, H:H + w].clone()
        b.fill_(7.0)
        b[H:H + h, H:H + w] = centre
    sharded._run_phase(mesh2, sh.u_blocks,
                       hopper_resident2d.copied_transfers(mesh2, plans2, h, w, H, k))
    for p in plans2:
        for ij in p.slots:
            for (di, dj), kind in p.kinds[ij].items():
                rows = hopper_resident2d._halo(h, H, k, di)
                cols = hopper_resident2d._halo(w, H, k, dj)
                got = sh.u_blocks[ij][rows, cols]
                if kind == COPIED:
                    src = sh.u_blocks[ij[0] + di, ij[1] + dj]
                    assert torch.equal(got, src[hopper_resident2d._edge(h, H, k, di),
                                                hopper_resident2d._edge(w, H, k, dj)])
                else:
                    assert (got == 7.0).all(), (ij, (di, dj), kind)


def _forced(plans, copied):
    """The plans with the neighbours ``copied`` ({shard: [offset]}) marked
    COPIED (as if on another device)."""
    out = []
    for p in plans:
        kinds = {ij: dict(nb) for ij, nb in p.kinds.items()}
        for ij, offsets in copied.items():
            for d in offsets:
                kinds[ij][d] = COPIED
        out.append(hopper_resident2d.Plan(p.device, list(p.slots), kinds))
    return out


def test_forced_copied_neighbours_give_the_same_bits():
    """Neighbours marked copied on one device: the host copies their halos
    before each one-chunk cycle, and the chunks give the all-direct cycle's
    bits (and the deltas its max over the shards)."""
    img = _img(40, 56, seed=2, density=0.15)
    st = core.update_n(_state(img), 3)
    mesh = _mesh()
    k, total = 4, 11
    runs = {}
    for name, copied in (("direct", {}),
                         ("copied", {(0, 1): [(0, 1), (1, 1), (1, 0)], (1, 2): [(-1, -1)],
                                     (1, 0): [(-1, 0), (-1, 1), (0, 1)]})):
        sh = sharded.shard_state(st, mesh, halo=k)
        sharded._frozen_halos(sh, k)
        sh.u1_blocks = sharded._blank(mesh, sh.u_blocks[0, 0].shape, sharded.FILL, torch.float32)
        plans = _forced(hopper_resident2d.plans(mesh), copied)
        assert plans[0].whole == (name == "direct")
        transfers = hopper_resident2d.copied_transfers(mesh, plans, sh.h_loc, sh.w_loc, k, k)
        deltas = []
        for c, ns in enumerate((4, 4, 3)):
            sharded._run_phase(mesh, sh.u_blocks, transfers)
            deltas.append(hopper_resident2d.cycle(sh, plans[0], k, st.iteration, ns, 1,
                                                  t_off=4 * c, u1=c == 0)[0])
            sharded._swap(sh)
        runs[name] = (sharded.unshard(sh).u, sharded._gather(sh, sh.u1_blocks), deltas)
    assert torch.equal(runs["direct"][0], core.update_n(st, total).u)
    assert torch.equal(runs["copied"][0], runs["direct"][0])
    assert torch.equal(runs["copied"][1], runs["direct"][1])
    assert torch.equal(torch.stack(runs["copied"][2]), torch.stack(runs["direct"][2]))
    assert float(runs["direct"][2][0]) == float(core.update_n(st, 1).delta)


def test_wrappers_run_plain_on_the_cpu_and_refuse_what_the_entries_do_not_take():
    st = _state(_img(24, 40, seed=1))
    mesh = _mesh()
    sh = sharded.shard_state(st, mesh, halo=4)
    plan = hopper_resident2d.plans(mesh)[0]
    launches, calls = dict(hopper_resident2d.launches), dict(hopper_resident2d.calls)
    deltas = hopper_resident2d.cycle(sh, plan, 4, 0, 10, 3)
    assert deltas.shape == (3,) and deltas.dtype == torch.float32
    assert hopper_resident2d.launches == launches
    assert hopper_resident2d.calls["cycle"] == calls["cycle"] + 1
    calls_k14 = dict(hopper_shard2d.calls)
    with pytest.raises(ValueError, match="chunks of 1..4"):
        hopper_resident2d.cycle(sh, plan, 4, 0, 13, 3)
    copied = _forced([plan], {(0, 0): [(0, 1)]})[0]
    with pytest.raises(ValueError, match="one chunk a launch"):
        hopper_resident2d.cycle(sh, copied, 4, 0, 8, 2)
    it, delta = torch.zeros((), dtype=torch.int32), torch.ones(())
    done = torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="whole mesh"):
        hopper_resident2d.solve(sh, copied, 4, 10, 100, it, delta, done)
    with pytest.raises(ValueError, match="u1 blocks"):
        hopper_resident2d.solve(sh, plan, 4, 10, 100, it, delta, done)
    assert hopper_shard2d.calls == calls_k14


# -- the port against epic_tpu's K16/K17 (interpret mode) ---------------------------------------

@pytest.mark.parametrize("module", ["resident", "resident_tiled"])
def test_update_n_matches_epic_tpus_resident_kernels(jmesh8, module):
    """21 sweeps from both parities on 32 x 512 (16 x 128 shards)."""
    img = _img(32, 512, seed=11)
    jmod = {"resident": jresident, "resident_tiled": jresident_tiled}[module]
    for t0 in (0, 1):
        ours = MODULES[module].update_n(_state(img, t0=t0), 21, _mesh())
        theirs = jmod.update_n(_jstate(img, t0=t0), 21, jmesh8)
        _close(ours.u, theirs.u)
        _close(ours.delta, theirs.delta, DELTA)
        assert int(ours.iteration) == int(theirs.iteration)


@pytest.mark.parametrize("module", ["resident", "resident_tiled"])
def test_solve_matches_epic_tpus_resident_kernels(jmesh8, module):
    img = _img(32, 512, seed=5, density=0.1)
    jmod = {"resident": jresident, "resident_tiled": jresident_tiled}[module]
    ours = MODULES[module].solve(_state(img, eps=1e-1), _mesh(), stagger=10)
    theirs = jmod.solve(_jstate(img, eps=1e-1), jmesh8, stagger=10)
    assert int(ours.iteration) == int(theirs.iteration)
    assert bool(ours.converged) and bool(theirs.converged)
    _close(ours.u, theirs.u)
    _close(ours.delta, theirs.delta, DELTA)
