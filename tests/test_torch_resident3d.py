"""The port's 3D device route (epic_tpu_torch.parallel.hopper_resident3d:
every shard of a device in one launch, and sharded3d's rule that picks it)
on CPU meshes: the plan's face kinds, the plain versions plain_cycle3d and
plain_solve3d against the port's core bit for bit, the routes a plan with a
copied face takes, and the routes "auto", "resident" and
"resident_interpret" against epic_tpu's resident3d (K20) and resident_z
(K21) in interpret mode on the conftest's virtual 8-device mesh, as
tests/test_resident3d.py and tests/test_resident_z.py run them.

Tolerances across the packages are tests/test_torch_sharded3d.py's: fields
rtol=2e-6, atol=1e-3; deltas rtol=1e-5, atol=1e-5 (torch's and XLA's CPU
exp differ by an ulp on some inputs); iteration counts equal. Within the
port: the same bits. The CUDA entries against these plain versions:
tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epic_tpu import grid as JG
from epic_tpu.parallel import make_mesh as jmake_mesh
from epic_tpu.parallel import resident3d as jresident3d
from epic_tpu.parallel import resident_z as jresident_z
from epic_tpu.parallel import sharded3d as jsharded3d
from epic_tpu_torch import grid as TG
from epic_tpu_torch.parallel import (hopper_resident3d, hopper_shard3d, make_mesh, make_mesh3d,
                                     resident3d, resident_z, sharded3d)
from epic_tpu_torch.parallel.hopper_resident3d import COPIED, DIRECT, FACES, OUTSIDE
from epic_tpu_torch.parallel.sharded import Mesh
from epic_tpu_torch.solver import core

FIELD = dict(rtol=2e-6, atol=1e-3)
DELTA = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
CPU0, CPU1 = torch.device("cpu", 0), torch.device("cpu", 1)
# (mesh, volume): plane meshes with padding on y and x, z meshes of one-plane,
# odd (9-plane) and padded (22 -> 24 planes) shards, mixed meshes, one shard.
CASES = [((2, 4), (7, 21, 37)), ((8, 1, 1), (8, 12, 14)), ((4, 1, 1), (36, 16, 20)),
         ((4, 1, 1), (22, 16, 20)), ((2, 2, 2), (11, 18, 26)), ((4, 2, 1), (10, 13, 9)),
         ((1, 1), (9, 14, 18))]


def _ids(case):
    mesh, vol = case
    return "x".join(map(str, mesh)) + "-" + "x".join(map(str, vol))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once
    (see tests/test_torch_solver.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape):
    n = int(np.prod(shape))
    return (make_mesh3d if len(shape) == 3 else make_mesh)(shape, devices=[CPU] * n)


def _mesh_of(devices, ranks, rank=0) -> Mesh:
    """A mesh of the given device and rank arrays (nested lists)."""
    ranks = np.asarray(ranks)
    devs = np.empty(ranks.shape, dtype=object)
    for idx in np.ndindex(*ranks.shape):
        devs[idx] = np.asarray(devices, dtype=object)[idx]
    return Mesh(devs, ranks, rank)


def _jmesh(shape):
    devs = np.asarray(jax.devices()[:int(np.prod(shape))])
    if len(shape) == 3:
        return jsharded3d.make_mesh3d(shape, devices=devs)
    return jmake_mesh(shape, devices=devs)


def _arrays(d, h, w, density=0.12, seed=0):
    """tests/test_sharded3d.py's volume: the shell locked, seeded obstacle
    voxels, one goal voxel at the centre."""
    rng = np.random.default_rng(seed)
    u = np.full((d, h, w), -1e6, dtype=np.float32)
    locked = np.zeros((d, h, w), dtype=bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    if density:
        locked |= rng.random((d, h, w)) < density
    u[d // 2, h // 2, w // 2] = 0.0
    locked[d // 2, h // 2, w // 2] = True
    return u, locked


def _volume(d, h, w, density=0.12, seed=0, eps=1e-2, t0=0):
    u, locked = _arrays(d, h, w, density, seed)
    st = TG.make_state(u, locked, eps, device="cpu")
    return dataclasses.replace(st, iteration=torch.tensor(t0, dtype=torch.int32))


def _jvolume(d, h, w, density=0.12, seed=0, eps=1e-2):
    return JG.make_state(*_arrays(d, h, w, density, seed), epsilon=eps)


def _same(a, b):
    """Two port states: the same bits."""
    assert torch.equal(a.u, b.u)
    assert torch.equal(a.delta, b.delta)
    assert int(a.iteration) == int(b.iteration)
    assert bool(a.converged) == bool(b.converged)


def _close_state(ours, theirs):
    np.testing.assert_allclose(np.asarray(ours.u), np.asarray(theirs.u), **FIELD)
    np.testing.assert_allclose(np.asarray(ours.delta), np.asarray(theirs.delta), **DELTA)
    assert int(ours.iteration) == int(theirs.iteration)
    assert bool(ours.converged) == bool(theirs.converged)


def _field(sv, blocks=None):
    d, h, w = sv.shape
    return sharded3d._gather(sv, sv.u_blocks if blocks is None else blocks)[:d, :h, :w]


# -- the plan -----------------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 4), (8, 1, 1), (2, 2, 2), (1, 1)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_face_kinds_on_one_device(shape):
    """One device of one process: a face is direct where the mesh goes on,
    outside at its edge and on every axis it does not cut; the plan is
    whole and covers every shard."""
    mesh = _mesh(shape)
    (plan,) = hopper_resident3d.plans(mesh)
    assert plan.whole and plan.slots == mesh.local and plan.device == CPU
    ext = sharded3d._extents(mesh)
    for idx in mesh.local:
        zyx = sharded3d._zyx(idx)
        for face, kind in zip(FACES, plan.kinds[idx]):
            inside = all(0 <= a + b < n for a, b, n in zip(zyx, face, ext))
            assert kind == (DIRECT if inside else OUTSIDE), (idx, face)
    sv = sharded3d.shard_state3d(_volume(9, 14, 18), mesh)
    assert hopper_resident3d.fits(sv, plan)


def test_plan_faces_across_devices_and_processes():
    """Shards on cpu:0 and cpu:1 of one process, and shards of another
    process: their faces are copied, so no plan is whole."""
    two = _mesh_of([[CPU0, CPU0, CPU1, CPU1]] * 2, [[0] * 4] * 2)
    plans = hopper_resident3d.plans(two)
    assert [(str(p.device), p.slots) for p in plans] == [
        ("cpu:0", [(0, 0), (0, 1), (1, 0), (1, 1)]), ("cpu:1", [(0, 2), (0, 3), (1, 2), (1, 3)])]
    assert not any(p.whole for p in plans)
    kinds = dict(zip(FACES, plans[0].kinds[(0, 1)]))
    assert kinds[(0, 0, 1)] == COPIED and kinds[(0, 0, -1)] == DIRECT
    assert kinds[(0, 1, 0)] == DIRECT and kinds[(0, -1, 0)] == OUTSIDE
    assert kinds[(-1, 0, 0)] == kinds[(1, 0, 0)] == OUTSIDE
    procs = _mesh_of([[[CPU] * 2] * 2] * 2, [[[0] * 2] * 2, [[1] * 2] * 2], rank=1)
    (plan,) = hopper_resident3d.plans(procs)
    assert plan.slots == [(1, 0, 0), (1, 0, 1), (1, 1, 0), (1, 1, 1)] and not plan.whole
    assert all(dict(zip(FACES, k))[(-1, 0, 0)] == COPIED for k in plan.kinds.values())
    assert all(dict(zip(FACES, k))[(1, 0, 0)] == OUTSIDE for k in plan.kinds.values())


def test_route_rule_and_its_count():
    """A whole plan takes the device route on "auto", "resident" and
    "resident_interpret", the per-shard route on the per-shard names; a
    plan with a copied face takes the per-shard route on every name. Each
    gives core's bits; ``sharded3d.routes`` counts each call."""
    st = _volume(10, 12, 20, seed=4)
    ref = core.update_n(st, 7)
    whole, two = _mesh((2, 4)), _mesh_of([[CPU0, CPU0, CPU1, CPU1]] * 2, [[0] * 4] * 2)
    for mesh, kernel, route in ((whole, "auto", "device"), (whole, "resident", "device"),
                                (whole, "resident_interpret", "device"), (whole, "xla", "shard"),
                                (whole, "pallas_interpret", "shard"), (two, "auto", "shard"),
                                (two, "resident", "shard"), (two, "resident_interpret", "shard")):
        before = dict(sharded3d.routes)
        cycles = hopper_resident3d.calls["cycle"]
        shards = hopper_shard3d.calls["sweep_k_local3d"]
        _same(sharded3d.update_n(st, 7, mesh, chunk_depth=3, kernel=kernel), ref)
        other = "shard" if route == "device" else "device"
        assert sharded3d.routes[route] == before[route] + 1, (kernel, route)
        assert sharded3d.routes[other] == before[other]
        assert (hopper_resident3d.calls["cycle"] > cycles) == (route == "device")
        assert (hopper_shard3d.calls["sweep_k_local3d"] > shards) == (route == "shard")
    sol = core.solve(_volume(8, 12, 20, seed=2, density=0.05, eps=1e-1), 10)
    for kernel in ("auto", "resident"):
        _same(sharded3d.solve(_volume(8, 12, 20, seed=2, density=0.05, eps=1e-1), two, 10,
                              kernel=kernel), sol)
    # A mixed mesh refuses "resident" (as epic_tpu does) but takes "auto".
    mixed = _mesh((2, 2, 2))
    with pytest.raises(ValueError, match="no resident 3D layout"):
        sharded3d.update_n(st, 7, mixed, kernel="resident")
    _same(sharded3d.update_n(st, 7, mixed), ref)


# -- the plain versions against core ------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_cycle3d_equals_core_bit_for_bit(case):
    """Ticks of 1, 4 and 13 sweeps from both parities, and the centres after
    sweep 0 in the u1 blocks: core's bits; the halos are left as they
    were."""
    shape, dims = case
    mesh = _mesh(shape)
    for t0 in (0, 1):
        st = _volume(*dims, seed=3, t0=t0)
        for n in (1, 4, 13):
            sv = sharded3d.shard_state3d(st, mesh, halo=2)
            (plan,) = hopper_resident3d.plans(mesh)
            sv.u1_blocks = sharded3d._blank(mesh, sv.block_shape(sv.halo), 7.0, torch.float32)
            halos = {idx: b.clone() for idx, b in sv.u_blocks.items()}
            delta = hopper_resident3d.plain_cycle3d(sv, plan, torch.tensor(t0), n, u1=True)
            ref = core.update_n(st, n)
            assert torch.equal(_field(sv), ref.u) and torch.equal(delta, ref.delta)
            assert torch.equal(_field(sv, sv.u1_blocks), core.update_n(st, 1).u)
            c = sv.view(0)
            for idx, b in sv.u_blocks.items():
                halo = torch.ones_like(b, dtype=torch.bool)
                halo[c] = False
                assert torch.equal(b[halo], halos[idx][halo])
                assert (sv.u1_blocks[idx][halo] == 7.0).all()


@pytest.mark.parametrize("case", CASES[:5], ids=_ids)
def test_plain_solve3d_equals_core_bit_for_bit(case):
    """Converged, capped and zero-capped solves, and the same resumed across
    segment bounds: core.solve's field, delta, iteration and verdict."""
    from epic_tpu_torch.solver.tiled import segment_bounds

    shape, dims = case
    mesh = _mesh(shape)
    st = _volume(*dims, seed=5, density=0.08, eps=1e-1)
    for stagger, cap in ((10, 1_000_000), (7, 1_000_000), (10, 95), (3, 0)):
        ref = core.solve(st, stagger, cap)
        for seg in (None, 20):
            sv = sharded3d.shard_state3d(st, mesh)
            (plan,) = hopper_resident3d.plans(mesh)
            it = torch.zeros((), dtype=torch.int32)
            delta = (sv.epsilon + 1.0).to(torch.float32)
            done = torch.zeros((), dtype=torch.int32)
            bounds = [cap] if seg is None else segment_bounds(stagger, cap, seg)
            for bound in bounds:
                hopper_resident3d.plain_solve3d(sv, plan, stagger, bound, it, delta, done)
            assert torch.equal(_field(sv), ref.u), (stagger, cap, seg)
            assert torch.equal(delta, ref.delta) and int(it) == int(ref.iteration)
            assert bool(done) == bool(ref.converged)


def test_wrappers_run_plain_on_the_cpu_and_refuse_what_the_entries_do_not_take():
    """cycle and solve on a CPU plan: the plain versions, counted in calls,
    no launch; a plan with a copied face, ns < 1, stagger < 1 and u1 without
    u1 blocks are refused."""
    mesh = _mesh((2, 2, 2))
    st = _volume(10, 12, 16, seed=1)
    sv = sharded3d.shard_state3d(st, mesh)
    (plan,) = hopper_resident3d.plans(mesh)
    launches, calls = dict(hopper_resident3d.launches), dict(hopper_resident3d.calls)
    delta = hopper_resident3d.cycle(sv, plan, 0, 6, t_off=0)
    ref = core.update_n(st, 6)
    assert torch.equal(_field(sv), ref.u) and torch.equal(delta, ref.delta)
    it, d, done = (torch.zeros((), dtype=torch.int32), torch.ones(()),
                   torch.zeros((), dtype=torch.int32))
    hopper_resident3d.solve(sv, plan, 10, 40, it, d, done)
    assert int(it) == 40 and not bool(done)
    assert hopper_resident3d.launches == launches
    assert hopper_resident3d.calls["cycle"] > calls["cycle"]
    assert hopper_resident3d.calls["solve"] == calls["solve"] + 1
    with pytest.raises(ValueError, match="at least one sweep"):
        hopper_resident3d.cycle(sv, plan, 0, 0)
    with pytest.raises(ValueError, match="no u1 blocks"):
        hopper_resident3d.cycle(sv, plan, 0, 2, u1=True)
    with pytest.raises(ValueError, match="stagger"):
        hopper_resident3d.solve(sv, plan, 0, 40, it, d, done)
    two = _mesh_of([[CPU0, CPU0, CPU1, CPU1]] * 2, [[0] * 4] * 2)
    sv2 = sharded3d.shard_state3d(st, two)
    for p in hopper_resident3d.plans(two):
        with pytest.raises(ValueError, match="whole plan"):
            hopper_resident3d.cycle(sv2, p, 0, 2)
        with pytest.raises(ValueError, match="whole plan"):
            hopper_resident3d.solve(sv2, p, 10, 40, it, d, done)


def test_sweep_cost_routes():
    """The model prices a slot a unit and a row ROW_COST: the device route's
    centre, the per-shard route's trapezoids averaged over a chunk."""
    k, dev = sharded3d.sweep_cost((256, 256, 256), (1, 2, 4), route="device")
    assert dev == 256 * 128 * (32 + sharded3d.ROW_COST["device"])
    k, shard = sharded3d.sweep_cost((256, 256, 256), (1, 2, 4), route="shard")
    rows = sum(254 * (142 - 2 * s) * (-(-(78 - 2 * s) // 2) + sharded3d.ROW_COST["shard"])
               for s in range(8))
    assert k == 8 and shard == pytest.approx(rows / 8)
    assert sharded3d.whole_mesh([CPU] * 8) and not sharded3d.whole_mesh([CPU0, CPU1])


# (volume, mesh extents, the route whose 100-sweep tick tile_probe --mesh3d
# measured faster on an H100, PERF.md).
MEASURED_ROUTES = [
    ((256, 256, 256), (8, 1, 1), "device"), ((256, 256, 256), (1, 2, 4), "device"),
    ((64, 1024, 1024), (8, 1, 1), "device"), ((64, 1024, 1024), (1, 2, 4), "device"),
    ((128, 1024, 1024), (8, 1, 1), "device"), ((128, 1024, 1024), (1, 2, 4), "shard"),
    ((256, 1024, 1024), (8, 1, 1), "device"), ((256, 1024, 1024), (1, 2, 4), "shard"),
    ((384, 1024, 1024), (8, 1, 1), "device"), ((384, 1024, 1024), (1, 2, 4), "shard"),
    ((512, 1024, 1024), (8, 1, 1), "shard"), ((512, 1024, 1024), (1, 2, 4), "shard"),
    ((128, 512, 512), (8, 1, 1), "device"), ((128, 512, 512), (1, 2, 4), "device"),
    ((256, 512, 512), (8, 1, 1), "device"), ((256, 512, 512), (1, 2, 4), "device"),
    ((64, 256, 256), (8, 1, 1), "device"), ((64, 256, 256), (1, 2, 4), "device"),
    ((128, 256, 256), (8, 1, 1), "device"), ((128, 256, 256), (1, 2, 4), "device")]


@pytest.mark.parametrize("shape,ext,faster", MEASURED_ROUTES,
                         ids=lambda v: "x".join(map(str, v)) if isinstance(v, tuple) else v)
def test_auto_route_rule_follows_the_measured_ticks(shape, ext, faster):
    """"auto" on a whole plan (prefers_device) picks the route measured
    faster: the per-shard route only for shards above 12M voxels with
    little halo recompute."""
    loc = [-(-s // n) for s, n in zip(shape, ext)]
    cut = [n > 1 for n in ext]
    k = sharded3d._depth(loc, cut, sharded3d.DEFAULT_CHUNK_DEPTH)
    assert sharded3d.prefers_device(loc, cut, k) == (faster == "device")


# -- the routes against epic_tpu ----------------------------------------------------------------

@pytest.mark.parametrize("module", ["resident3d", "resident_z"])
def test_routes_match_epic_tpus_resident_kernels(module):
    """K20 (resident3d on 8 x 128 planes of a 2 x 1 mesh) and K21
    (resident_z on 2-plane shards of an 8 x 1 x 1 mesh), in interpret mode:
    a tick from each parity and a solve, against the port's "auto",
    "resident" and "resident_interpret" routes and the module's own."""
    if module == "resident3d":
        shape, dims, jmod, mod = (2, 1), (6, 16, 128), jresident3d, resident3d
    else:
        shape, dims, jmod, mod = (8, 1, 1), (16, 12, 128), jresident_z, resident_z
    mesh, jmesh = _mesh(shape), _jmesh(shape)
    for t0 in (0, 1):
        jst = dataclasses.replace(_jvolume(*dims, seed=3), iteration=jnp.int32(t0))
        theirs = jmod.update_n(jst, 5, jmesh)
        st = _volume(*dims, seed=3, t0=t0)
        for kernel in ("auto", "resident", "resident_interpret"):
            _close_state(sharded3d.update_n(st, 5, mesh, kernel=kernel), theirs)
        _close_state(mod.update_n(st, 5, mesh), theirs)
    if module == "resident_z":
        jst = _jvolume(*dims, seed=5, density=0.06)
        theirs = jmod.solve(jst, jmesh, stagger=10)
        assert bool(theirs.converged)
        st = _volume(*dims, seed=5, density=0.06)
        for kernel in ("auto", "resident_interpret"):
            _close_state(sharded3d.solve(st, mesh, 10, kernel=kernel, segment_iterations=37),
                         theirs)
        _close_state(mod.solve(st, mesh, stagger=10), theirs)
