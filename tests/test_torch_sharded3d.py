"""The port's 3D mesh solver (epic_tpu_torch.parallel.sharded3d, resident3d,
resident_z) on CPU meshes: against the port's own core bit for bit, and
against epic_tpu.parallel.sharded3d, resident3d and resident_z on the
conftest's virtual 8-device mesh (the XLA per-shard path, and the Pallas
kernels K18-K21 in interpret mode, as tests/test_sharded3d.py,
tests/test_resident3d.py and tests/test_resident_z.py run them).

Tolerances across the packages follow tests/test_torch_sharded.py: fields
rtol=2e-6, atol=1e-3; deltas rtol=1e-5, atol=1e-5 (torch's and XLA's CPU
exp differ by an ulp on some inputs); iteration counts equal. Within the
port: the same bits. The CUDA entry against the plain per-shard version:
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
from epic_tpu_torch import constants as C
from epic_tpu_torch import grid as TG
from epic_tpu_torch.parallel import (choose_mesh3d, hopper_shard3d, make_mesh, make_mesh3d,
                                     resident3d, resident_z, sharded3d)
from epic_tpu_torch.solver import core

FIELD = dict(rtol=2e-6, atol=1e-3)
DELTA = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
# (z, y, x) shard counts: plane meshes (2D), a z-only mesh and mixed meshes (3D).
MESHES = [(2, 4), (8, 1), (1, 1), (8, 1, 1), (2, 2, 2), (4, 2, 1)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once
    (see tests/test_torch_solver.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(shape=(2, 4)):
    n = int(np.prod(shape))
    maker = make_mesh3d if len(shape) == 3 else make_mesh
    return maker(shape, devices=[CPU] * n)


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


def _close(ours, theirs, tol=FIELD):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), **tol)


def _close_state(ours, theirs):
    _close(ours.u, theirs.u)
    _close(ours.delta, theirs.delta, DELTA)
    assert int(ours.iteration) == int(theirs.iteration)
    assert bool(ours.converged) == bool(theirs.converged)


def _kernels(shape):
    """The routes a mesh of ``shape`` serves on the CPU: the generic one,
    and the resident one on plane and z-only meshes."""
    if len(shape) == 3 and shape[1:] != (1, 1):
        return ("auto", "xla")
    return ("auto", "resident")


# -- meshes and layout --------------------------------------------------------------------------

def test_make_mesh3d_and_choose_mesh3d():
    m = make_mesh3d(devices=[CPU] * 8)
    assert m.shape == {"mz": 8, "my": 1, "mx": 1} and m.local[1] == (1, 0, 0)
    assert make_mesh3d((2, 2, 2), devices=[CPU] * 8).devices.shape == (2, 2, 2)
    with pytest.raises(ValueError, match="needs 6 shards"):
        make_mesh3d((1, 2, 3), devices=[CPU] * 8)
    with pytest.raises(ValueError, match="3D shape"):
        make_mesh3d((2, 4), devices=[CPU] * 8)
    devs = [CPU] * 8
    # The cheaper orientation by sharded3d.sweep_cost. One device holds the
    # mesh, so the device route's model: the z mesh's long rows, except
    # where z shards would be padded planes.
    cube = choose_mesh3d((256, 256, 256), devices=devs)
    assert cube.shape == {"mz": 8, "my": 1, "mx": 1}
    for shape in ((64, 1024, 1024), (128, 1024, 1024), (32, 2048, 2048), (512, 1024, 1024)):
        assert choose_mesh3d(shape, devices=devs).shape == cube.shape, shape
    assert choose_mesh3d((4, 64, 128), devices=devs).shape == {"my": 2, "mx": 4}
    # Eight devices: the per-shard route's model. Its lanes no longer idle on
    # short rows, so the plane mesh's smaller halo wins, except on deep
    # volumes of small planes.
    split = [torch.device("cpu", i) for i in range(8)]
    for shape in ((256, 256, 256), (64, 1024, 1024), (512, 1024, 1024), (4, 64, 128)):
        assert choose_mesh3d(shape, devices=split).shape == {"my": 2, "mx": 4}, shape
    assert choose_mesh3d((2048, 64, 64), devices=split).shape == cube.shape
    # The model against the z mesh's tick over the plane mesh's, 8 shards,
    # on each route, as tile_probe --mesh3d measured them on an H100
    # (PERF.md): within 8% (the per-shard route's on shards of 4M voxels
    # or more, where the launches it leaves out weigh little).
    for route, measured in (
            ("device", (((256, 256, 256), 0.940), ((64, 1024, 1024), 1.027),
                        ((128, 1024, 1024), 0.972), ((256, 1024, 1024), 0.949),
                        ((384, 1024, 1024), 0.933), ((512, 1024, 1024), 0.922),
                        ((128, 512, 512), 0.961), ((256, 512, 512), 0.928),
                        ((64, 256, 256), 0.961), ((128, 256, 256), 0.944))),
            ("shard", (((64, 1024, 1024), 1.763), ((128, 1024, 1024), 1.360),
                       ((256, 1024, 1024), 1.149), ((384, 1024, 1024), 1.080),
                       ((512, 1024, 1024), 1.039), ((128, 512, 512), 1.327),
                       ((256, 512, 512), 1.156)))):
        for shape, ratio in measured:
            z, plane = (sharded3d.sweep_cost(shape, ext, route=route)[1]
                        for ext in ((8, 1, 1), (1, 2, 4)))
            assert abs(z / plane / ratio - 1) < 0.08, (route, shape, z / plane, ratio)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            choose_mesh3d((256, 256, 256))
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh3d()
    # A 3D mesh is not a 2D one.
    from epic_tpu_torch.parallel import sharded
    with pytest.raises(ValueError, match="2D mesh"):
        sharded.shard_state(TG.empty_state(8, 8, device="cpu"), cube)


def test_padding_and_frozen_layout():
    st = _volume(7, 21, 37, seed=7)
    mesh = _mesh((2, 4))
    assert sharded3d.padded_shape((7, 21, 37), mesh) == (7, 22, 40)
    assert sharded3d.padded_shape((7, 21, 37), _mesh((4, 2, 1))) == (8, 22, 37)
    sv = sharded3d.shard_state3d(st, mesh)
    assert (sv.loc, sv.cut, sv.halo) == ((7, 11, 10), (False, True, True), 8)
    assert sv.u_blocks[0, 1].shape == (7, 11 + 16, 10 + 16)
    u, frozen = sv.u, sv.frozen
    assert u.shape == (7, 22, 40) and frozen.shape == (7, 22, 40)
    assert (u[:, 21:] == C.LOG_SPACE_OBSTACLE).all() and frozen[:, 21:].all()
    assert (u[:, :, 37:] == C.LOG_SPACE_OBSTACLE).all() and frozen[:, :, 37:].all()
    for axis in range(3):
        for edge in (0, st.u.shape[axis] - 1):
            assert frozen[:7, :21, :37].select(axis, edge).all()
    np.testing.assert_array_equal(frozen[1:6, 1:20, 1:36].numpy(),
                                  st.locked[1:6, 1:20, 1:36].numpy())
    # A z-only mesh cuts z alone: whole planes and guard planes.
    sv = sharded3d.shard_state3d(_volume(33, 12, 20), _mesh((8, 1, 1)))
    assert (sv.loc, sv.cut, sv.halo) == ((5, 12, 20), (True, False, False), 5)
    assert sv.u_blocks[3, 0, 0].shape == (15, 12, 20)
    back = sharded3d.unshard3d(sv)
    assert back.u.shape == (33, 12, 20)


# -- the port against its own core, bit for bit -------------------------------------------------

@pytest.mark.parametrize("depth", [1, 3, 8])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_update_n_equals_core_bit_for_bit(shape, depth):
    mesh = _mesh(shape)
    for t0 in (0, 1):
        st = _volume(11, 18, 26, seed=3, t0=t0)
        for n in (1, 5, 13):
            ref = core.update_n(st, n)
            for kernel in _kernels(shape):
                _same(sharded3d.update_n(st, n, mesh, chunk_depth=depth, kernel=kernel), ref)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: "x".join(map(str, s)))
def test_solve_equals_core_bit_for_bit(shape):
    st = _volume(9, 14, 18, seed=5, density=0.08, eps=1e-1)
    mesh = _mesh(shape)
    for stagger, cap in ((10, 1_000_000), (7, 1_000_000), (10, 95), (3, 0)):
        ref = core.solve(st, stagger, cap)
        for kernel in _kernels(shape):
            _same(sharded3d.solve(st, mesh, stagger, cap, kernel=kernel), ref)
            _same(sharded3d.solve(st, mesh, stagger, cap, kernel=kernel, segment_iterations=37),
                  ref)


def test_odd_one_plane_and_nonaligned_z_shards():
    """R3: z shards of an odd number of planes (the parity origin odd on
    alternate shards), of one plane (depth 1), and a padded tail shard."""
    for d, n in ((36, 4), (8, 8), (22, 4)):
        mesh = _mesh((n, 1, 1))
        for t0 in (0, 1):
            st = _volume(d, 16, 20, seed=5, t0=t0)
            for kernel in ("auto", "resident"):
                _same(sharded3d.update_n(st, 5, mesh, kernel=kernel), core.update_n(st, 5))
    st = _volume(8, 12, 14, seed=2, density=0.05, eps=1e-1)
    _same(resident_z.solve(st, _mesh((8, 1, 1)), stagger=10), core.solve(st, 10))


def test_resident_warm_loop_with_edits():
    """Shard once, interleave resident ticks and voxel edits (a halo regrown
    by a deeper chunk on the way): the single-device chain's bits."""
    st = _volume(10, 24, 32, seed=4)
    mesh = _mesh((2, 4))
    sv = sharded3d.shard_state3d(st, mesh, halo=2)
    edits = ([(10, 11, 5), (20, 7, 4), (10, 11, 5), (0, 5, 3)],
             [C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_GOAL, C.CELL_TYPE_FREE, C.CELL_TYPE_GOAL])
    sharded3d.update_n_resident3d(sv, 5, mesh, chunk_depth=2, kernel="resident")
    ref = core.update_n(st, 5)
    sharded3d.set_cells_resident3d(sv, *edits)
    ref = TG.set_cells_3d(ref, *edits)
    sharded3d.update_n_resident3d(sv, 7, mesh, chunk_depth=8)
    assert sv.halo == 8      # regrown to min(8, h_loc, w_loc)
    ref = core.update_n(ref, 7)
    back = sharded3d.unshard3d(sv)
    assert torch.equal(back.u, ref.u) and int(back.iteration) == int(ref.iteration)
    np.testing.assert_array_equal(back.locked[1:-1, 1:-1, 1:-1].numpy(),
                                  ref.locked[1:-1, 1:-1, 1:-1].numpy())
    sv, conv = sharded3d.solve_resident3d(sv, mesh, stagger=10, kernel="resident")
    ref = core.solve(ref, 10)
    assert bool(conv) and torch.equal(sharded3d.unshard3d(sv).u, ref.u)
    assert int(sv.iteration) == int(ref.iteration)


def test_set_cells_and_read_cell_on_and_off_the_shell():
    st = _volume(8, 16, 24, density=0.0)
    mesh = _mesh((2, 2, 2))
    sv = sharded3d.shard_state3d(st, mesh)
    sharded3d.set_cells_resident3d(
        sv, [(0, 5, 3), (23, 9, 4), (7, 0, 2), (5, 6, 3), (9, 8, 5), (12, 8, 4)],
        [C.CELL_TYPE_GOAL, C.CELL_TYPE_FREE, C.CELL_TYPE_FREE, C.CELL_TYPE_GOAL,
         C.CELL_TYPE_FREE, C.CELL_TYPE_OBSTACLE])
    back = sharded3d.unshard3d(sv)
    # On the shell: values written, voxels stay frozen (locked when gathered).
    assert float(back.u[3, 5, 0]) == 0.0 and bool(back.locked[3, 5, 0])
    assert float(back.u[4, 9, 23]) == -1e6 and bool(back.locked[4, 9, 23])
    assert bool(back.locked[2, 0, 7])
    # Off the shell: grid.set_cells_3d's values and flags, in every shard.
    assert float(back.u[3, 6, 5]) == 0.0 and bool(back.locked[3, 6, 5])
    assert float(back.u[5, 8, 9]) == -1e6 and not bool(back.locked[5, 8, 9])
    assert bool(back.locked[4, 8, 12])
    before = sv.u.clone()
    sharded3d.set_cells_resident3d(sv, [(999, 2, 1), (3, -1, 0)], [1, 1])     # skipped
    assert torch.equal(sv.u, before)
    assert sharded3d.read_cell3d(sv, 5, 6, 3) == (True, 0.0)
    assert sharded3d.read_cell3d(sv, 9, 8, 5) == (False, -1e6)


def test_reset_and_occupancy_on_resident_blocks():
    st = _volume(9, 16, 20, seed=6)
    mesh = _mesh((8, 1, 1))
    sv = sharded3d.update_n_resident3d(sharded3d.shard_state3d(st, mesh), 20, mesh)
    ref = TG.reset_free_cells(core.update_n(st, 20))
    sharded3d.reset_free_cells_resident3d(sv)
    back = sharded3d.unshard3d(sv)
    assert torch.equal(back.u, ref.u) and int(back.iteration) == 0
    assert float(back.delta) == float(ref.delta)
    before = sharded3d.unshard3d(sv)
    occ = np.zeros((9, 16, 20), np.int8)
    occ[2:5, 5:9, 7:15] = 100
    occ[6] = C.OCCUPANCY_NO_CHANGE
    occ[4, 8, 10] = 0          # the goal voxel stays a goal
    assert sharded3d.occupancy_resident3d(sv, occ)
    back = sharded3d.unshard3d(sv)
    assert bool(back.locked[3, 6, 8]) and float(back.u[3, 6, 8]) == -1e6
    assert bool(back.locked[4, 8, 10]) and float(back.u[4, 8, 10]) == 0.0
    assert not bool(back.locked[1, 1, 1]) and float(back.u[1, 1, 1]) == -1e6
    assert torch.equal(back.locked[6], before.locked[6]) and torch.equal(back.u[6], before.u[6])
    assert not sharded3d.occupancy_resident3d(
        sv, np.full((9, 16, 20), C.OCCUPANCY_NO_CHANGE, np.int8))
    with pytest.raises(ValueError, match="occupancy of shape"):
        sharded3d.occupancy_resident3d(sv, occ[:, :, :5])


def test_kernel_names_and_resident_routes():
    st = _volume(8, 16, 24, seed=8)
    plane, zmesh, mixed = _mesh((2, 4)), _mesh((8, 1, 1)), _mesh((2, 2, 2))
    sv = sharded3d.shard_state3d(st, zmesh)
    with pytest.raises(ValueError, match="unknown sharded 3D kernel"):
        sharded3d.update_n_resident3d(sv, 1, zmesh, kernel="bogus")
    with pytest.raises(ValueError, match="unknown sharded 3D kernel"):
        sharded3d.update_n(st, 1, zmesh, kernel="bogus")
    # The CUDA entry's names on a CPU mesh raise; the plain version's names run it.
    for kernel in ("pallas", "pallas_banded"):
        with pytest.raises(ValueError, match="CUDA entry"):
            sharded3d.update_n(st, 1, plane, kernel=kernel)
    ref = core.update_n(st, 3)
    for kernel in ("xla", "pallas_interpret", "pallas_banded_interpret", "resident_interpret"):
        _same(sharded3d.update_n(st, 3, plane, kernel=kernel), ref)
    # "resident" goes to resident3d on plane meshes and resident_z on z-only ones.
    _same(sharded3d.update_n(st, 3, plane, kernel="resident"), resident3d.update_n(st, 3, plane))
    _same(sharded3d.update_n(st, 3, zmesh, kernel="resident"), resident_z.update_n(st, 3, zmesh))
    with pytest.raises(ValueError, match="no resident 3D layout"):
        sharded3d.update_n(st, 3, mixed, kernel="resident")
    with pytest.raises(ValueError, match="no resident 3D layout"):
        sharded3d.solve_resident3d(sharded3d.shard_state3d(st, mixed), mixed, kernel="resident")
    with pytest.raises(ValueError, match="plane-sharded"):
        resident3d.update_n(st, 3, zmesh)
    with pytest.raises(ValueError, match="z-sharded mesh"):
        resident_z.update_n(st, 3, plane)
    with pytest.raises(ValueError, match="z ONLY"):
        resident_z.solve(st, mixed)
    with pytest.raises(ValueError, match="other device"):
        resident3d.update_n(st, 3, plane, interpret=False)
    _same(resident_z.update_n(st, 3, zmesh, interpret=True), ref)
    with pytest.raises(ValueError, match="lives on"):
        sharded3d.update_n_resident3d(sv, 1, plane)
    # The port's shape rule: any shard with a voxel on each axis (no TPU
    # alignment, no VMEM budget).
    assert resident3d.eligible(256, 250, 200) and resident3d.eligible(1, 1, 1)
    assert resident_z.eligible(1, 1024, 1024) and not resident_z.eligible(0, 16, 16)


def test_segments_equal_one_solve():
    st = _volume(6, 32, 40, seed=5, density=0.06)
    for mesh, mod in ((_mesh((4, 2)), resident3d), (_mesh((4, 1, 1)), resident_z)):
        one = mod.solve(st, mesh, stagger=10)
        assert bool(one.converged)
        for seg in (37, 10, 1):
            _same(mod.solve_segments(st, mesh, stagger=10, segment_iterations=seg), one)
        _same(sharded3d.solve(st, mesh, stagger=10, kernel="resident", segment_iterations=37), one)
        _same(sharded3d.solve(st, mesh, stagger=10, segment_iterations=37), one)
        capped = mod.solve_segments(st, mesh, stagger=10, max_iterations=55, segment_iterations=20)
        _same(capped, core.solve(st, 10, 55))


@pytest.mark.parametrize("shape", [(2, 4), (8, 1, 1), (2, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_block_delta_max_equals_the_centre_delta_max(shape):
    """K20/K21 take sweep 0's delta over each shard's centre, the entry
    over the whole block: after the exchange each chunk starts with, the
    max over the shards is the same (a halo voxel repeats its owner's
    update; out-of-mesh halos and padding are frozen)."""
    mesh = _mesh(shape)
    for t0 in (0, 1):
        st = core.update_n(_volume(11, 18, 26, seed=9, t0=t0), 20)
        sv = sharded3d.shard_state3d(st, mesh, halo=3)
        k = sharded3d._prepare(sv, 3)
        sharded3d._exchange(sv, sv.u_blocks, k)
        view, halo = sv.view(k), sv.halos(k)
        block, centre = [], []
        for idx in mesh.local:
            u = sv.u_blocks[idx][view]
            _, d, first = hopper_shard3d.sweep_k_local3d(
                u, sv.frozen_blocks[idx][view], sv.par0(idx, k), t0 + 20, k, halo=halo, u1=True)
            c = tuple(slice(h, n - h) for n, h in zip(u.shape, halo))
            block.append(float(d))
            centre.append(float((first - u)[c].abs().max()))
        assert max(block) == max(centre) > 0
        assert max(block) == float(core.update_n(st, 1).delta)


# -- the plain per-shard version and the wrapper ----------------------------------------------

@pytest.mark.parametrize("k,ns,z_cut", [(4, 4, False), (4, 2, True), (3, 1, True), (2, 2, False)])
def test_plain_per_shard_version_matches_epic_tpus(k, ns, z_cut):
    """sweep_k_local3d against epic_tpu's _sweep_k_local on the same
    extended blocks, at odd and even origins, with ns <= k."""
    rng = np.random.default_rng(k * 10 + ns)
    de, he, we = (7 + 2 * k if z_cut else 9), 8 + 2 * k, 11 + 2 * k
    u = np.where(rng.random((de, he, we)) < 0.1, 0.0,
                 -rng.random((de, he, we)) * 30).astype(np.float32)
    frozen = rng.random((de, he, we)) < 0.2
    if not z_cut:
        frozen[0] = frozen[-1] = True      # an uncut axis ends in the volume's frozen shell
    halo = (k if z_cut else 0, k, k)
    for par0 in (0, 1):
        for t0 in (4, 7):
            parity = ((par0 + np.arange(de)[:, None, None] + np.arange(he)[None, :, None]
                       + np.arange(we)[None, None, :]) % 2).astype(np.int32)
            j_u, j_d = jsharded3d._sweep_k_local(jnp.asarray(u), jnp.asarray(frozen),
                                                 jnp.asarray(parity), jnp.int32(t0), ns, z_cut)
            t_u, t_d, first = hopper_shard3d.sweep_k_local3d(
                torch.from_numpy(u), torch.from_numpy(frozen), par0, t0, ns, halo=halo, u1=True)
            _close(t_u, j_u)
            _close(t_d, j_d, DELTA)
            one, one_d, _ = hopper_shard3d.sweep_k_local3d(
                torch.from_numpy(u), torch.from_numpy(frozen), par0, t0, 1, halo=halo)
            assert torch.equal(first, one) and torch.equal(one_d, t_d)
            # The delta is sweep 0's over the whole block.
            assert torch.equal(t_d, (one - torch.from_numpy(u)).abs().max())


def test_per_shard_wrapper_runs_plain_on_the_cpu():
    """hopper_shard3d.chunk on CPU tensors: the plain version, in place on
    the block (and into u1's centre); the kernel's launch count stays."""
    rng = np.random.default_rng(1)
    halo, shape = (2, 3, 3), (9, 12, 14)
    u0 = torch.from_numpy(-rng.random(shape).astype(np.float32) * 20)
    frozen = torch.from_numpy(rng.random(shape) < 0.2)
    u, u1 = u0.clone(), torch.full_like(u0, 7.0)
    launches = hopper_shard3d.launches["epic_shard3d_chunk"]
    calls = hopper_shard3d.calls["sweep_k_local3d"]
    d = hopper_shard3d.chunk(u, frozen, halo=halo, par0=1, iteration=torch.tensor(2), t_off=3,
                             ns=2, u1=u1, want_delta=True)
    ref, ref_d, ref_u1 = hopper_shard3d.sweep_k_local3d(u0, frozen, 1, 5, 2, halo=halo, u1=True)
    c = (slice(2, 7), slice(3, 9), slice(3, 11))
    assert torch.equal(u, ref) and torch.equal(u1[c], ref_u1[c]) and torch.equal(d, ref_d)
    assert (u1[:2] == 7.0).all() and (u1[:, :, :3] == 7.0).all()
    assert hopper_shard3d.launches["epic_shard3d_chunk"] == launches
    assert hopper_shard3d.calls["sweep_k_local3d"] == calls + 2
    with pytest.raises(ValueError, match="1..2 sweeps"):
        hopper_shard3d.chunk(u, frozen, halo=halo, par0=0, iteration=0, ns=3)
    assert hopper_shard3d.chunk(u, frozen, halo=(0, 0, 0), par0=0, iteration=0, ns=9) is None


# -- the port against epic_tpu ----------------------------------------------------------------

@pytest.mark.parametrize("kernel,shape", [("xla", (2, 4)), ("pallas_interpret", (2, 4)),
                                          ("pallas_banded_interpret", (2, 4)),
                                          ("xla", (8, 1, 1)), ("pallas_interpret", (2, 2, 2))])
def test_update_n_matches_epic_tpu(kernel, shape):
    """epic_tpu's generic 3D route (XLA, K18, K19 in interpret mode) against
    the port's: 11 sweeps in chunks of 4 (a remainder chunk), from both
    parities."""
    for t0 in (0, 1):
        jst = dataclasses.replace(_jvolume(12, 18, 28, seed=31), iteration=jnp.int32(t0))
        theirs = jsharded3d.update_n(jst, 11, _jmesh(shape), chunk_depth=4, kernel=kernel)
        ours = sharded3d.update_n(_volume(12, 18, 28, seed=31, t0=t0), 11, _mesh(shape),
                                  chunk_depth=4, kernel=kernel)
        _close_state(ours, theirs)


@pytest.mark.parametrize("shape,kernel", [((2, 4), "xla"), ((4, 2, 1), "xla"),
                                          ((2, 4), "pallas_banded_interpret")])
def test_solve_matches_epic_tpu(shape, kernel):
    jst = _jvolume(10, 18, 22, seed=41, density=0.06)
    theirs = jsharded3d.solve(jst, _jmesh(shape), stagger=10, kernel=kernel)
    ours = sharded3d.solve(_volume(10, 18, 22, seed=41, density=0.06), _mesh(shape), stagger=10)
    assert bool(theirs.converged)
    _close_state(ours, theirs)


def test_resident3d_matches_epic_tpu():
    """K20 (resident3d, interpret mode) on its smallest aligned shards (8 x
    128 planes on a 2 x 1 mesh): ticks from both parities with remainder
    chunks (one compile: the iteration is traced), against the port's
    resident3d. Its solve is held to core above."""
    shape = (2, 1)
    for t0 in (0, 1):
        jst = dataclasses.replace(_jvolume(6, 16, 128, seed=3), iteration=jnp.int32(t0))
        theirs = jresident3d.update_n(jst, 5, _jmesh(shape))
        ours = resident3d.update_n(_volume(6, 16, 128, seed=3, t0=t0), 5, _mesh(shape))
        _close_state(ours, theirs)


def test_resident_z_matches_epic_tpu():
    """K21 (resident_z, interpret mode) on a z-only mesh of 8 (2-plane
    shards): a tick, and a solve against the port's solve and segments."""
    mesh, jmesh = _mesh((8, 1, 1)), _jmesh((8, 1, 1))
    jst = _jvolume(16, 12, 128, seed=6)
    _close_state(resident_z.update_n(_volume(16, 12, 128, seed=6), 5, mesh),
                 jresident_z.update_n(jst, 5, jmesh))
    jst = _jvolume(16, 12, 128, seed=5, density=0.06)
    theirs = jresident_z.solve(jst, jmesh, stagger=10)
    assert bool(theirs.converged)
    for seg in (None, 37):
        st = _volume(16, 12, 128, seed=5, density=0.06)
        ours = (resident_z.solve(st, mesh, stagger=10) if seg is None
                else resident_z.solve_segments(st, mesh, stagger=10, segment_iterations=seg))
        _close_state(ours, theirs)


def test_state_round_trips_between_packages():
    """A reference ShardedVolume's gathered state, carried across with
    grid.state_to_numpy/state_from_numpy, shards and gathers back to the
    same bits."""
    jmesh = _jmesh((2, 4))
    jsv = jsharded3d.update_n_resident3d(jsharded3d.shard_state3d(_jvolume(7, 21, 37, seed=2),
                                                                  jmesh), 7, jmesh, kernel="xla")
    arrays = TG.state_to_numpy(jsharded3d.unshard3d(jsv))
    st = TG.state_from_numpy(arrays, device="cpu")
    back = TG.state_to_numpy(sharded3d.unshard3d(sharded3d.shard_state3d(st, _mesh((2, 4)))))
    for key in ("u", "locked", "iteration", "delta", "epsilon"):
        np.testing.assert_array_equal(back[key], arrays[key], err_msg=key)
    st2 = TG.state_from_numpy(back, device="cpu")
    again = sharded3d.unshard3d(sharded3d.shard_state3d(st2, _mesh((2, 2, 2))))
    assert torch.equal(again.u, st2.u) and torch.equal(again.locked, st2.locked)
