"""The port's 2D mesh solver (epic_tpu_torch.parallel) on a CPU mesh: against
the port's own core bit for bit, and against epic_tpu.parallel.sharded on
the conftest's virtual 8-device mesh (XLA per-shard path, and the Pallas
per-shard kernels K14/K15 in interpret mode, as tests/test_sharded.py runs
them).

Tolerances across the packages follow tests/test_torch_solver.py: fields
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
from jax.sharding import NamedSharding, PartitionSpec as P

import epic_tpu
from epic_tpu import maps
from epic_tpu.parallel import make_mesh as jmake_mesh
from epic_tpu.parallel import sharded as jsharded
import epic_tpu_torch as T
from epic_tpu_torch import constants as C
from epic_tpu_torch import grid as TG
from epic_tpu_torch.parallel import hopper_shard2d, make_mesh, multihost, sharded
from epic_tpu_torch.solver import core, hopper_tile2d

FIELD = dict(rtol=2e-6, atol=1e-3)
DELTA = dict(rtol=1e-5, atol=1e-5)
CPU = torch.device("cpu")
MESHES = [(2, 4), (8, 1), (1, 1)]


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


def _states(img, eps=1e-2, t0=0):
    """The same grid as an epic_tpu and an epic_tpu_torch state."""
    j = dataclasses.replace(epic_tpu.from_occupancy_image(img, epsilon=eps),
                            iteration=jnp.int32(t0))
    t = dataclasses.replace(TG.from_occupancy_image(img, eps, device="cpu"),
                            iteration=torch.tensor(t0, dtype=torch.int32))
    return j, t


def _same(a, b):
    """Two port states: the same bits."""
    assert torch.equal(a.u, b.u)
    assert torch.equal(a.delta, b.delta)
    assert int(a.iteration) == int(b.iteration)
    assert bool(a.converged) == bool(b.converged)


def _close(ours, theirs, tol=FIELD):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), **tol)


# -- the mesh ----------------------------------------------------------------------------

def test_make_mesh_shapes_and_no_silent_cpu():
    m = make_mesh(devices=[CPU] * 8)
    assert (m.shape["my"], m.shape["mx"]) == (2, 4) and m.devices.size == 8
    assert make_mesh(devices=[CPU] * 6).shape == {"my": 2, "mx": 3}
    assert make_mesh((8, 1), devices=[CPU] * 8).local == [(i, 0) for i in range(8)]
    with pytest.raises(ValueError, match="needs 6 shards"):
        make_mesh((2, 3), devices=[CPU] * 8)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_padding_and_frozen_layout():
    img = maps.open_room(35, 53)
    _, st = _states(img)
    mesh = _mesh()
    assert sharded.padded_shape((35, 53), mesh) == (36, 56)
    sh = sharded.shard_state(st, mesh)
    assert (sh.h_loc, sh.w_loc, sh.halo) == (18, 14, 14)
    u, frozen = sh.u, sh.frozen
    assert u.shape == (36, 56) and frozen.shape == (36, 56)
    assert (u[35:, :] == C.LOG_SPACE_OBSTACLE).all() and frozen[35:, :].all()
    assert (u[:, 53:] == C.LOG_SPACE_OBSTACLE).all() and frozen[:, 53:].all()
    assert frozen[0].all() and frozen[34].all() and frozen[:35, 0].all() and frozen[:35, 52].all()
    np.testing.assert_array_equal(frozen[1:34, 1:52].numpy(), st.locked[1:34, 1:52].numpy())


# -- the port against its own core, bit for bit --------------------------------------------

@pytest.mark.parametrize("depth", [1, 4, 16, 64])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_update_n_equals_core_bit_for_bit(shape, depth):
    img = maps.random_obstacles(40, 48, density=0.15, seed=3)
    mesh = _mesh(shape)
    for t0 in (0, 1):
        _, st = _states(img, t0=t0)
        for n in (1, 5, 37):
            _same(sharded.update_n(st, n, mesh, chunk_depth=depth), core.update_n(st, n))


@pytest.mark.parametrize("depth", [1, 4, 16, 64])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_solve_equals_core_bit_for_bit(shape, depth):
    img = maps.random_obstacles(24, 40, density=0.1, seed=5)
    _, st = _states(img, eps=1e-1)
    mesh = _mesh(shape)
    for stagger, cap in ((10, 1_000_000), (7, 1_000_000), (10, 95), (3, 0)):
        _same(sharded.solve(st, mesh, stagger, cap, chunk_depth=depth),
              core.solve(st, stagger, cap))


def test_nonaligned_grid_padding_does_not_leak():
    img = maps.open_room(35, 53)
    _, st = _states(img)
    out = sharded.update_n(st, 4, _mesh())
    assert out.u.shape == (35, 53)
    _same(out, core.update_n(st, 4))


def test_1d_mesh_with_five_row_shards():
    img = maps.open_room(40, 40)
    _, st = _states(img)
    mesh = _mesh((8, 1))
    sh = sharded.shard_state(st, mesh)
    assert (sh.h_loc, sh.w_loc, sh.halo) == (5, 40, 5)
    _same(sharded.update_n(st, 23, mesh), core.update_n(st, 23))


def test_resident_warm_loop_with_edits():
    """Shard once, interleave ticks and SetCells edits (a halo regrown by a
    deeper chunk on the way): the single-device warm loop's bits."""
    img = maps.random_obstacles(40, 56, density=0.15, seed=4)
    _, st = _states(img)
    mesh = _mesh()
    sh = sharded.shard_state(st, mesh, halo=2)
    edits = ([(10, 11), (20, 7), (10, 11), (0, 5)],
             [C.CELL_TYPE_OBSTACLE, C.CELL_TYPE_GOAL, C.CELL_TYPE_FREE, C.CELL_TYPE_GOAL])
    sharded.update_n_resident(sh, 9, mesh, chunk_depth=4)
    ref = core.update_n(st, 9)
    sharded.set_cells_resident(sh, *edits)
    ref = TG.set_cells(ref, *edits)
    sharded.update_n_resident(sh, 13, mesh, chunk_depth=8)
    assert sh.halo == 8     # regrown to min(8, h_loc, w_loc)
    ref = core.update_n(ref, 13)
    back = sharded.unshard(sh)
    assert torch.equal(back.u, ref.u) and int(back.iteration) == int(ref.iteration)
    np.testing.assert_array_equal(back.locked[1:-1, 1:-1].numpy(), ref.locked[1:-1, 1:-1].numpy())


def test_set_cells_resident_on_and_off_the_ring():
    img = maps.open_room(24, 32)
    _, st = _states(img)
    sh = sharded.shard_state(st, _mesh())
    sharded.set_cells_resident(sh, [(0, 5), (31, 9), (7, 0), (5, 6), (9, 8)],
                               [C.CELL_TYPE_GOAL, C.CELL_TYPE_FREE, C.CELL_TYPE_FREE,
                                C.CELL_TYPE_GOAL, C.CELL_TYPE_FREE])
    back = sharded.unshard(sh)
    # On the ring: values written, cells stay frozen (locked when gathered).
    assert float(back.u[5, 0]) == 0.0 and bool(back.locked[5, 0])
    assert float(back.u[9, 31]) == -1e6 and bool(back.locked[9, 31])
    assert bool(back.locked[0, 7])
    # Off the ring: grid.set_cells's values and flags.
    assert float(back.u[6, 5]) == 0.0 and bool(back.locked[6, 5])
    assert float(back.u[8, 9]) == -1e6 and not bool(back.locked[8, 9])
    before = sh.u.clone()
    sharded.set_cells_resident(sh, [(999, 2), (3, -1)], [1, 1])    # skipped
    assert torch.equal(sh.u, before)
    assert sharded.read_cell(sh, 5, 6) == (True, 0.0)


def test_unknown_and_unported_kernels_raise():
    """Unknown names raise; the resident route's names (K16/K17) run and give
    core's bits, and segments run on it and raise on the per-shard route."""
    img = maps.random_obstacles(48, 64, density=0.1, seed=7)
    _, st = _states(img)
    mesh = _mesh()
    sh = sharded.shard_state(st, mesh)
    with pytest.raises(ValueError, match="unknown sharded kernel"):
        sharded.update_n_resident(sh, 1, mesh, kernel="bogus")
    with pytest.raises(ValueError, match="unknown sharded kernel"):
        sharded.update_n(st, 1, mesh, kernel="bogus")
    for kernel in ("resident", "resident_interpret"):
        _same(sharded.update_n(st, 3, mesh, kernel=kernel), core.update_n(st, 3))
        out, conv = sharded.solve_resident(sharded.shard_state(st, mesh), mesh, 10, 60,
                                           kernel=kernel)
        ref = core.solve(st, 10, 60)
        assert torch.equal(sharded.unshard(out).u, ref.u) and bool(conv) == bool(ref.converged)
        assert int(out.iteration) == int(ref.iteration)
    _same(sharded.solve(st, mesh, 10, 60, segment_iterations=25), core.solve(st, 10, 60))
    with pytest.raises(ValueError, match="resident route"):
        sharded.solve(st, mesh, 10, 60, kernel="xla", segment_iterations=25)
    # The CUDA entry's names on a CPU mesh raise; the plain version's names run it.
    for kernel in ("pallas", "pallas_banded"):
        with pytest.raises(ValueError, match="CUDA entry"):
            sharded.update_n(st, 1, mesh, kernel=kernel)
    for kernel in ("xla", "pallas_interpret", "pallas_banded_interpret"):
        _same(sharded.update_n(st, 3, mesh, kernel=kernel), core.update_n(st, 3))


def test_state_round_trips_between_packages(jmesh8):
    """A reference ShardedGrid's gathered state, carried across with
    grid.state_to_numpy/state_from_numpy, shards and gathers back to the
    same bits."""
    img = maps.random_obstacles(35, 53, density=0.15, seed=2)
    jst, _ = _states(img)
    jsh = jsharded.update_n_resident(jsharded.shard_state(jst, jmesh8), 7, jmesh8, kernel="xla")
    arrays = TG.state_to_numpy(jsharded.unshard(jsh))
    st = TG.state_from_numpy(arrays, device="cpu")
    sh = sharded.shard_state(st, _mesh())
    back = TG.state_to_numpy(sharded.unshard(sh))
    for key in ("u", "locked", "iteration", "delta", "epsilon"):
        np.testing.assert_array_equal(back[key], arrays[key], err_msg=key)
    # And the port's own layout round trip.
    st2 = TG.state_from_numpy(back, device="cpu")
    again = sharded.unshard(sharded.shard_state(st2, _mesh((8, 1))))
    assert torch.equal(again.u, st2.u) and torch.equal(again.locked, st2.locked)


def test_reset_and_occupancy_on_resident_blocks():
    img = maps.random_obstacles(30, 40, density=0.15, seed=6)
    _, st = _states(img)
    mesh = _mesh()
    sh = sharded.update_n_resident(sharded.shard_state(st, mesh), 20, mesh)
    ref = TG.reset_free_cells(core.update_n(st, 20))
    sharded.reset_free_cells_resident(sh)
    back = sharded.unshard(sh)
    assert torch.equal(back.u, ref.u) and int(back.iteration) == 0
    assert float(back.delta) == float(ref.delta)
    occ = np.zeros((30, 40), np.int8)
    occ[5:9, 7:20] = 100
    occ[20, :] = C.OCCUPANCY_NO_CHANGE
    assert sharded.occupancy_resident(sh, occ)
    assert not sharded.occupancy_resident(sh, np.full((30, 40), C.OCCUPANCY_NO_CHANGE, np.int8))


# -- the port against epic_tpu ---------------------------------------------------------------

def test_update_n_matches_epic_tpu(jmesh8):
    img = maps.random_obstacles(48, 64, density=0.15, seed=3)
    for t0 in (0, 1):
        jst, st = _states(img, t0=t0)
        ours = sharded.update_n(st, 21, _mesh(), chunk_depth=8)
        theirs = jsharded.update_n(jst, 21, jmesh8, chunk_depth=8, kernel="xla")
        _close(ours.u, theirs.u)
        _close(ours.delta, theirs.delta, DELTA)
        assert int(ours.iteration) == int(theirs.iteration)


def test_solve_matches_epic_tpu(jmesh8):
    img = maps.random_obstacles(40, 48, density=0.1, seed=5)
    jst, st = _states(img)
    ours = sharded.solve(st, _mesh(), stagger=10)
    theirs = jsharded.solve(jst, jmesh8, stagger=10, kernel="xla")
    assert int(ours.iteration) == int(theirs.iteration)
    assert bool(ours.converged) and bool(theirs.converged)
    _close(ours.u, theirs.u)
    _close(ours.delta, theirs.delta, DELTA)


@pytest.mark.parametrize("kernel,shape", [("pallas_interpret", (48, 64)),
                                          ("pallas_banded_interpret", (48, 64)),
                                          ("pallas_banded_interpret", (70, 53))])
def test_update_n_sharded_matches_epic_tpus_pallas_kernels(jmesh8, kernel, shape):
    """K14 and K15, run as tests/test_sharded.py runs them (interpret mode),
    against the port's plain per-shard version: 21 sweeps in chunks of 8 (a
    remainder chunk shallower than the exchange)."""
    img = maps.random_obstacles(*shape, density=0.15, seed=11)
    jst, st = _states(img)
    u, frozen = jsharded._pad_for_mesh(jst, jmesh8)
    spec = NamedSharding(jmesh8, P("my", "mx"))
    out, delta = jsharded._update_n_sharded(jax.device_put(u, spec), jax.device_put(frozen, spec),
                                            jst.iteration, jmesh8, 21, 8, kernel)
    sh = sharded.shard_state(st, _mesh())
    ours = sharded._update_n_sharded(sh, 21, 8, "xla")
    _close(sh.u, out)
    _close(ours, delta, DELTA)


@pytest.mark.parametrize("k,ns", [(4, 4), (4, 2), (8, 1), (3, 3)])
def test_plain_per_shard_version_matches_epic_tpus(k, ns):
    """sweep_k_local against epic_tpu's _sweep_k_local on the same extended
    blocks, at odd and even origins, with ns <= k."""
    rng = np.random.default_rng(k * 10 + ns)
    he, we = 13 + 2 * k, 17 + 2 * k
    u = np.where(rng.random((he, we)) < 0.1, 0.0, -rng.random((he, we)) * 30).astype(np.float32)
    frozen = rng.random((he, we)) < 0.2
    for par0 in (0, 1):
        for t0 in (4, 7):
            parity = ((par0 + np.arange(he)[:, None] + np.arange(we)[None, :]) % 2).astype(np.int32)
            j_u, j_d = jsharded._sweep_k_local(jnp.asarray(u), jnp.asarray(frozen),
                                               jnp.asarray(parity), jnp.int32(t0), ns, k)
            t_u, t_d, first = hopper_shard2d.sweep_k_local(
                torch.from_numpy(u), torch.from_numpy(frozen), par0, t0, ns, u1=True)
            _close(t_u, j_u)
            _close(t_d, j_d, DELTA)
            one, _, _ = hopper_shard2d.sweep_k_local(torch.from_numpy(u), torch.from_numpy(frozen),
                                                     par0, t0, 1)
            assert torch.equal(first, one)


def test_per_shard_wrapper_runs_plain_on_the_cpu():
    """hopper_shard2d.chunk on CPU tensors: the plain version, in place into
    dst's (and u1's) centre; the kernel's launch count stays."""
    rng = np.random.default_rng(1)
    k, he, we = 3, 15, 20
    u = torch.from_numpy(-rng.random((he, we)).astype(np.float32) * 20)
    frozen = torch.from_numpy(rng.random((he, we)) < 0.2)
    dst = torch.full_like(u, 7.0)
    u1 = torch.full_like(u, 7.0)
    launches = hopper_shard2d.launches["epic_shard2d_chunk"]
    calls = hopper_shard2d.calls["sweep_k_local"]
    d = hopper_shard2d.chunk(u, dst, frozen, k=k, par0=1, iteration=torch.tensor(2), t_off=3,
                             ns=3, u1=u1, want_delta=True)
    ref, ref_d, ref_u1 = hopper_shard2d.sweep_k_local(u, frozen, 1, 5, 3, u1=True)
    c = (slice(k, he - k), slice(k, we - k))
    assert torch.equal(dst[c], ref[c]) and torch.equal(u1[c], ref_u1[c]) and torch.equal(d, ref_d)
    assert (dst[:k] == 7.0).all() and (u1[:, :k] == 7.0).all()
    assert hopper_shard2d.launches["epic_shard2d_chunk"] == launches
    assert hopper_shard2d.calls["sweep_k_local"] == calls + 2
    with pytest.raises(ValueError, match="1..k=3"):
        hopper_shard2d.chunk(u, dst, frozen, k=3, par0=0, iteration=0, ns=4)
    # The kernel's 96 x 160 tile at 4 B and a bit a cell: 55 halo cells fit
    # an H100's 227 KB, 56 do not.
    assert hopper_shard2d.depth_limit(232448) == 55
    assert hopper_tile2d.smem_bytes(55) <= 232448 < hopper_tile2d.smem_bytes(56)


def test_multihost_single_process_is_a_no_op():
    multihost.initialize()
    assert not multihost.is_multi_process()
    assert multihost.world() == (1, 0)
    assert not _mesh().multi_process
