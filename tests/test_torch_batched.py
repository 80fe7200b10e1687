"""epic_tpu_torch's batched scenario solves against epic_tpu: the plain
``solver.batched`` against ``epic_tpu.solver.batched`` (XLA, vmap over
lanes), and ``solver.hopper_batched`` (which on a CPU tensor runs the plain
version) against ``epic_tpu.solver.pallas_batched``, whose two kernels
(``_block_kernel``, ``_block_kernel_gated``) run in interpret mode as the
JAX package's own CPU tests run them. The collage is compared lane by lane
through ``pallas_batched.unstack``.

Tolerances are those of tests/test_batched.py and tests/test_pallas_batched.py:
fields rtol=2e-6 with atol=1e-4 (chunks) or atol=1e-3 (solves); iteration
counts equal; deltas rtol=1e-5 with atol=1e-6 within the port, and atol=1e-5
across the two packages, as in tests/test_torch_solver.py: torch's and XLA's
CPU exp differ by one ulp on some inputs, and a delta carries a cell's ulp
whole (3.8e-6 near u = -30). On the card the CUDA kernels must give the plain
version's bits exactly: tests/test_torch_cuda.py.
"""

import itertools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epic_tpu
from epic_tpu import maps
from epic_tpu.solver import batched as jbatched
from epic_tpu.solver import pallas_batched
import epic_tpu_torch.solver as TS
from epic_tpu_torch import grid as TG
from epic_tpu_torch.solver import batched, core, hopper_batched
from epic_tpu_torch.solver._sweep_body import lse4

CHUNK = dict(rtol=2e-6, atol=1e-4)
SOLVE = dict(rtol=2e-6, atol=1e-3)
DELTA = dict(rtol=1e-5, atol=1e-6)      # within the port
DELTA_X = dict(rtol=1e-5, atol=1e-5)    # the port against epic_tpu


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once
    (see tests/test_torch_solver.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _goal_batch(h, w, goal_sets, density=0.15, seed=7):
    """The same goal-set batch from both packages, as numpy arrays."""
    img = maps.random_obstacles(h, w, density=density, seed=seed)
    u, locked = jbatched.batch_from_goal_sets(img, goal_sets)
    return img, np.asarray(u), np.asarray(locked)


def _port(u, locked):
    return batched.batch_from_numpy(u, locked, device="cpu")


def _goal_xy(goal_sets):
    g = max(len(s) for s in goal_sets)
    out = np.full((len(goal_sets), g, 2), -1, np.int32)
    for i, s in enumerate(goal_sets):
        for j, (x, y) in enumerate(s):
            out[i, j] = (x, y)
    return out


def _assert_solves_match(ours, theirs, field=SOLVE):
    u, it, dl, cv = (np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x) for x in ours)
    u_j, it_j, dl_j, cv_j = (np.asarray(x) for x in theirs)
    np.testing.assert_array_equal(it, it_j)
    np.testing.assert_array_equal(cv, cv_j)
    np.testing.assert_allclose(dl, dl_j, **DELTA_X)
    np.testing.assert_allclose(u, u_j, **field)
    assert it.dtype == np.int32 and dl.dtype == np.float32 and cv.dtype == np.bool_


def _assert_lanes_match_solo(u_in, locked_in, out, eps, stagger, field=SOLVE):
    """Each lane against the port's own solo core.solve."""
    u_out, iters, deltas, conv = out
    for lane in range(u_in.shape[0]):
        solo = core.solve(TG.make_state(u_in[lane], locked_in[lane], eps, device="cpu"), stagger)
        assert int(iters[lane]) == int(solo.iteration), lane
        assert bool(conv[lane]) == bool(solo.converged), lane
        np.testing.assert_allclose(u_out[lane].numpy(), solo.u.numpy(), **field)
        np.testing.assert_allclose(float(deltas[lane]), float(solo.delta), **DELTA)


@pytest.mark.parametrize("t0", [0, 7])
@pytest.mark.parametrize("shape,goal_sets", [
    ((16, 20), [[(4, 4)], [(15, 10)]]),
    ((24, 32), [[(5, 5)], [(25, 18)], [(5, 5), (25, 18)]]),
])
def test_update_n_batch_matches_jax(shape, goal_sets, t0):
    """An 8-sweep chunk from an even and an odd start iteration, through the
    plain version, its roll formulation and the kernel wrapper, against
    epic_tpu's vmapped chunk. (epic_tpu's rolled twin, update_n_batch_rolled,
    raises AttributeError on every call: it reads core._LOG2N_2D, which
    moved to _sweep_body.LOG2N_2D. The port's is held to the vmapped one.)"""
    _, u, locked = _goal_batch(*shape, goal_sets, density=0.1, seed=2)
    ref_u, ref_d = jbatched.update_n_batch(jnp.asarray(u), jnp.asarray(locked), jnp.int32(t0), 8)
    tu, tl = _port(u, locked)
    out_u, out_d = batched.update_n_batch(tu, tl, t0, 8)
    rolled_u, rolled_d = batched.update_n_batch_rolled(tu, batched._frozen_batch(tl), t0, 8)
    hop_u, hop_d = hopper_batched.update_n_batch(tu.clone(), tl, torch.tensor(t0, dtype=torch.int32), 8)
    np.testing.assert_allclose(out_u.numpy(), np.asarray(ref_u), **CHUNK)
    np.testing.assert_allclose(out_d.numpy(), np.asarray(ref_d), **DELTA_X)
    np.testing.assert_array_equal(batched._frozen_batch(tl).numpy(),
                                  np.asarray(jbatched._frozen_batch(jnp.asarray(locked))))
    # Within the port the three routes run the same ops.
    np.testing.assert_array_equal(rolled_u.numpy(), out_u.numpy())
    np.testing.assert_array_equal(rolled_d.numpy(), out_d.numpy())
    np.testing.assert_array_equal(hop_u.numpy(), out_u.numpy())
    np.testing.assert_array_equal(hop_d.numpy(), out_d.numpy())
    assert out_d.shape == (len(goal_sets),)
    np.testing.assert_array_equal(tu.numpy(), u)   # the plain version leaves its input intact


@pytest.mark.parametrize("t0", [0, 1])
def test_batch_sweep_is_the_2d_sweep_in_every_lane(t0):
    """A [B, H, W] batch is B 2D grids, not a volume: one sweep updates the
    (y + x) % 2 != t % 2 class of each lane, equal to core.sweep lane by
    lane; core.sweep on the same tensor (rank 3) would update another class."""
    rng = np.random.default_rng(t0)
    locked = rng.random((3, 9, 12)) < 0.2
    u = np.where(locked, -1e6, rng.uniform(-30, -1, locked.shape)).astype(np.float32)
    tu, tl = _port(u, locked)
    out, delta = batched.update_n_batch(tu, tl, t0, 1)
    for lane in range(3):
        solo, d = core.sweep(tu[lane], tl[lane], t0)
        np.testing.assert_allclose(out[lane].numpy(), solo.numpy(), rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(delta[lane]), float(d), **DELTA)
        yy, xx = np.nonzero(out[lane].numpy() != u[lane])
        assert len(yy) and np.all((yy + xx) % 2 != t0 % 2)
    vol, _ = core.sweep(tu, tl, t0)
    assert not np.array_equal(vol.numpy(), out.numpy())


def test_solve_batch_matches_jax_and_solo():
    """tests/test_batched.py's four lanes: the plain lockstep solve against
    epic_tpu's, and each lane against a solo solve."""
    goal_sets = [[(5, 5)], [(25, 18)], [(5, 5), (25, 18)], [(16, 12)]]
    _, u, locked = _goal_batch(24, 32, goal_sets)
    theirs = jbatched.solve_batch(jnp.asarray(u), jnp.asarray(locked), epsilon=1e-2, stagger=10)
    ours = batched.solve_batch(*_port(u, locked), epsilon=1e-2, stagger=10)
    assert bool(ours[3].all())
    _assert_solves_match(ours, theirs)
    _assert_lanes_match_solo(u, locked, ours, 1e-2, 10)


def test_early_retiring_lane_stays_flat():
    """A lane without goals retires at its first check past max(H, W) and
    its field stays exactly -1e6; the other lane keeps relaxing."""
    base = maps.open_room(24, 24)
    base[base == 255] = 128
    u, locked = jbatched.batch_from_goal_sets(base, [[], [(12, 12)]])
    u, locked = np.asarray(u), np.asarray(locked)
    theirs = jbatched.solve_batch(jnp.asarray(u), jnp.asarray(locked), epsilon=1e-3, stagger=10)
    ours = batched.solve_batch(*_port(u, locked), epsilon=1e-3, stagger=10)
    _assert_solves_match(ours, theirs)
    iters = ours[1].numpy()
    assert bool(ours[3].all()) and iters[0] < iters[1]
    assert np.all(ours[0][0, 1:-1, 1:-1].numpy() == np.float32(-1e6))


def test_per_lane_epsilon():
    """epsilon as one value a lane, as epic_tpu's solve_batch takes it."""
    goal_sets = [[(5, 5)], [(25, 18)], [(5, 5), (25, 18)], [(16, 12)]]
    _, u, locked = _goal_batch(24, 32, goal_sets)
    eps = np.array([1e-2, 1e-3, 5e-2, 2e-3], np.float32)
    theirs = jbatched.solve_batch(jnp.asarray(u), jnp.asarray(locked), epsilon=jnp.asarray(eps),
                                  stagger=10)
    ours = batched.solve_batch(*_port(u, locked), epsilon=torch.from_numpy(eps), stagger=10)
    _assert_solves_match(ours, theirs)
    assert len(set(ours[1].tolist())) > 1


@pytest.mark.parametrize("stagger,cap", [(1, 400), (10, 95), (100, 1_000_000)])
def test_solve_batch_protocol_edges(stagger, cap):
    """Stagger 1, a cap that is not a whole number of cycles (a cycle once
    begun runs to its end), and the default stagger."""
    goal_sets = [[(4, 4)], [(15, 10)], []]
    _, u, locked = _goal_batch(16, 20, goal_sets, density=0.1, seed=2)
    theirs = jbatched.solve_batch(jnp.asarray(u), jnp.asarray(locked), epsilon=1e-2,
                                  stagger=stagger, max_iterations=cap)
    ours = hopper_batched.solve_batch(*_port(u, locked), 1e-2, stagger, cap)
    _assert_solves_match(ours, theirs)
    device = hopper_batched.solve_batch_device(*_port(u, locked), 1e-2, stagger, cap)
    for a, b in zip(ours, device):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_odd_height_batch():
    """Any height works in the port (the TPU collage needs an even one)."""
    goal_sets = [[(5, 5)], [(20, 14)]]
    _, u, locked = _goal_batch(23, 27, goal_sets)
    with pytest.raises(ValueError):
        pallas_batched.pad_batch(u, locked)
    theirs = jbatched.solve_batch(jnp.asarray(u), jnp.asarray(locked), epsilon=1e-2, stagger=10)
    ours = hopper_batched.solve_batch_device(*_port(u, locked), 1e-2, 10)
    assert bool(ours[3].all())
    _assert_solves_match(ours, theirs)


def test_chunk_matches_k12():
    """hopper_batched.update_n_batch against sweep_chunk_batch (K12 in
    interpret mode), lane by lane through unstack. The per-lane delta equals
    the maximum over each collage block's lanes."""
    _, u, locked = _goal_batch(24, 32, [[(5, 5)], [(25, 18)], [(5, 5), (25, 18)]])
    u_c, frozen, meta = pallas_batched.pad_batch(u, locked)
    out_c, block_delta = pallas_batched.sweep_chunk_batch(u_c, frozen, jnp.int32(0), 8, meta,
                                                          interpret=True)
    ours_u, ours_d = hopper_batched.update_n_batch(*_port(u, locked), 0, 8)
    np.testing.assert_allclose(ours_u.numpy(), pallas_batched.unstack(out_c, meta), **CHUNK)
    per_group = meta["gpr"] * meta["gpc"]
    for blk, d in enumerate(np.asarray(block_delta)):
        lanes = ours_d[blk * per_group:(blk + 1) * per_group]
        np.testing.assert_allclose(float(lanes.max()), float(d), **DELTA_X)


@pytest.mark.parametrize("stagger", [11, 64])
def test_solves_match_pallas(stagger):
    """The host-driven and the one-launch solve against pallas_batched's
    (K12 and K13 in interpret mode), and each lane against a solo solve."""
    goal_sets = [[(5, 5)], [(25, 18)], [(5, 5), (25, 18)]]
    _, u, locked = _goal_batch(24, 32, goal_sets)
    host = hopper_batched.solve_batch(*_port(u, locked), 1e-2, stagger)
    device = hopper_batched.solve_batch_device(*_port(u, locked), 1e-2, stagger)
    _assert_solves_match(host, pallas_batched.solve_batch(
        u, locked, epsilon=1e-2, stagger=stagger, interpret=True))
    _assert_solves_match(device, pallas_batched.solve_batch_device(
        u, locked, epsilon=1e-2, stagger=stagger, interpret=True))
    for a, b in zip(host, device):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert bool(device[3].all())
    _assert_lanes_match_solo(u, locked, device, 1e-2, stagger, field=CHUNK)


def _lanes_128(lanes=3, seed=11):
    """A few 128^2 lanes (BASELINE config 3's lane size, the resident
    route's on the card): 10% obstacles, the ring locked, one goal a lane,
    lane 0 without one."""
    rng = np.random.default_rng(seed)
    u = np.full((lanes, 128, 128), -1e6, np.float32)
    locked = rng.random(u.shape) < 0.1
    locked[:, [0, -1]] = True
    locked[:, :, [0, -1]] = True
    for lane in range(1, lanes):
        gy, gx = rng.integers(1, 127, 2)
        u[lane, gy, gx] = 0.0
        locked[lane, gy, gx] = True
    return u, locked


def test_chunk_matches_k12_at_128():
    """A 100-sweep chunk of 128^2 lanes from an odd start against K12 in
    interpret mode, lane by lane, each collage block's delta the maximum of
    its lanes'."""
    u, locked = _lanes_128()
    u_c, frozen, meta = pallas_batched.pad_batch(u, locked)
    out_c, block_delta = pallas_batched.sweep_chunk_batch(u_c, frozen, jnp.int32(1), 100, meta,
                                                          interpret=True)
    ours_u, ours_d = hopper_batched.update_n_batch(*_port(u, locked), 1, 100)
    np.testing.assert_allclose(ours_u.numpy(), pallas_batched.unstack(out_c, meta), **CHUNK)
    per_group = meta["gpr"] * meta["gpc"]
    for blk, d in enumerate(np.asarray(block_delta)):
        lanes = ours_d[blk * per_group:(blk + 1) * per_group]
        np.testing.assert_allclose(float(lanes.max()), float(d), **DELTA_X)
    assert float(ours_d[0]) == 0.0    # the goalless lane does not move


def test_solves_match_pallas_at_128():
    """The one-launch and the host-driven solve of 128^2 lanes, capped at
    1,000 sweeps, against pallas_batched's (K13 and K12 in interpret mode):
    the goalless lane retires at its first check past 128 sweeps, the
    others where they converge or at the cap."""
    u, locked = _lanes_128()
    device = hopper_batched.solve_batch_device(*_port(u, locked), 1e-2, 100, 1000)
    host = hopper_batched.solve_batch(*_port(u, locked), 1e-2, 100, 1000)
    _assert_solves_match(device, pallas_batched.solve_batch_device(
        u, locked, epsilon=1e-2, stagger=100, max_iterations=1000, interpret=True))
    for a, b in zip(host, device):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert int(device[1][0]) == 201 and bool(device[3][0])


def test_lane_smem_bytes_is_the_resident_layout():
    """The resident route's shared memory for an H x W lane: u of each class
    in H rows of (W + 1) // 2 floats, the frozen bits of each class in H
    rows of words, three delta words. A 128^2 lane leaves room for three
    blocks an SM on an H100 (228 KB an SM, 1 KB of it kept a block)."""
    assert hopper_batched.lane_smem_bytes(128, 128) == 4 * (2 * 128 * 64 + 2 * 128 * 2 + 3)
    assert hopper_batched.lane_smem_bytes(3, 3) == 4 * (2 * 3 * 2 + 2 * 3 * 1 + 3)
    assert hopper_batched.lane_smem_bytes(5, 131) == 4 * (2 * 5 * 66 + 2 * 5 * 3 + 3)
    assert 3 * (hopper_batched.lane_smem_bytes(128, 128) + 1024) <= 228 * 1024
    assert 4 * (hopper_batched.lane_smem_bytes(128, 128) + 1024) > 228 * 1024
    # Odd and even widths of one class row cost the same.
    assert hopper_batched.lane_smem_bytes(64, 127) == hopper_batched.lane_smem_bytes(64, 128)


def test_lane_resident_rule(monkeypatch):
    """lane_resident on a device with an H100's opt-in shared memory a
    block (232,448 bytes): 128^2 and 236^2 resident, 237^2 not, odd sides
    around the boundary, and the rule monotone in H and in W."""
    limit = 232_448
    dev = torch.device("cuda", 0)

    def props(device):
        assert device == dev
        return types.SimpleNamespace(shared_memory_per_block_optin=limit)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)

    def fits(h, w):
        return hopper_batched.lane_resident(h, w, dev)

    assert fits(128, 128) and fits(236, 236) and not fits(237, 237)
    assert fits(235, 237) and fits(237, 235) and not fits(239, 235)
    assert fits(3, 131) and fits(3, 9999) and not fits(3, 40_000)
    assert not fits(0, 128) and not fits(128, 0)
    sides = range(1, 400, 3)
    for h in sides:
        row = [hopper_batched.lane_smem_bytes(h, w) for w in sides]
        assert row == sorted(row)
        ok = [fits(h, w) for w in sides]
        assert ok == sorted(ok, reverse=True)   # once refused, refused for every wider lane
        assert all(fits(h - 1, w) for w in sides if h > 1 and fits(h, w))
    assert hopper_batched.lane_smem_bytes(236, 236) <= limit < hopper_batched.lane_smem_bytes(
        237, 237)


def test_cluster_smem_bytes_is_the_band_layout():
    """The cluster route's shared memory a block: the resident layout of the
    largest band (n // c or n // c + 1 of the n = H - 2 interior rows, the
    longer first) with its two halo rows. A 384^2 lane fits a cluster of 4
    (and of 3) on an H100 (232,448 bytes a block), not one of 2."""
    limit = 232_448
    assert hopper_batched.bands(384, 4) == [(1, 96), (97, 96), (193, 95), (288, 95)]
    assert hopper_batched.cluster_smem_bytes(384, 384, 4) == 4 * (2 * 98 * 192 + 2 * 98 * 6 + 3)
    assert hopper_batched.cluster_smem_bytes(384, 384, 4) == 155_244 <= limit
    assert hopper_batched.cluster_smem_bytes(384, 384, 3) == 4 * (2 * 130 * 192 + 2 * 130 * 6 + 3)
    assert hopper_batched.cluster_smem_bytes(384, 384, 3) <= limit
    assert hopper_batched.cluster_smem_bytes(384, 384, 2) == 305_724 > limit
    # A band of one row keeps three; ranks past the interior keep their two halo rows.
    assert hopper_batched.bands(5, 8) == [(1, 1), (2, 1), (3, 1)] + [(4, 0)] * 5
    assert hopper_batched.cluster_smem_bytes(5, 131, 8) == hopper_batched.lane_smem_bytes(3, 131)
    assert hopper_batched.cluster_smem_bytes(384, 384, 1) == hopper_batched.lane_smem_bytes(384, 384)
    for h in (3, 4, 5, 24, 239, 384, 1001):
        for c in (1, 2, 3, 4, 7, 8, 16):
            cut = hopper_batched.bands(h, c)
            assert len(cut) == c and sum(rows for _, rows in cut) == h - 2
            assert [r0 for r0, _ in cut] == [1 + sum(rows for _, rows in cut[:k]) for k in range(c)]
            assert max(rows for _, rows in cut) == cut[0][1]


@pytest.mark.parametrize("largest", [8, 16])
def test_lane_cluster_rule(monkeypatch, largest):
    """lane_cluster on a device with an H100's opt-in shared memory a block
    (232,448 bytes) and 132 SMs, whose occupancy query admits clusters up to
    ``largest``: 0 wherever lane_resident admits the lane, then the
    smallest of 2, 3, 4, 8 and 16 whose largest band fits, 0 past the
    largest cluster and for a lane whose one row outgrows a block; monotone
    in H and in W. Given the batch's lanes, the widest of those sizes whose
    clusters fill at most 66 SMs, where one fits: 8 lanes of 240^2 to
    640^2 on clusters of 8, 16 lanes of 240^2 and 384^2 on clusters of 4,
    32 of 240^2 on 2, where `tile_probe --batch` measured the widened
    clusters ahead of the tiled route; 16 lanes of 512^2 stay on 8, 32 of
    384^2 on 3, 8 of 900^2 on 16; never 0 where a cluster fits."""
    limit = 232_448
    dev = torch.device("cuda", 0)

    def props(device):
        assert device == dev
        return types.SimpleNamespace(shared_memory_per_block_optin=limit,
                                     multi_processor_count=132)

    monkeypatch.setattr(torch.cuda, "get_device_properties", props)
    monkeypatch.setattr(hopper_batched, "max_cluster", lambda device: largest)

    def c(h, w, lanes=None):
        return hopper_batched.lane_cluster(h, w, dev, lanes)

    assert c(128, 128) == c(236, 236) == c(3, 9999) == 0      # resident
    assert c(237, 237) == 2 and c(239, 235) == 2 and c(332, 332) == 2 and c(333, 333) == 3
    assert c(384, 384) == 3 and c(407, 407) == 3 and c(408, 408) == 4
    assert c(470, 470) == 4 and c(471, 471) == 8 and c(660, 660) == 8   # 5 to 7 are skipped
    if largest == 8:
        assert c(661, 661) == 0
    else:
        assert c(661, 661) == 16 and c(930, 930) == 16 and c(931, 931) == 0
    assert c(5, 60_000) == 0 and c(1, 1000) == c(2, 1000) == c(1000, 2) == 0
    sides = range(3, 1100, 7)
    for h in sides:
        row = [c(h, w) for w in sides]
        col = [c(w, h) for w in sides]
        for seq in (row, col):
            fits = [hopper_batched.lane_resident(*((h, w) if seq is row else (w, h)), dev)
                    for w in sides]
            routed = [k for k, res in zip(seq, fits) if not res]
            past = routed.index(0) if 0 in routed else len(routed)
            assert routed[:past] == sorted(routed[:past])   # larger lanes, larger clusters
            assert not any(routed[past:])                     # once tiled, tiled for larger
            assert all(k <= largest for k in seq)

    # The batch's size: the same cluster, or a wider one for few lanes.
    assert c(236, 236, 1) == 0
    assert c(240, 240, 1) == c(240, 240, 4) == largest
    assert c(240, 240, 8) == 8 and c(240, 240, 16) == 4 and c(240, 240, 17) == 3
    assert c(240, 240, 32) == c(240, 240, 33) == c(240, 240, 34) == c(240, 240, 256) == 2
    assert c(384, 384, 8) == 8 and c(384, 384, 16) == 4
    assert c(384, 384, 22) == c(384, 384, 23) == c(384, 384, 32) == c(384, 384, 256) == 3
    assert c(512, 512, 4) == largest and c(512, 512, 8) == c(640, 640, 8) == 8
    assert c(512, 512, 9) == c(512, 512, 16) == c(640, 640, 16) == 8
    assert c(900, 900, 4) == c(900, 900, 8) == (16 if largest == 16 else 0)
    for h, w, lanes in itertools.product(range(3, 1100, 41), range(3, 1100, 53),
                                         (1, 4, 5, 8, 9, 16, 33, 34, 256)):
        alone = c(h, w)
        wide = [k for k in (2, 3, 4, 8, 16)
                if alone and alone <= k <= largest and 2 * lanes * k <= 132]
        assert c(h, w, lanes) == (wide[-1] if wide else alone)


def _band_model(u, locked, t0, num_steps, c, flip=True):
    """``csrc/batched2d.cu``'s cluster schedule in plain torch: each of the
    ``c`` bands of ``hopper_batched.bands`` keeps its rows and one halo row
    above and one below as a small lane of its own (halo rows frozen) and
    sweeps the cells of its own class ``q ^ ((r0 - 1) & 1)`` (``flip``;
    without it, lane class q), and after every sweep each band copies the
    cells of the class it just updated in its first and last rows into its
    neighbours' halo rows. Returns ``(u, delta [B])`` as update_n_batch."""
    b, h, w = u.shape
    cut = hopper_batched.bands(h, c)
    frozen = batched._frozen_batch(locked)
    x = torch.arange(w).view(1, w)
    band_u, band_f = [], []
    for r0, rows in cut:
        band_u.append(u[:, r0 - 1:r0 + rows + 1].clone())
        f = frozen[:, r0 - 1:r0 + rows + 1].clone()
        f[:, 0] = f[:, -1] = True
        band_f.append(f)

    def cls(k, q):   # the cells of band k's class for lane class q, in its own rows
        r0, rows = cut[k]
        ly = torch.arange(rows + 2).view(-1, 1)
        return ((ly + x) & 1) == (q ^ ((r0 - 1) & 1) if flip else q)

    delta = torch.zeros(b)
    for s in range(num_steps):
        q = ((t0 + s) & 1) ^ 1
        for k, (r0, rows) in enumerate(cut):
            if rows == 0:
                continue
            lu = band_u[k]
            val = lse4(lu[:, :-2, 1:-1], lu[:, 2:, 1:-1], lu[:, 1:-1, :-2], lu[:, 1:-1, 2:])
            upd = (cls(k, q) & ~band_f[k])[:, 1:-1, 1:-1]
            old = lu[:, 1:-1, 1:-1]
            new = torch.where(upd, val, old)
            if s == 0:
                delta = torch.maximum(delta, (new - old).abs().amax(dim=(1, 2)))
            lu[:, 1:-1, 1:-1] = new
        for k, (r0, rows) in enumerate(cut):
            if rows == 0:
                continue
            src = cls(k, q)   # the columns of the class just updated in rows 1 and `rows`
            if k > 0:
                assert not flip or torch.equal(cls(k - 1, q)[-1], src[1])
                band_u[k - 1][:, -1, src[1]] = band_u[k][:, 1, src[1]]
            if k + 1 < c and cut[k + 1][1] > 0:
                assert not flip or torch.equal(cls(k + 1, q)[0], src[rows])
                band_u[k + 1][:, 0, src[rows]] = band_u[k][:, rows, src[rows]]
    out = u.clone()
    for (r0, rows), lu in zip(cut, band_u):
        out[:, r0:r0 + rows] = lu[:, 1:rows + 1]
    return out, delta


@pytest.mark.parametrize("t0", [0, 1])
@pytest.mark.parametrize("b,h,w,c", [
    (3, 24, 32, 4),    # bands of 6, 6, 5, 5: the last keeps rows from 17, odd
    (2, 23, 27, 3),    # H not divisible by C; bands kept from rows 0, 7, 14
    (2, 7, 9, 4),      # bands of one row
    (2, 5, 11, 8),     # ranks past the interior keep no rows
    (2, 3, 131, 2),    # a one-row interior
    (2, 41, 17, 16),   # bands of three and two rows
])
def test_band_schedule_gives_update_n_batch_bits(b, h, w, c, t0):
    """The cluster route's schedule (bands with one halo row, the class
    flipped where a band's first kept row is odd, the just-updated class
    pushed after every sweep) gives the plain chunk's bits; without the
    flip it does not, wherever a band's first kept row is odd."""
    rng = np.random.default_rng(h * w + c)
    u = np.full((b, h, w), -1e6, np.float32)
    locked = rng.random((b, h, w)) < 0.1
    locked[:, [0, -1]] = True
    locked[:, :, [0, -1]] = True
    u[:, h // 2, w // 2] = 0.0
    locked[:, h // 2, w // 2] = True
    tu, tl = _port(u, locked)
    for steps in (1, 2, 9):
        ref_u, ref_d = batched.update_n_batch(tu, tl, t0, steps)
        out_u, out_d = _band_model(tu, tl, t0, steps, c)
        assert torch.equal(out_u, ref_u) and torch.equal(out_d, ref_d)
    if any((r0 - 1) & 1 and rows for r0, rows in hopper_batched.bands(h, c)):
        assert not torch.equal(_band_model(tu, tl, t0, 9, c, flip=False)[0], ref_u)


def test_uneven_retirement_matches_pallas():
    """tests/test_pallas_batched.py:128-145: lanes of very different
    difficulty retire at different iterations, and early retirees stay
    frozen while the others relax."""
    base = maps.open_room(24, 24)
    goal_sets = [[(12, 12)], [(2, 2)], [(12, 12), (2, 2), (20, 20)]]
    u, locked = jbatched.batch_from_goal_sets(base, goal_sets)
    u, locked = np.asarray(u), np.asarray(locked)
    ours = hopper_batched.solve_batch_device(*_port(u, locked), 1e-2, 7)
    theirs = pallas_batched.solve_batch_device(u, locked, epsilon=1e-2, stagger=7, interpret=True)
    _assert_solves_match(ours, theirs, field=CHUNK)
    assert len(set(ours[1].tolist())) == 3
    _assert_lanes_match_solo(u, locked, ours, 1e-2, 7, field=CHUNK)


def _base(h=24, w=32, seed=7):
    img = maps.random_obstacles(h, w, density=0.15, seed=seed)
    return img, np.full(img.shape, np.float32(-1e6)), img == 0


def _jax_goal_batch(base_u, base_locked, goal_xy, obstacle_xy=None):
    u_c, f_c, meta = pallas_batched.make_goal_batch(base_u, base_locked, goal_xy, obstacle_xy)
    return (pallas_batched.unstack(u_c, meta),
            pallas_batched.unstack(jnp.asarray(np.asarray(f_c), jnp.float32), meta) != 0)


def test_make_goal_batch_matches_jax():
    """Obstacle deltas apply, a goal wins a collision, -1 padding is
    dropped, not wrapped; the lanes equal epic_tpu's, bit for bit."""
    _, base_u, base_locked = _base()
    goal_xy = _goal_xy([[(5, 5)], [(5, 5)]])
    obstacle_xy = np.array([[[10, 10], [-1, -1]], [[5, 5], [11, 10]]], np.int32)
    u, locked = hopper_batched.make_goal_batch(base_u, base_locked, goal_xy, obstacle_xy,
                                               device="cpu")
    ref_u, ref_locked = _jax_goal_batch(base_u, base_locked, goal_xy, obstacle_xy)
    np.testing.assert_array_equal(u.numpy(), ref_u)
    np.testing.assert_array_equal(locked.numpy(), ref_locked)
    assert u.is_contiguous() and locked.is_contiguous() and locked.dtype == torch.bool
    assert u[0, 10, 10] == -1e6 and locked[0, 10, 10] and u[0, 5, 5] == 0.0
    assert u[1, 5, 5] == 0.0 and locked[1, 5, 5] and u[1, 10, 11] == -1e6
    assert not locked[0, -2, -2]    # the far corner's interior neighbour: untouched
    ring = np.ones(base_u.shape, bool)
    ring[1:-1, 1:-1] = False
    assert locked.numpy()[:, ring].all()


def test_out_of_logical_range_coords_dropped():
    _, base_u, base_locked = _base()
    h, w = base_u.shape
    goal_xy = _goal_xy([[(5, 5)], [(6, 6)]])
    bad = np.array([[[w, 1], [w + 1, 2]], [[1, h], [3, h + 1]]], np.int32)
    u, locked = hopper_batched.make_goal_batch(base_u, base_locked, goal_xy, bad, device="cpu")
    ref_u, ref_locked = hopper_batched.make_goal_batch(
        base_u, base_locked, goal_xy, np.full_like(bad, -1), device="cpu")
    np.testing.assert_array_equal(u.numpy(), ref_u.numpy())
    np.testing.assert_array_equal(locked.numpy(), ref_locked.numpy())
    j_u, j_locked = _jax_goal_batch(base_u, base_locked, goal_xy, bad)
    np.testing.assert_array_equal(u.numpy(), j_u)
    np.testing.assert_array_equal(locked.numpy(), j_locked)


def test_goal_on_an_obstacle_differs_between_the_builders():
    """batch_from_goal_sets skips a goal on an obstacle; make_goal_batch
    makes it a goal. Both packages keep both rules."""
    img = maps.open_room(16, 16)
    img[8, 8] = 0
    goal_sets = [[(8, 8), (4, 4)]]
    u, locked = batched.batch_from_goal_sets(img, goal_sets, device="cpu")
    ju, jl = jbatched.batch_from_goal_sets(img, goal_sets)
    np.testing.assert_array_equal(u.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(locked.numpy(), np.asarray(jl))
    assert u[0, 8, 8] == -1e6 and u[0, 4, 4] == 0.0

    base_u = np.full(img.shape, np.float32(-1e6))
    gu, gl = hopper_batched.make_goal_batch(base_u, img == 0, _goal_xy(goal_sets), device="cpu")
    ref_u, ref_l = _jax_goal_batch(base_u, img == 0, _goal_xy(goal_sets))
    np.testing.assert_array_equal(gu.numpy(), ref_u)
    np.testing.assert_array_equal(gl.numpy(), ref_l)
    assert gu[0, 8, 8] == 0.0 and gu[0, 4, 4] == 0.0


def test_make_goal_batch_equals_batch_from_goal_sets():
    """The device builder equals the host builder on free-cell goals (the
    gate of tools/probe.py's batched-goals, :646-654)."""
    img, base_u, base_locked = _base(32, 32, seed=5)
    rng = np.random.default_rng(5)
    free_y, free_x = np.nonzero(img != 0)
    picks = rng.choice(len(free_y), size=16, replace=True)
    goal_xy = np.stack([free_x[picks], free_y[picks]], axis=-1)[:, None, :]
    u, locked = hopper_batched.make_goal_batch(base_u, base_locked, goal_xy, device="cpu")
    hu, hl = batched.batch_from_goal_sets(img, [[tuple(g[0])] for g in goal_xy], device="cpu")
    assert torch.equal(u, hu) and torch.equal(locked, hl)


def test_solve_batch_goals_matches_pallas():
    img = maps.random_obstacles(24, 32, density=0.1, seed=3)
    goal_sets = [[(5, 5)], [(25, 18)], [(5, 5), (25, 18)], [(10, 12)]]
    base_u = np.full(img.shape, np.float32(-1e6))
    ours = hopper_batched.solve_batch_goals(base_u, img == 0, _goal_xy(goal_sets), None,
                                            1e-2, 10, device="cpu")
    theirs = pallas_batched.solve_batch_goals(base_u, img == 0, _goal_xy(goal_sets),
                                              epsilon=1e-2, stagger=10)
    assert bool(ours[3].all())
    _assert_solves_match(ours, theirs)
    u, locked = batched.batch_from_goal_sets(img, goal_sets, device="cpu")
    same = hopper_batched.solve_batch_device(u, locked, 1e-2, 10)
    for a, b in zip(ours, same):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_cpu_tensors_go_to_the_plain_version():
    """On the CPU the kernel wrappers run solver.batched (counted there) and
    launch nothing; the solver package exports both modules."""
    _, u, locked = _goal_batch(16, 20, [[(4, 4)], [(15, 10)]], density=0.1, seed=2)
    calls, launches = dict(batched.calls), dict(hopper_batched.launches)
    tu, tl = _port(u, locked)
    hopper_batched.update_n_batch(tu, tl, 0, 3)
    hopper_batched.solve_batch(tu, tl, 1e-2, 10)
    hopper_batched.solve_batch_device(tu, tl, 1e-2, 10)
    assert batched.calls["update_n_batch"] == calls["update_n_batch"] + 1
    assert batched.calls["solve_batch"] == calls["solve_batch"] + 2
    assert hopper_batched.launches == launches
    assert TS.batched is batched and TS.hopper_batched is hopper_batched
    with pytest.raises(ValueError, match="CUDA"):
        hopper_batched._check_cuda_batch(tu, tl)


def test_batch_inputs_are_checked():
    u = np.zeros((2, 5, 6), np.float32)
    locked = np.zeros((2, 5, 6), bool)
    tu, tl = batched.batch_from_numpy(u, locked, device="cpu")
    assert tu.dtype == torch.float32 and tl.dtype == torch.bool and tu.is_contiguous()
    for bad_u, bad_l, exc in ((u.astype(np.float64), locked, TypeError),
                              (u, locked.astype(np.uint8), TypeError),
                              (u[0], locked[0], ValueError),
                              (u, locked[:, :4], ValueError)):
        with pytest.raises(exc):
            batched.batch_from_numpy(bad_u, bad_l, device="cpu")
    for eps in (0.0, [1e-2, -1.0]):
        with pytest.raises(ValueError):
            batched.solve_batch(tu, tl, epsilon=eps)
    with pytest.raises(ValueError):
        batched.solve_batch(tu, tl, epsilon=[1e-2, 1e-2, 1e-2])
    for fn in (batched.update_n_batch, hopper_batched.update_n_batch):
        with pytest.raises(ValueError):
            fn(tu, tl, 0, 0)
    for fn in (batched.solve_batch, hopper_batched.solve_batch, hopper_batched.solve_batch_device):
        with pytest.raises(ValueError):
            fn(tu, tl, 1e-2, 0)
    with pytest.raises(ValueError):
        hopper_batched.make_goal_batch(u[0], locked[0], np.zeros((2, 2), np.int32), device="cpu")


def test_solo_lane_through_epic_tpu_core():
    """Lane 0 of a batch solve against epic_tpu's own solo core.solve."""
    goal_sets = [[(5, 5)], [(25, 18)]]
    _, u, locked = _goal_batch(24, 32, goal_sets)
    ours = batched.solve_batch(*_port(u, locked), epsilon=1e-2, stagger=10)
    st = epic_tpu.make_state(u[0], locked[0], epsilon=1e-2)
    from epic_tpu.solver import core as jcore
    solo = jcore.solve(st, stagger=10)
    assert int(ours[1][0]) == int(solo.iteration)
    np.testing.assert_allclose(ours[0][0].numpy(), np.asarray(solo.u), **SOLVE)
