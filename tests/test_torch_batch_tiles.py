"""The tiled route of the batched scenario solves, modelled in plain torch
(``solver.tiled.lanes_update_n`` and ``lanes_solve``: ``csrc/tile2d.cu``'s
tile pass over every (lane, tile) pair, in the kernels' chunks, gating, u1
keep and final copies) against the plain batched version
(``solver.batched``) bit for bit, and against ``epic_tpu.solver.
pallas_batched``, whose kernels (K12 ``_block_kernel``, K13
``_block_kernel_gated``) run in interpret mode as the JAX package's own
CPU tests run them.

Tolerances: within the port the same bits (the tile sweep repeats the
plain sweep's arithmetic on the same cells in the same order). Across the
two packages those of tests/test_torch_batched.py: fields rtol=2e-6 with
atol=1e-4 (chunks) or atol=1e-3 (solves), iteration counts and verdicts
equal, deltas rtol=1e-5 with atol=1e-5 (torch's and XLA's CPU exp differ
by one ulp on some inputs). The kernels against the model on the card:
tests/test_torch_cuda.py.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epic_tpu import maps
from epic_tpu.solver import batched as jbatched
from epic_tpu.solver import pallas_batched
from epic_tpu_torch.solver import batched, hopper_batched, hopper_tile2d, tiled

CHUNK = dict(rtol=2e-6, atol=1e-4)
SOLVE = dict(rtol=2e-6, atol=1e-3)
DELTA_X = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once
    (see tests/test_torch_solver.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lanes(b, h, w, seed, goalless=(), density=0.1):
    """``b`` lanes of ``h x w`` made by numpy from ``seed``: -1e6 everywhere,
    obstacle cells, the ring locked, one goal cell a lane except those in
    ``goalless``."""
    rng = np.random.default_rng(seed)
    u = np.full((b, h, w), -1e6, np.float32)
    locked = rng.random((b, h, w)) < density
    locked[:, [0, -1]] = True
    locked[:, :, [0, -1]] = True
    for lane in range(b):
        if lane not in goalless:
            y, x = rng.integers(1, max(h - 1, 2)), rng.integers(1, max(w - 1, 2))
            u[lane, y, x] = 0.0
            locked[lane, y, x] = True
    return batched.batch_from_numpy(u, locked, device="cpu")


def _same(got, want):
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


# (B, H, W, seed): odd and even H and W, one lane, five, a lane with no
# interior, and tiles smaller and larger than the lane.
LANE_SHAPES = [(1, 9, 14, 0), (2, 13, 17, 1), (3, 20, 9, 2), (5, 6, 7, 3), (4, 3, 3, 4)]
TILES = [(4, 6), (32, 96)]


@pytest.mark.parametrize("tile", TILES, ids=lambda t: f"{t[0]}x{t[1]}")
@pytest.mark.parametrize("k,num_sweeps", [(1, 1), (1, 3), (3, 2), (3, 3), (3, 4), (3, 7),
                                          (16, 9), (16, 16), (16, 33)])
@pytest.mark.parametrize("shape", LANE_SHAPES, ids=lambda s: "x".join(map(str, s[:3])))
def test_lane_chunk_model_gives_the_plain_versions_bits(shape, k, num_sweeps, tile):
    """num_sweeps below, equal to and above K (one, two and three chunks,
    an odd count copied back), from an even and an odd iteration, with no
    gate, with every third lane inactive and with only the last lane
    active: the plain version's u and deltas, an inactive lane untouched
    with delta 0."""
    b, h, w, seed = shape
    u, locked = _lanes(b, h, w, seed)
    gates = [None, torch.arange(b) % 3 != 1, torch.arange(b) == b - 1]
    for t0 in (0, 1):
        for gate in gates:
            got = tiled.lanes_update_n(u, locked, t0, num_sweeps, gate, k=k, tile=tile)
            _same(got, batched.update_n_batch(u, locked, t0, num_sweeps, gate))
            if gate is not None:
                assert torch.equal(got[0][~gate], u[~gate]) and bool((got[1][~gate] == 0).all())
    assert tiled.lanes_update_n(u, locked, torch.tensor(1, dtype=torch.int32), num_sweeps,
                                k=k, tile=tile)[0].equal(batched.update_n_batch(
                                    u, locked, 1, num_sweeps)[0])


@pytest.mark.parametrize("k", [1, 3, 16])
@pytest.mark.parametrize("stagger,cap", [(1, 200), (7, 300), (100, 1000), (7, 45), (10, 95)])
@pytest.mark.parametrize("shape", [(3, 13, 17, 5), (2, 20, 9, 6)],
                         ids=lambda s: "x".join(map(str, s[:3])))
def test_lane_solve_model_gives_the_plain_versions_bits(shape, stagger, cap, k):
    """The lockstep solve in the tiled route's schedule (the checked chunk
    of min(K, stagger) sweeps with u1, the verdicts, the rest in chunks of
    at most K) with a goalless lane, capped mid-cycle too: the plain
    version's u, iterations, deltas and verdicts."""
    b, h, w, seed = shape
    u, locked = _lanes(b, h, w, seed, goalless=(0,))
    _same(tiled.lanes_solve(u, locked, 1e-2, stagger, cap, k=k, tile=(4, 6)),
          batched.solve_batch(u, locked, 1e-2, stagger, cap))


@pytest.mark.parametrize("stagger,cap", [(1, 400), (7, 403), (100, 550), (100, 1_000_000),
                                         (7, 1_000_000)])
def test_lane_solve_model_retires_lanes_unevenly(stagger, cap):
    """Lanes that retire at different cycles (two goalless lanes first, a
    lane eps 1e-4 last or never under the cap) keep their own u1 slices
    while the others sweep on: the plain version's bits."""
    u, locked = _lanes(6, 48, 77, 14, goalless=(0, 3))
    eps = torch.tensor([1e-2, 1e-3, 5e-2, 2e-3, 1e-2, 1e-4])
    got = tiled.lanes_solve(u, locked, eps, stagger, cap, k=16, tile=(16, 32))
    _same(got, batched.solve_batch(u, locked, eps, stagger, cap))
    assert len(set(got[1].tolist())) > 2


def test_lane_models_refuse_what_the_kernels_do_not_take():
    u, locked = _lanes(2, 9, 9, 0)
    for call in (lambda: tiled.lanes_update_n(u, locked, 0, 0, k=3, tile=(4, 6)),
                 lambda: tiled.lanes_update_n(u, locked, 0, 3, k=0, tile=(4, 6)),
                 lambda: tiled.lanes_solve(u, locked, 1e-2, 0, 100, k=3, tile=(4, 6)),
                 lambda: tiled.lanes_solve(u, locked, 1e-2, 5, 100, k=3, tile=(0, 6))):
        with pytest.raises(ValueError):
            call()


def _goal_batch(h, w, goal_sets, density=0.15, seed=7):
    """The same goal-set batch from both packages, as numpy arrays."""
    img = maps.random_obstacles(h, w, density=density, seed=seed)
    u, locked = jbatched.batch_from_goal_sets(img, goal_sets)
    return np.asarray(u), np.asarray(locked)


GOAL_SETS = [[(5, 5)], [(25, 18)], [(5, 5), (25, 18)]]


def test_lane_chunk_model_matches_k12():
    """An 8-sweep chunk at K = 3 (three chunks, the last copied back)
    against sweep_chunk_batch (K12 in interpret mode), lane by lane through
    unstack; each collage block's delta the maximum of its lanes'."""
    u, locked = _goal_batch(24, 32, GOAL_SETS)
    u_c, frozen, meta = pallas_batched.pad_batch(u, locked)
    out_c, block_delta = pallas_batched.sweep_chunk_batch(u_c, frozen, jnp.int32(1), 8, meta,
                                                          interpret=True)
    ours_u, ours_d = tiled.lanes_update_n(*batched.batch_from_numpy(u, locked, device="cpu"), 1,
                                          8, k=3, tile=(8, 12))
    np.testing.assert_allclose(ours_u.numpy(), pallas_batched.unstack(out_c, meta), **CHUNK)
    per_group = meta["gpr"] * meta["gpc"]
    for blk, d in enumerate(np.asarray(block_delta)):
        lanes = ours_d[blk * per_group:(blk + 1) * per_group]
        np.testing.assert_allclose(float(lanes.max()), float(d), **DELTA_X)


@pytest.mark.parametrize("stagger,k", [(11, 4), (64, 16)])
def test_lane_solve_model_matches_k13(stagger, k):
    """The tiled route's lockstep solve against pallas_batched's one-launch
    solve (K13 and _solve_collage_device in interpret mode): iterations and
    verdicts equal, fields and deltas within the tolerances above."""
    u, locked = _goal_batch(24, 32, GOAL_SETS)
    ours = tiled.lanes_solve(*batched.batch_from_numpy(u, locked, device="cpu"), 1e-2, stagger,
                             1_000_000, k=k, tile=(8, 12))
    theirs = pallas_batched.solve_batch_device(u, locked, epsilon=1e-2, stagger=stagger,
                                               interpret=True)
    u_o, it, dl, cv = (x.numpy() for x in ours)
    u_j, it_j, dl_j, cv_j = (np.asarray(x) for x in theirs)
    np.testing.assert_array_equal(it, it_j)
    np.testing.assert_array_equal(cv, cv_j)
    np.testing.assert_allclose(dl, dl_j, **DELTA_X)
    np.testing.assert_allclose(u_o, u_j, **SOLVE)
    assert bool(ours[3].all())


def test_blocks_name_the_tiled_route(monkeypatch):
    """Past the resident lanes and every cluster (and for lanes of fewer
    than three rows or columns) ``_blocks`` names the tiled route (0
    blocks: the tile2d.cu entries), at the grid tiles' depth, whatever the
    batch's size. A few lanes a cluster holds take wider clusters."""
    dev = torch.device("cuda", 0)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: types.SimpleNamespace(
        shared_memory_per_block_optin=232_448, multi_processor_count=132))
    monkeypatch.setattr(hopper_batched, "max_cluster", lambda device: 16)
    assert hopper_batched._blocks(4096, 128, 128, dev) == (1, "resident")
    assert hopper_batched._blocks(256, 384, 384, dev) == (3, "cluster")
    assert hopper_batched._blocks(32, 1024, 1024, dev) == (0, "tiled")
    assert hopper_batched._blocks(1, 2, 60_000, dev) == (0, "tiled")
    assert hopper_batched._blocks(2, 2, 60_000, dev) == (0, "tiled")
    assert hopper_batched._blocks(1, 1024, 1024, dev) == (0, "tiled")
    assert hopper_batched._blocks(4, 1024, 1024, dev) == (0, "tiled")
    assert hopper_batched._blocks(5, 1024, 1024, dev) == (0, "tiled")
    assert hopper_batched._blocks(6, 1024, 1024, dev) == (0, "tiled")
    assert hopper_batched._blocks(8, 384, 384, dev) == (8, "cluster")
    assert hopper_batched._blocks(1, 384, 384, dev) == (16, "cluster")
    assert hopper_batched.DEPTH == hopper_tile2d.DEFAULT_DEPTH
    assert set(hopper_batched.routes) == {"resident", "cluster", "tiled"}
