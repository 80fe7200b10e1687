"""The port's temporally blocked tile family against epic_tpu: the plain
version (epic_tpu_torch/solver/tiled.py) against the port's own core bit for
bit, and against the TPU kernels it stands in for (pallas_biggrid's banded
chunks K3, pallas_tiled2d's slabs K5, pallas_cycle's cycles K4/K6, and their
update_n / solve / solve_segments), run in interpret mode as the JAX
package's own CPU tests run them, with the layouts forced small through
``pad_state(..., band=, k=, wt=)``.

Tolerances follow tests/test_torch_solver.py: fields rtol=2e-6, atol=1e-3;
deltas rtol=1e-5, atol=1e-5 (torch's and XLA's CPU exp differ by an ulp on
some inputs). On the card the kernels must give the plain version's bits:
tests/test_torch_cuda.py.
"""

import dataclasses
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epic_tpu
from epic_tpu import maps
from epic_tpu.solver import pallas_biggrid, pallas_cycle, pallas_tiled2d
import epic_tpu_torch.solver as TS
from epic_tpu_torch import grid as TG
from epic_tpu_torch.config import EpicConfig, SolverConfig
from epic_tpu_torch.planner import Planner, PlannerConfig
from epic_tpu_torch.solver import core, hopper_sweep, hopper_tile2d, hopper_tile3d, tiled

FIELD = dict(rtol=2e-6, atol=1e-3)
DELTA = dict(rtol=1e-5, atol=1e-5)
HX = 128   # pallas_tiled2d's column guard, to read its padded grids


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once
    (see tests/test_torch_solver.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(h, w, seed):
    return maps.random_obstacles(h, w, density=0.12, seed=seed)


def _states(h, w, seed=3, eps=1e-2, t0=0):
    """The same seeded grid as an epic_tpu and an epic_tpu_torch state."""
    img = _img(h, w, seed)
    j = dataclasses.replace(epic_tpu.from_occupancy_image(img, epsilon=eps),
                            iteration=jnp.int32(t0))
    t = dataclasses.replace(TG.from_occupancy_image(img, eps, device="cpu"),
                            iteration=torch.tensor(t0, dtype=torch.int32))
    return j, t


def _torch_state(h, w, seed=3, eps=1e-2, t0=0):
    return _states(h, w, seed, eps, t0)[1]


def _close(ours, theirs, tol=FIELD):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), **tol)


# -- the plain version against the port's core, bit for bit ---------------------------

# (H, W, tile): ragged edges, tiles shorter than K, a grid smaller than one
# tile, one-cell tiles, the production tile.
GRIDS = [(37, 91, (8, 16)), (37, 91, (4, 5)), (20, 30, (64, 128)), (9, 7, (1, 1)),
         (70, 150, hopper_tile2d.TILE)]


@pytest.mark.parametrize("k", [1, 8, 16])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}-{g[2][0]}x{g[2][1]}")
def test_chunk_equals_core_bit_for_bit(grid, k):
    h, w, tile = grid
    for t0 in (0, 1):
        st = _torch_state(h, w, t0=t0)
        for ns in sorted({1, min(5, k), k}):
            dst, delta, u1 = tiled.sweep_chunk(st.u, st.locked, st.iteration, ns, k=k, tile=tile,
                                               u1=True)
            ref = core.update_n(st, ns)
            assert torch.equal(dst, ref.u) and torch.equal(delta, ref.delta)
            assert torch.equal(u1, core.update_n(st, 1).u)


@pytest.mark.parametrize("n", [1, 15, 16, 17, 37, 50, 100])
def test_update_n_and_cycle_equal_core(n):
    """Every tick schedule (one chunk, a cycle, a cycle plus a remainder)."""
    st = _torch_state(37, 91, t0=3)
    for k, tile in ((16, (8, 16)), (8, hopper_tile2d.TILE)):
        out = tiled.update_n(st, n, k=k, tile=tile)
        ref = core.update_n(st, n)
        assert torch.equal(out.u, ref.u) and torch.equal(out.delta, ref.delta)
        assert int(out.iteration) == int(ref.iteration)
        assert bool(out.converged) == bool(ref.converged)
        cycle_sweeps, n_chunks, tail = tiled.tick_schedule(n, k)
        assert cycle_sweeps + tail == n and n_chunks % 2 == 0
        assert (n_chunks + (tail > 0)) == -(-n // k)


@pytest.mark.parametrize("stagger,cap", [(1, 1_000_000), (5, 1_000_000), (13, 1_000_000),
                                         (100, 1_000_000), (10, 95), (100, 250), (7, 0)])
def test_solve_and_segments_equal_core(stagger, cap):
    st = _torch_state(48, 70, seed=11, eps=1e-1)
    ref = core.solve(st, stagger, cap)
    for k, tile in ((16, (16, 32)), (8, (5, 7))):
        for out in (tiled.solve(st, stagger, cap, k=k, tile=tile),
                    tiled.solve_segments(st, stagger, cap, 37, k=k, tile=tile)):
            assert torch.equal(out.u, ref.u) and torch.equal(out.delta, ref.delta)
            assert int(out.iteration) == int(ref.iteration)
            assert bool(out.converged) == bool(ref.converged)


def test_schedules():
    assert tiled.spread(50, 4) == [13, 13, 12, 12]
    assert tiled.tick_schedule(100, 16) == (86, 6, 14)
    assert tiled.tick_schedule(50, 16) == (50, 4, 0)
    assert tiled.tick_schedule(16, 16) == (0, 0, 16)
    assert tiled.solve_schedule(100, 16) == (16, [14] * 6)
    assert tiled.solve_schedule(5, 16) == (5, [])
    # Segment bounds are whole stagger cycles (no no-op segment), the cap last.
    assert tiled.segment_bounds(10, 95, 37) == [40, 80, 95]
    assert tiled.segment_bounds(10, 1000, 5) == list(range(10, 1000, 10)) + [1000]
    assert tiled.segment_bounds(100, 2000, 500) == [500, 1000, 1500, 2000]


# -- against epic_tpu's kernels in interpret mode ------------------------------------

@pytest.mark.parametrize("h,w,band,k", [(96, 64, 16, 8), (40, 200, 16, 8)])
def test_chunk_matches_banded_dma_chunks(h, w, band, k):
    """K3: sweep_chunk_dma (chained, full and shallow chunks) and the check
    variant's u1, against the port's chunk."""
    j, t = _states(h, w, seed=5)
    g = pallas_biggrid.pad_state(j, band=band, k=k)
    u_pad, u = g.u, t.u
    it = 0
    for depth in (k, 5):
        out_uk, out_u1, d_check = pallas_biggrid.sweep_chunk_dma_check(
            u_pad, g.frozen, jnp.int32(it), depth, band, k, True)
        u_pad, d = pallas_biggrid.sweep_chunk_dma(u_pad, g.frozen, jnp.int32(it), depth, band,
                                                  k, True)
        dst, delta, u1 = tiled.sweep_chunk(u, t.locked, it, depth, k=k, tile=(8, 16), u1=True)
        _close(dst, u_pad[k:k + h, :w])
        _close(dst, out_uk[:h, :w])
        _close(u1, out_u1[:h, :w])
        _close(float(delta), float(d), DELTA)
        assert float(d) == float(d_check)
        u, it = dst, it + depth


@pytest.mark.parametrize("h,w,band,k,wt", [(64, 140, 8, 8, 128), (30, 130, 16, 16, 128)])
def test_chunk_matches_tiled_slab_chunks(h, w, band, k, wt):
    """K5: sweep_chunk_tiled and its check variant's u1."""
    j, t = _states(h, w, seed=3)
    g = pallas_tiled2d.pad_state(j, band=band, k=k, wt=wt)
    u_pad, u = g.u, t.u
    it = 0
    for depth in (k, 3):
        out_uk, out_u1, _ = pallas_tiled2d.sweep_chunk_tiled_check(
            u_pad, g.frozen, jnp.int32(it), depth, band, k, wt, True)
        u_pad, d = pallas_tiled2d.sweep_chunk_tiled(u_pad, g.frozen, jnp.int32(it), depth, band,
                                                    k, wt, True)
        dst, delta, u1 = tiled.sweep_chunk(u, t.locked, it, depth, k=k, tile=(16, 32), u1=True)
        _close(dst, u_pad[k:k + h, HX:HX + w])
        _close(dst, out_uk[:h, :w])
        _close(u1, out_u1[:h, :w])
        _close(float(delta), float(d), DELTA)
        u, it = dst, it + depth


@pytest.mark.parametrize("h,w,band,k,n_chunks", [(96, 64, 16, 8, 4), (34, 72, 16, 8, 3)])
def test_cycle_matches_banded_cycles(h, w, band, k, n_chunks):
    """K4: sweep_cycle (odd and even chains, per-chunk deltas) and
    sweep_cycle_check's u1."""
    j, t = _states(h, w, seed=5)
    g = pallas_biggrid.pad_state(j, band=band, k=k)
    a, b, deltas = pallas_cycle.sweep_cycle(g.u, jnp.copy(g.u), g.frozen, jnp.int32(0),
                                            n_chunks, k, band, True)
    g = pallas_biggrid.pad_state(j, band=band, k=k)
    _, _, u1, deltas_check = pallas_cycle.sweep_cycle_check(
        g.u, jnp.full_like(g.u, -1e6), g.frozen, jnp.int32(0), n_chunks, k, band, True)
    pa, pb, pd = tiled.sweep_cycle(t.u, t.u, t.locked, 0, n_chunks, k=k, tile=(16, 16))
    final, theirs = (pb, b) if n_chunks % 2 else (pa, a)
    _close(final, theirs[k:k + h, :w])
    _close(pd.numpy(), np.asarray(deltas), DELTA)
    _close(pd.numpy(), np.asarray(deltas_check), DELTA)
    _close(tiled.sweep_chunk(t.u, t.locked, 0, 1, k=k, tile=(16, 16))[0], u1[:h, :w])


@pytest.mark.parametrize("h,w,band,k,wt,n_chunks", [(96, 300, 16, 8, 128, 4),
                                                    (40, 300, 16, 8, 128, 3)])
def test_cycle_matches_tiled_cycles(h, w, band, k, wt, n_chunks):
    """K6: sweep_cycle_tiled and sweep_cycle_tiled_check's u1."""
    j, t = _states(h, w, seed=9)
    g = pallas_tiled2d.pad_state(j, band=band, k=k, wt=wt)
    a, b, deltas = pallas_cycle.sweep_cycle_tiled(g.u, jnp.copy(g.u), g.frozen, jnp.int32(0),
                                                  n_chunks, k, band, wt, True)
    g = pallas_tiled2d.pad_state(j, band=band, k=k, wt=wt)
    _, _, u1, _ = pallas_cycle.sweep_cycle_tiled_check(
        g.u, jnp.full_like(g.u, -1e6), g.frozen, jnp.int32(0), n_chunks, k, band, wt, True)
    pa, pb, pd = tiled.sweep_cycle(t.u, t.u, t.locked, 0, n_chunks, k=k, tile=(32, 64))
    final, theirs = (pb, b) if n_chunks % 2 else (pa, a)
    _close(final, theirs[k:k + h, HX:HX + w])
    _close(pd.numpy(), np.asarray(deltas), DELTA)
    _close(tiled.sweep_chunk(t.u, t.locked, 0, 1, k=k, tile=(32, 64))[0], u1[:h, :w])


@pytest.mark.parametrize("module", [pallas_biggrid, pallas_tiled2d],
                         ids=["biggrid", "tiled2d"])
def test_update_n_matches_epic_tpu(module):
    j, t = _states(80, 120, seed=5, t0=4)
    theirs = module.update_n(j, 37, chunk_depth=16)
    ours = hopper_tile2d.update_n(t, 37)          # a CPU state: the plain version
    _close(ours.u, theirs.u)
    _close(float(ours.delta), float(theirs.delta), DELTA)
    assert int(ours.iteration) == int(theirs.iteration) == 41


@pytest.mark.parametrize("stagger,eps", [(5, 1e-2), (13, 1e-1), (100, 1e-1)])
@pytest.mark.parametrize("module", [pallas_biggrid, pallas_tiled2d],
                         ids=["biggrid", "tiled2d"])
def test_solve_matches_epic_tpu(module, stagger, eps):
    """The protocol edges of tests/test_pallas_biggrid.py:105-118: stagger
    below k, above k with a remainder, early convergence."""
    j, t = _states(48, 150, seed=11, eps=eps)
    theirs = module.solve(j, stagger=stagger)
    ours = hopper_tile2d.solve(t, stagger)
    assert int(ours.iteration) == int(theirs.iteration)
    assert int(ours.iteration) % stagger == 1
    assert bool(ours.converged) and bool(theirs.converged)
    _close(ours.u, theirs.u)
    _close(float(ours.delta), float(theirs.delta), DELTA)


@pytest.mark.parametrize("module", [pallas_biggrid, pallas_tiled2d],
                         ids=["biggrid", "tiled2d"])
def test_solve_segments_match_epic_tpu(module):
    """The port's segments are its own one solve, bit for bit, and stop at
    epic_tpu's iteration, converged or capped mid-segment."""
    for eps, cap in ((1e-2, 1_000_000), (1e-8, 85)):
        j, t = _states(96, 128, seed=4, eps=eps)
        theirs = module.solve_segments(j, stagger=10, max_iterations=cap, segment_iterations=37)
        ours = TS.solve_grid(t, 10, cap, segment_iterations=37)      # the CPU: core
        seg = hopper_tile2d.solve_segments(t, 10, cap, 37)
        one = hopper_tile2d.solve(t, 10, cap)
        assert torch.equal(seg.u, one.u) and torch.equal(seg.delta, one.delta)
        assert int(seg.iteration) == int(one.iteration) == int(ours.iteration) \
            == int(theirs.iteration)
        assert bool(seg.converged) == bool(theirs.converged) == (cap > 100)
        _close(seg.u, theirs.u)


# -- routing and configuration -------------------------------------------------------

def test_use_tiles_is_a_rule_on_bytes_and_l2():
    """Tiles past two thirds of the L2: the crossover measured on an H100
    (50 MB of L2) lies between 2560² and 2736²."""
    l2 = 50 * 2**20
    assert not hopper_tile2d.past_crossover((2560, 2560), l2)
    assert hopper_tile2d.past_crossover((2736, 2736), l2)
    assert hopper_tile2d.past_crossover((2816, 2816), l2)
    assert hopper_tile2d.past_crossover((4096, 4096), l2)
    assert hopper_tile2d.past_crossover((2000, 33_333), l2)
    cells = 2 * l2 // 15                            # 5 B a cell, 2/3 of the L2
    assert not hopper_tile2d.past_crossover((1, cells), l2)
    assert hopper_tile2d.past_crossover((1, cells + 1), l2)
    assert not hopper_tile2d.past_crossover((4096, 4096), 200 * 2**20)
    # A grid on the CPU never goes to the tiles, whatever its size.
    assert not hopper_tile2d.use_tiles((8192, 8192), "cpu")


def test_config_takes_tile_depth_and_refuses_tile_band():
    assert SolverConfig(tile_depth=8).tile_depth == 8
    with pytest.raises(ValueError, match="TPU band height"):
        SolverConfig(tile_band=64)
    with pytest.raises(ValueError, match="TPU band height"):
        EpicConfig.from_dict({"solver": {"tile_band": 96}})
    with pytest.raises(ValueError, match=">= 1"):
        SolverConfig(tile_depth=0)
    # Whether a depth fits shared memory is the card's to say: the wrapper
    # checks it before each launch, against the device's opt-in limit.
    assert SolverConfig(tile_depth=64).tile_depth == 64
    h100 = 232_448                                  # an H100 block's opt-in shared memory
    hopper_tile2d.check_depth(32, h100)
    hopper_tile2d.check_depth(55, h100)
    with pytest.raises(ValueError, match="shared memory"):
        hopper_tile2d.check_depth(56, h100)
    with pytest.raises(ValueError, match=">= 1"):
        hopper_tile2d.check_depth(0, h100)
    # 128 rows of the 96 x 160 tile's 192-wide extension at K = 16: two class
    # rows of 96 floats and of 3 words of frozen bits each.
    assert hopper_tile2d.smem_bytes(16) == 128 * 2 * (96 * 4 + 3 * 4)


CSRC = pathlib.Path(hopper_tile2d.__file__).resolve().parent.parent / "csrc"


def _constants(source: str, names) -> tuple:
    text = (CSRC / source).read_text()
    return text, tuple(int(re.search(rf"constexpr int {n} = (\d+);", text).group(1))
                       for n in names)


@pytest.mark.parametrize("family", ["tile2d", "tile3d"])
def test_smem_formulas_are_what_the_kernels_allocate(family):
    """Each wrapper's smem_bytes is the dynamic shared memory its kernels'
    launches ask for: the tile that the source fixes (which TILE mirrors),
    laid out as the source lays it out. 2D: two class arrays, each of
    kTH + 2K rows of (kTW + 2K) / 2 floats and of their frozen bits in
    32-bit words; 3D: a ring of K + 3 planes of the extended column with a
    guard row above and below, a float a voxel, and the deepest halo the
    source takes. The card tests
    compare the formulas with the libraries' own."""
    if family == "tile2d":
        text, (th, tw, sth, stw) = _constants("tile2d.cu", ("kTH", "kTW", "kSmallTH", "kSmallTW"))
        assert hopper_tile2d.TILE == (th, tw) and hopper_tile2d.TILE_SMALL == (sth, stw)
        assert ("(S::kTH + 2 * K) * 2 *\n         (S::class_row(K) * sizeof(float) + "
                "S::frozen_words(K) * sizeof(uint32_t))") in text
        assert "class_row(int K) { return TW / 2 + K; }" in text
        assert "return (class_row(K) + 31) / 32;" in text
        for k in range(1, 80):
            for (a, b) in ((th, tw), (sth, stw)):
                half = (b + 2 * k) // 2
                assert hopper_tile2d.tile_smem_bytes(k, (a, b)) == \
                    (a + 2 * k) * 2 * (half * 4 + -(-half // 32) * 4)
            assert hopper_tile2d.smem_bytes(k) == hopper_tile2d.tile_smem_bytes(k)
            assert hopper_tile2d.tile_smem_bytes(k, (sth, stw)) < hopper_tile2d.smem_bytes(k)
    else:
        text, (th, tw, max_k) = _constants("tile3d.cu", ("kTH", "kTW", "kMaxK"))
        assert hopper_tile3d.COLUMN == (th, tw) and hopper_tile3d.TILE[1:] == (th, tw)
        assert hopper_tile3d.MAX_DEPTH == max_k
        assert ("return static_cast<size_t>(K + 3) * (kTH + 2 * K + 2) * 2 * "
                "(((kTW + 2 * K) / 2 + 3) / 4 * 4);") in text
        assert "return ring_floats(K) * sizeof(float);" in text
        for k in range(1, max_k + 1):
            pitch = -(-((tw + 2 * k) // 2) // 4) * 4        # pairs a row, whole quads
            assert hopper_tile3d.smem_bytes(k) == (k + 3) * (th + 2 * k + 2) * 2 * pitch * 4


def test_planner_on_the_cpu_runs_core():
    """Routing is by device: on the CPU a Planner ticks and solves with core,
    launches nothing, and tile_depth changes nothing."""
    img = _img(40, 60, 2)
    occ = np.where(img == 0, 100, 0).astype(np.int8)
    before = (dict(core.calls), dict(tiled.calls), dict(hopper_tile2d.launches),
              dict(hopper_sweep.launches))
    cfg = EpicConfig.from_dict({"solver": {"epsilon": 1e-2, "tile_depth": 4}})
    tp = Planner(cfg, device="cpu")
    tp.update_occupancy(occ)
    assert tp.add_goals([(30.0, 20.0)])
    ref = tp.state
    tp.update(20)
    tp.solve()
    assert core.calls["update_n"] == before[0]["update_n"] + 1
    assert core.calls["solve"] == before[0]["solve"] + 1
    assert (tiled.calls, hopper_tile2d.launches, hopper_sweep.launches) == before[1:]
    expect = core.solve(core.update_n(ref, 20))
    assert torch.equal(tp.state.u, expect.u) and bool(tp.state.converged)
    assert isinstance(Planner(PlannerConfig(), device="cpu").solver_config.tile_depth, int)
