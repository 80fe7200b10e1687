"""The port's temporally blocked 3D tile family against epic_tpu: the plain
version (epic_tpu_torch/solver/tiled3d.py) against the port's own core bit
for bit, and against the TPU kernels it stands in for (pallas_biggrid3d's
plane-band chunks K8 and T3, pallas_tiled3d's slabs K10 and its check
variant, pallas_cycle's 3D cycles K9 and K11, and both modules' update_n /
solve / solve_segments), run in interpret mode as the JAX package's own CPU
tests run them, with the layouts forced small through ``pad_state(...,
band=, k=, yt=, wt=)``; ``unpad`` only reads those layouts. The kernels'
z march (csrc/tile3d.cu) is modelled here in plain torch (``march_chunk``)
and held to the plain version and core bit for bit; with its levels in
descending order it gives other bits. The tile rule and the routing rule
of ``solver`` (every volume to K7) are checked on shapes.

Tolerances: within the package, the same bits. Across packages fields
rtol=2e-6, atol=1e-5 and deltas rtol=1e-5, atol=1e-5 (torch's and XLA's CPU
exp differ by an ulp on some inputs, tests/test_torch_solver.py), and equal
iteration counts. On the card the kernels must give the plain version's
bits: tests/test_torch_cuda.py.
"""

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import epic_tpu
from epic_tpu.solver import pallas_biggrid3d, pallas_cycle, pallas_tiled3d
import epic_tpu_torch.solver as TS
from epic_tpu_torch import constants as C
from epic_tpu_torch import grid as TG
from epic_tpu_torch.planner3d import VolumePlanner, VolumePlannerConfig
from epic_tpu_torch.solver import core, hopper_sweep3d, hopper_tile3d, tiled3d
from epic_tpu_torch.solver._sweep_body import lse6

FIELD = dict(rtol=2e-6, atol=1e-5)
DELTA = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once
    (see tests/test_torch_solver.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arrays(shape, density=0.12, seed=0):
    """A boundary-locked volume with seeded obstacle voxels and one goal
    voxel at the centre (tests/test_pallas_tiled3d.py's _volume)."""
    d, h, w = shape
    rng = np.random.default_rng(seed)
    u = np.full(shape, -1e6, dtype=np.float32)
    locked = np.zeros(shape, dtype=bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    if density:
        locked |= rng.random(shape) < density
    u[d // 2, h // 2, w // 2] = 0.0
    locked[d // 2, h // 2, w // 2] = True
    return u, locked


def _states(shape, density=0.12, seed=0, eps=1e-2, t0=0):
    """The same seeded volume as an epic_tpu and an epic_tpu_torch state."""
    u, locked = _arrays(shape, density, seed)
    j = dataclasses.replace(epic_tpu.grid.make_state(u, locked, epsilon=eps),
                            iteration=jnp.int32(t0))
    t = dataclasses.replace(TG.make_state(u, locked, eps, device="cpu"),
                            iteration=torch.tensor(t0, dtype=torch.int32))
    return j, t


def _torch_state(shape, density=0.12, seed=0, eps=1e-2, t0=0):
    return _states(shape, density, seed, eps, t0)[1]


def _close(ours, theirs, tol=FIELD):
    np.testing.assert_allclose(np.asarray(ours), np.asarray(theirs), **tol)


def _same(a, b):
    assert torch.equal(a.u, b.u) and torch.equal(a.delta, b.delta)
    assert int(a.iteration) == int(b.iteration)
    assert bool(a.converged) == bool(b.converged)


# -- the plain version against the port's core, bit for bit ---------------------------

# (shape, tile): ragged on every axis, tiles thinner than K, a volume smaller
# than one tile, one-voxel tiles, the kernels' tile.
VOLUMES = [((10, 20, 37), (4, 8, 16)), ((7, 9, 21), (2, 3, 5)), ((5, 6, 7), (8, 16, 64)),
           ((3, 3, 3), (1, 1, 1)), ((9, 18, 70), hopper_tile3d.TILE)]


@pytest.mark.parametrize("k", [1, 2, 5])
@pytest.mark.parametrize("vol", VOLUMES, ids=lambda v: "x".join(map(str, v[0])) + "-"
                         + "x".join(map(str, v[1])))
def test_chunk_equals_core_bit_for_bit(vol, k):
    shape, tile = vol
    for t0 in (0, 1):
        st = _torch_state(shape, t0=t0)
        for ns in sorted({1, min(3, k), k}):
            dst, delta, u1 = tiled3d.sweep_chunk(st.u, st.locked, st.iteration, ns, k=k,
                                                 tile=tile, u1=True)
            ref = core.update_n(st, ns)
            assert torch.equal(dst, ref.u) and torch.equal(delta, ref.delta)
            assert torch.equal(u1, core.update_n(st, 1).u)


@pytest.mark.parametrize("n_chunks,num_sweeps", [(1, 3), (2, 5), (3, 6), (3, 9)])
def test_cycle_equals_core_per_chunk(n_chunks, num_sweeps):
    """Cycles of 1-3 chunks: the state in a for an even count and in b for
    an odd one, and each chunk's delta core's delta of its first sweep."""
    st = _torch_state((10, 20, 37), seed=4, t0=5)
    a, b, deltas = tiled3d.sweep_cycle(st.u, st.u, st.locked, st.iteration, n_chunks,
                                       num_sweeps, k=3, tile=(4, 8, 16))
    assert torch.equal(a if n_chunks % 2 == 0 else b, core.update_n(st, num_sweeps).u)
    ref, t = st, 0
    for c, ns in enumerate(tiled3d.spread(num_sweeps, n_chunks)):
        ref = core.update_n(ref, ns)
        assert torch.equal(deltas[c], ref.delta)
    with pytest.raises(ValueError):
        tiled3d.sweep_cycle(st.u, st.u, st.locked, 0, 2, 7, k=3, tile=(4, 8, 16))


@pytest.mark.parametrize("n", [1, 2, 3, 5, 37, 50])
def test_update_n_equals_core(n):
    """Every tick schedule (one chunk, a cycle, a cycle plus a remainder)."""
    st = _torch_state((10, 20, 37), t0=3)
    ref = core.update_n(st, n)
    for k, tile in ((2, (4, 8, 16)), (3, hopper_tile3d.TILE), (6, (2, 3, 5))):
        _same(tiled3d.update_n(st, n, k=k, tile=tile), ref)
        cycle_sweeps, n_chunks, tail = tiled3d.tick_schedule(n, k)
        assert cycle_sweeps + tail == n and n_chunks % 2 == 0


@pytest.mark.parametrize("stagger,cap", [(1, 1_000_000), (7, 1_000_000), (100, 1_000_000),
                                         (7, 60), (100, 250), (10, 95), (7, 0)])
def test_solve_and_segments_equal_core(stagger, cap):
    st = _torch_state((8, 12, 20), density=0.05, seed=11, eps=1e-1)
    ref = core.solve(st, stagger, cap)
    for k, tile in ((2, (4, 8, 16)), (5, (3, 5, 7))):
        _same(tiled3d.solve(st, stagger, cap, k=k, tile=tile), ref)
        _same(tiled3d.solve_segments(st, stagger, cap, 37, k=k, tile=tile), ref)


# -- the kernels' z march, modelled in plain torch ------------------------------------

def march_chunk(src, locked, t0, ns, k, tile, descending=False, poison=False):
    """csrc/tile3d.cu's pass, one chunk of ``ns`` sweeps from iteration
    ``t0``, in plain torch: each column segment's extended planes (y and x
    halo ``k``, ``ns`` planes in z at a segment's ends that are not the
    volume's) stream in z order through a ring of ``k + 3`` planes; at step
    ``p`` the next plane lands in its slot, then levels ``l = 1..ns`` run
    in place on plane ``p - l`` (ascending, or ``descending``), each inside
    the xy trapezoid (``l + k - ns`` from the extended plane's edge) and
    the z range, on the class of sweep ``t0 + l - 1``. Level 1 gives the
    delta and u1, level ``ns`` the centre plane. ``poison`` fills what lies
    outside the volume, and every ring slot before its first plane, with
    NaN: the kernels never load it. Returns ``(dst, delta, u1)``."""
    d, h, w = src.shape
    tz, th, tw = tile
    eh, ew, ring = th + 2 * k, tw + 2 * k, k + 3
    ny, nx = -(-h // th), -(-w // tw)
    fill = float("nan") if poison else float(C.LOG_SPACE_OBSTACLE)
    fixed = locked.clone()
    for axis in range(3):
        fixed.select(axis, 0).fill_(True)
        fixed.select(axis, -1).fill_(True)
    # Planes padded by k in y and x (to whole columns), so that a column's
    # extended plane is a window.
    u_pad = src.new_full((d, ny * th + 2 * k, nx * tw + 2 * k), fill)
    u_pad[:, k:k + h, k:k + w] = src
    f_pad = torch.ones(u_pad.shape, dtype=torch.bool)
    f_pad[:, k:k + h, k:k + w] = fixed
    dst, u1 = torch.full_like(src, float("nan")), torch.full_like(src, float("nan"))
    delta = torch.zeros((), dtype=src.dtype)
    ly = torch.arange(eh)[:, None]
    lx = torch.arange(ew)[None, :]
    reach = torch.minimum(torch.minimum(ly, eh - 1 - ly), torch.minimum(lx, ew - 1 - lx))
    inner = (slice(1, -1), slice(1, -1))
    for gz0 in range(0, d, tz):
        cz = min(tz, d - gz0)
        za, zb = max(0, gz0 - ns), min(d, gz0 + cz + ns)
        for gy0 in range(0, h, th):
            for gx0 in range(0, w, tw):
                ch, cw = min(th, h - gy0), min(tw, w - gx0)
                win = (slice(gy0, gy0 + eh), slice(gx0, gx0 + ew))
                cls = (gy0 - k + ly + gx0 - k + lx) % 2
                centre = (slice(k, k + ch), slice(k, k + cw))
                slots = [torch.full((eh, ew), float("nan") if poison else 0.0)
                         for _ in range(ring)]
                slots[za % ring] = u_pad[za][win].clone()
                for p in range(za, gz0 + cz + ns):
                    if p + 1 < zb:
                        slots[(p + 1) % ring] = u_pad[p + 1][win].clone()
                    levels = range(max(1, p - zb + 1), min(ns, p - za) + 1)
                    for lvl in (reversed(levels) if descending else levels):
                        r = p - lvl
                        cur = slots[r % ring]
                        lo = 1 if za == 0 else za + lvl
                        hi = d - 2 if zb == d else zb - 1 - lvl
                        if lo <= r <= hi:
                            below, above = slots[(r - 1) % ring], slots[(r + 1) % ring]
                            val = lse6(below[inner], above[inner], cur[:-2, 1:-1],
                                       cur[2:, 1:-1], cur[1:-1, :-2], cur[1:-1, 2:])
                            upd = ((cls == (r + t0 + lvl - 1) % 2) & ~f_pad[r][win]
                                   & (reach >= lvl + k - ns))[inner]
                            old = cur[inner].clone()
                            cur[inner] = torch.where(upd, val, old)
                            if lvl == 1 and gz0 <= r < gz0 + cz:
                                change = torch.zeros_like(cur)
                                change[inner] = torch.where(upd, (val - old).abs(), 0.0)
                                delta = torch.maximum(delta, change[centre].max())
                        if gz0 <= r < gz0 + cz:
                            out = (r, slice(gy0, gy0 + ch), slice(gx0, gx0 + cw))
                            if lvl == 1:
                                u1[out] = cur[centre]
                            if lvl == ns:
                                dst[out] = cur[centre]
    return dst, delta, u1


# (shape, tile): ragged on every axis, segments shorter than the volume
# (several, the last ragged) and one segment (TZ = D and TZ > D), columns
# narrower than the halo, and the kernels' column.
MARCH_VOLUMES = [((13, 11, 23), (5, 4, 8)), ((9, 14, 19), (9, 6, 10)),
                 ((7, 10, 21), (20, 3, 4)), ((11, 18, 70), (4, *hopper_tile3d.COLUMN))]


def _random_field(shape, seed):
    """A seeded volume with random values everywhere (so every update moves
    its voxel) and 12% locked voxels."""
    u, locked = _arrays(shape, seed=seed)
    rng = np.random.default_rng(seed + 100)
    u = np.where(locked & (u < -1e5), u, rng.uniform(-8.0, 0.0, shape)).astype(np.float32)
    st = TG.make_state(u, locked, 1e-2, device="cpu")
    return st.u, st.locked


@pytest.mark.parametrize("k", range(1, 9))
def test_march_equals_tiled3d_and_core_bit_for_bit(k):
    """The z march gives the plain tile version's and core's bits for every
    depth 1..8, chunk depth 1..k, both start parities, segments shorter and
    longer than the volume, ragged volumes; and with the fill outside the
    volume poisoned, the same bits."""
    for vi, (shape, tile) in enumerate(MARCH_VOLUMES):
        u, locked = _random_field(shape, seed=vi)
        for t0 in (0, 1):
            st = dataclasses.replace(_torch_state(shape), u=u, locked=locked,
                                     iteration=torch.tensor(t0, dtype=torch.int32))
            for ns in sorted({1, (k + 1) // 2, k}):
                if ns > 1 and vi % 2 != t0:
                    continue                    # half the deep chunks: the suite's time
                ref = core.update_n(st, ns)
                dst, delta, u1 = march_chunk(u, locked, t0, ns, k, tile, poison=t0 == 1)
                p_dst, p_delta, p_u1 = tiled3d.sweep_chunk(u, locked, t0, ns, k=k, tile=tile,
                                                           u1=True)
                assert torch.equal(dst, ref.u) and torch.equal(delta, ref.delta)
                assert torch.equal(dst, p_dst) and torch.equal(delta, p_delta)
                assert torch.equal(u1, core.update_n(st, 1).u) and torch.equal(u1, p_u1)


@pytest.mark.parametrize("shape,tile,k", [((13, 11, 23), (5, 4, 8), 3),
                                          ((9, 14, 19), (9, 6, 10), 2)])
def test_march_with_descending_levels_differs(shape, tile, k):
    """Levels in descending order within a step read plane p - l + 1 before
    its level l - 1: other bits. So the ascending order is what makes the
    march equal core, and the test above can fail."""
    u, locked = _random_field(shape, seed=7)
    ref = core.update_n(TG.make_state(u.numpy(), locked.numpy(), 1e-2, device="cpu"), k)
    asc, _, _ = march_chunk(u, locked, 0, k, k, tile)
    desc, _, _ = march_chunk(u, locked, 0, k, k, tile, descending=True)
    assert torch.equal(asc, ref.u)
    assert not torch.equal(desc, ref.u)


def test_tile_rule_cuts_z_to_fill_the_card():
    """tile_for: the column fixed, the depth cut into the segments whose
    rounds over the card's block slots take the fewest steps, none shorter
    than MIN_SEGMENT; volumes whose columns fill the slots keep TZ = D."""
    th, tw = hopper_tile3d.COLUMN
    assert hopper_tile3d.tile_for((256, 256, 256)) == hopper_tile3d.TILE == (32, th, tw)
    assert hopper_tile3d.tile_for((32, 2048, 2048)) == (32, th, tw)    # 1024 columns
    assert hopper_tile3d.tile_for((512, 512, 512)) == (256, th, tw)    # 128 tiles in 1 round
    assert hopper_tile3d.tile_for((30, 256, 256)) == (10, th, tw)      # 48 tiles in 1 round
    assert hopper_tile3d.tile_for((320, 320, 320)) == (80, th, tw)     # 120 tiles in 1 round
    assert hopper_tile3d.tile_for((5, 6, 7)) == (5, th, tw)
    slots = hopper_tile3d.H100_SMS
    for shape in ((256, 256, 256), (160, 160, 160), (999, 70, 70), (40, 37, 150),
                  (448, 448, 448), (64, 1024, 1024)):
        d = shape[0]
        tz, _, _ = hopper_tile3d.tile_for(shape)
        assert tz >= min(d, hopper_tile3d.MIN_SEGMENT)
        columns = -(-shape[1] // th) * -(-shape[2] // tw)

        def cost(tz_):
            return -(-(-(-d // tz_)) * columns // slots) * (tz_ + 2 * hopper_tile3d.DEFAULT_DEPTH)

        assert all(cost(tz) <= cost(-(-d // s)) for s in range(1, d // hopper_tile3d.MIN_SEGMENT + 1))


# -- against epic_tpu's kernels in interpret mode ------------------------------------

def _banded(j, band, k):
    return pallas_biggrid3d.pad_state(j, band=band, k=k)


def _read_banded(g, u_pad):
    return pallas_biggrid3d.unpad(dataclasses.replace(g, u=u_pad))


def _read_tiled(g, u_pad):
    return pallas_tiled3d.unpad(dataclasses.replace(g, u=u_pad))


@pytest.mark.parametrize("shape,band,k", [((13, 9, 140), 4, 3), ((16, 8, 30), 2, 2)])
def test_chunk_matches_banded_chunks(shape, band, k):
    """K8 (sweep_chunk_dma) and T3 (sweep_chunk_bands), chained full and
    shallow chunks, against the port's chunk."""
    j, t = _states(shape, seed=5)
    g = _banded(j, band, k)
    frozen_ext = pallas_biggrid3d.stack_frozen(g.frozen, g.hp, band, k)
    u_dma, u_bands, u = g.u, g.u, t.u
    it = 0
    for depth in (k, 1):
        u_dma, d_dma = pallas_biggrid3d.sweep_chunk_dma(u_dma, g.frozen, jnp.int32(it), depth,
                                                        band, k, g.hp, True)
        u_bands, d_bands = pallas_biggrid3d.sweep_chunk_bands(
            u_bands, frozen_ext, jnp.int32(it), depth, band, k, g.hp, True)
        dst, delta, _ = tiled3d.sweep_chunk(u, t.locked, it, depth, k=k, tile=(4, 4, 64))
        _close(dst, _read_banded(g, u_dma))
        _close(dst, _read_banded(g, u_bands))
        _close(float(delta), float(d_dma), DELTA)
        _close(float(delta), float(d_bands), DELTA)
        u, it = dst, it + depth


def test_chunk_matches_tiled_slab_chunks():
    """K10 (sweep_chunk_tiled3d) and its check variant's centres and u1."""
    shape, band, k, yt, wt = (8, 18, 140), 4, 2, 16, 128
    j, t = _states(shape, seed=3)
    g = pallas_tiled3d.pad_state(j, band=band, k=k, yt=yt, wt=wt)
    u_pad, u = g.u, t.u
    d, h, w = shape
    it = 1
    for depth in (k, 1):
        out_uk, out_u1, d_check = pallas_tiled3d.sweep_chunk_tiled3d_check(
            u_pad, g.frozen, jnp.int32(it), depth, band, k, yt, wt, g.hp2, True)
        u_pad, d_pad = pallas_tiled3d.sweep_chunk_tiled3d(u_pad, g.frozen, jnp.int32(it), depth,
                                                          band, k, yt, wt, g.hp2, True)
        dst, delta, u1 = tiled3d.sweep_chunk(u, t.locked, it, depth, k=k, tile=(3, 7, 32),
                                             u1=True)
        _close(dst, _read_tiled(g, u_pad))
        _close(dst, out_uk[:d, :h, :w])
        _close(u1, out_u1[:d, :h, :w])
        _close(float(delta), float(d_pad), DELTA)
        assert float(d_pad) == float(d_check)
        u, it = dst, it + depth


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
def test_cycle_matches_banded_cycles(n_chunks):
    """K9: sweep_cycle3d (odd and even chains, per-chunk deltas)."""
    shape, band, k = (24, 10, 20), 4, 2
    j, t = _states(shape, seed=5)
    g = _banded(j, band, k)
    a, b, deltas = pallas_cycle.sweep_cycle3d(g.u, jnp.copy(g.u), g.frozen, jnp.int32(0),
                                              n_chunks, k, band, g.hp, True)
    pa, pb, pd = tiled3d.sweep_cycle(t.u, t.u, t.locked, 0, n_chunks, k=k, tile=(8, 4, 8))
    final, theirs = (pb, b) if n_chunks % 2 else (pa, a)
    _close(final, _read_banded(g, theirs))
    _close(pd.numpy(), np.asarray(deltas), DELTA)


@pytest.mark.parametrize("n_chunks", [1, 2, 3])
def test_cycle_matches_tiled_cycles(n_chunks):
    """K11: sweep_cycle_tiled3d (odd and even chains, per-chunk deltas)."""
    shape, band, k, yt, wt = (10, 20, 150), 2, 2, 8, 128
    j, t = _states(shape, seed=11)
    g = pallas_tiled3d.pad_state(j, band=band, k=k, yt=yt, wt=wt)
    a, b, deltas = pallas_cycle.sweep_cycle_tiled3d(g.u, jnp.copy(g.u), g.frozen, jnp.int32(0),
                                                    n_chunks, k, band, yt, wt, g.hp2, True)
    pa, pb, pd = tiled3d.sweep_cycle(t.u, t.u, t.locked, 0, n_chunks, k=k,
                                     tile=hopper_tile3d.tile_for(shape))
    final, theirs = (pb, b) if n_chunks % 2 else (pa, a)
    _close(final, _read_tiled(g, theirs))
    _close(pd.numpy(), np.asarray(deltas), DELTA)


@pytest.mark.parametrize("module,shape", [(pallas_biggrid3d, (20, 12, 24)),
                                          (pallas_tiled3d, (6, 26, 140))],
                         ids=["biggrid3d", "tiled3d"])
def test_update_n_matches_epic_tpu(module, shape):
    j, t = _states(shape, density=0.05, seed=13, t0=4)
    theirs = module.update_n(j, 11, chunk_depth=4)
    ours = hopper_tile3d.update_n(t, 11)          # a CPU state: the plain version
    _close(ours.u, theirs.u)
    _close(float(ours.delta), float(theirs.delta), DELTA)
    assert int(ours.iteration) == int(theirs.iteration) == 15


@pytest.mark.parametrize("module,shape,stagger", [(pallas_biggrid3d, (14, 10, 18), 7),
                                                  (pallas_tiled3d, (6, 26, 140), 10),
                                                  (pallas_tiled3d, (6, 26, 140), 1)],
                         ids=["biggrid3d-7", "tiled3d-10", "tiled3d-1"])
def test_solve_matches_epic_tpu(module, shape, stagger):
    """The protocol through both TPU solve loops: _solve_banded's 1-sweep
    check and _solve_tiled3d's check folded into a chunk."""
    j, t = _states(shape, density=0.05, seed=9, eps=1e-1)
    theirs = module.solve(j, stagger=stagger)
    ours = hopper_tile3d.solve(t, stagger)
    assert int(ours.iteration) == int(theirs.iteration)
    assert int(ours.iteration) % stagger == 1 % stagger
    assert bool(ours.converged) and bool(theirs.converged)
    _close(ours.u, theirs.u)
    _close(float(ours.delta), float(theirs.delta), DELTA)


@pytest.mark.parametrize("module", [pallas_biggrid3d, pallas_tiled3d],
                         ids=["biggrid3d", "tiled3d"])
def test_solve_segments_match_epic_tpu(module):
    """The port's segments are its own one solve, bit for bit, and stop at
    epic_tpu's iteration, converged or capped mid-segment."""
    for eps, cap in ((1e-2, 1_000_000), (1e-8, 85)):
        j, t = _states((5, 26, 140), density=0.08, seed=3, eps=eps)
        theirs = module.solve_segments(j, stagger=10, max_iterations=cap, segment_iterations=37)
        seg = hopper_tile3d.solve_segments(t, 10, cap, 37)
        one = hopper_tile3d.solve(t, 10, cap)
        _same(seg, one)
        assert int(seg.iteration) == int(theirs.iteration)
        assert bool(seg.converged) == bool(theirs.converged) == (cap > 100)
        _close(seg.u, theirs.u)


# -- routing ---------------------------------------------------------------------------

# Every volume tile_probe.py --volumes ran on an H100 80GB HBM3 at 700 W
# (PERF.md): K7's z walk as fast or faster than the tiles on each (640^3 a
# tie within 1%), within the L2, cubes, deep volumes and wide planes.
MEASURED_VOLUMES = ((30, 256, 256), (64, 256, 256), (160, 160, 160), (192, 192, 192),
                    (224, 224, 224), (256, 256, 256), (320, 320, 320), (384, 384, 384),
                    (448, 448, 448), (512, 512, 512), (640, 640, 640), (768, 768, 768),
                    (1024, 384, 384), (1536, 384, 384), (2048, 320, 320), (2048, 384, 384),
                    (2048, 448, 448), (1024, 512, 512), (2048, 256, 256), (64, 1024, 1024),
                    (32, 1448, 1448), (128, 1448, 1448), (16, 2048, 2048), (32, 2048, 2048),
                    (8, 4096, 4096), (576, 576, 576), (1024, 768, 768), (512, 1024, 1024))


def test_every_volume_runs_on_the_z_walk(monkeypatch):
    """The 3D rule: solver.update_volume and solve_volume (and the grid
    entries for rank 3) hand every volume on the card to hopper_sweep3d
    (K7), whatever its shape and whatever chunk_depth or segment_iterations
    ask; the tile entries run only when called. The volume is a stand-in
    with a shape on a CUDA device and no storage."""
    calls = []
    monkeypatch.setattr(hopper_sweep3d, "update_n",
                        lambda st, n: calls.append(("update_n", st.u.shape, n)) or st)
    monkeypatch.setattr(hopper_sweep3d, "solve",
                        lambda st, stagger, cap: calls.append(("solve", st.u.shape, cap)) or st)

    def refuse(*args, **kwargs):
        raise AssertionError("a volume went to the 3D tiles")

    for name in ("update_n", "solve", "solve_segments", "sweep_chunk", "sweep_cycle"):
        monkeypatch.setattr(hopper_tile3d, name, refuse)
    base = _torch_state((3, 3, 3), seed=0)
    for shape in MEASURED_VOLUMES:
        u = types.SimpleNamespace(shape=shape, ndim=3, device=torch.device("cuda"))
        st = dataclasses.replace(base, u=u)
        calls.clear()
        assert TS.update_volume(st, 9, chunk_depth=3) is st
        assert TS.update_grid(st, 9, 3) is st
        assert TS.solve_volume(st, 10, 500, segment_iterations=100, chunk_depth=3) is st
        assert TS.solve_grid(st, 10, 500, segment_iterations=100) is st
        assert calls == [("update_n", shape, 9)] * 2 + [("solve", shape, 500)] * 2


def test_depth_is_checked_against_shared_memory():
    """A block's ring of K + 3 extended planes with their guard rows, 4 B a
    voxel, against the card's shared memory; every depth up to the kernels'
    deepest fits an H100's, the next does not, and none above the deepest
    is taken whatever the shared memory."""
    h100 = 232_448                                  # an H100 block's opt-in shared memory
    th, tw = hopper_tile3d.COLUMN
    assert hopper_tile3d.smem_bytes(2) == 5 * (th + 6) * 2 * (-(-(tw + 4) // 8) * 4) * 4
    for k in range(1, hopper_tile3d.MAX_DEPTH + 1):
        hopper_tile3d.check_depth(k, h100)
    for k in (hopper_tile3d.MAX_DEPTH + 1, 16):
        with pytest.raises(ValueError, match="shared memory"):
            hopper_tile3d.check_depth(k, h100)
    with pytest.raises(ValueError, match="at most"):
        hopper_tile3d.check_depth(hopper_tile3d.MAX_DEPTH + 1, 100 * h100)
    with pytest.raises(ValueError, match=">= 1"):
        hopper_tile3d.check_depth(0, h100)


def test_volume_entries_on_the_cpu_run_core():
    """solve_volume/update_volume (and solve_grid/update_grid for rank 3)
    on the CPU run core, whatever chunk_depth or segment_iterations say,
    and launch nothing."""
    st = _torch_state((10, 20, 37), seed=2, t0=3)
    tick, ref = core.update_n(st, 9), core.solve(st, 10, 95)
    before = (dict(core.calls), dict(tiled3d.calls), dict(hopper_tile3d.launches),
              dict(hopper_sweep3d.launches))
    _same(TS.update_volume(st, 9, chunk_depth=3), tick)
    _same(TS.update_grid(st, 9, 3), tick)
    _same(TS.solve_volume(st, 10, 95, segment_iterations=37, chunk_depth=3), ref)
    _same(TS.solve_grid(st, 10, 95, segment_iterations=37), ref)
    assert core.calls["update_n"] == before[0]["update_n"] + 2
    assert core.calls["solve"] == before[0]["solve"] + 2
    assert (tiled3d.calls, hopper_tile3d.launches, hopper_sweep3d.launches) == before[1:]


def test_volume_planner_on_the_cpu_runs_core():
    """Routing is by device: on the CPU a VolumePlanner ticks and solves with
    core and launches nothing."""
    rng = np.random.default_rng(4)
    occ = np.where(rng.random((12, 20, 28)) < 0.05, 100, 0).astype(np.int8)
    occ[6, 10, 14] = 0
    before = (dict(core.calls), dict(tiled3d.calls), dict(hopper_tile3d.launches),
              dict(hopper_sweep3d.launches))
    tp = VolumePlanner(VolumePlannerConfig(epsilon=1e-2, steps_per_update=25), device="cpu")
    tp.update_occupancy(occ)
    assert tp.add_goals([(14.0, 10.0, 6.0)])
    ref = tp.state
    tp.update()
    tp.solve()
    assert core.calls["update_n"] == before[0]["update_n"] + 1
    assert core.calls["solve"] == before[0]["solve"] + 1
    assert (tiled3d.calls, hopper_tile3d.launches, hopper_sweep3d.launches) == before[1:]
    _same(tp.state, core.solve(core.update_n(ref, 25)))
    assert bool(tp.state.converged)
