"""The walk of the 3D in-place kernels (csrc/sweep3d.cu, K7) on the CPU.

``hopper_sweep3d.plan`` mirrors the C entries' plan and ``walk_cells`` the
kernels' index arithmetic (quads of 8 voxels, patches of rows, segments of
planes, row ends, the class offset, whole-half stores). These tests hold
them to the interior and its class: a sweep of class q updates every
interior voxel with (z + y + x) % 2 == q exactly once and no other voxel,
and writes no shell voxel. The card tests in tests/test_torch_cuda.py hold
the C plan to ``plan`` and the kernels to core bit for bit. Here the CPU
route of the wrapper (the plain version) is also held to ``epic_tpu``'s K7
(``pallas_sweep3d`` in interpret mode) on the ragged widths, with the
tolerances of tests/test_torch_volume.py (the f32 log(4)/exp ulp between
the packages), and the package's top-level exports are checked.
"""

import dataclasses
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from epic_tpu import grid as JG
from epic_tpu.solver import pallas_sweep3d
import epic_tpu_torch
from epic_tpu_torch import grid as TG
from epic_tpu_torch.solver import hopper_sweep3d as H

FIELD = dict(rtol=2e-6, atol=1e-3)
DELTA = dict(rtol=1e-5, atol=1e-5)
# Ragged and aligned widths: rows of 3..8 voxels, a half quad at a row end
# (W % 8 == 4), whole quads, and the widths that W % 4 != 0 walks voxel by voxel.
WIDTHS = (3, 4, 5, 8, 9, 16, 17, 131, 256)


def _classes(shape, q):
    d, h, w = shape
    z, y, x = np.indices(shape)
    interior = (z > 0) & (z < d - 1) & (y > 0) & (y < h - 1) & (x > 0) & (x < w - 1)
    return interior, interior & ((z + y + x) % 2 == q)


def _assert_walk(shape, q, slots=H.H100_SLOTS):
    p = H.plan(shape, slots)
    updates, writes = H.walk_cells(shape, q, p)
    interior, cls = _classes(shape, q)
    np.testing.assert_array_equal(updates, cls.astype(np.int64))
    assert writes.max(initial=0) <= 1                 # no voxel written twice a sweep
    assert not (writes.astype(bool) & ~interior).any()   # never the shell
    assert (writes.astype(bool) | ~cls).all()         # every update is stored


def _assert_plan(shape, p, slots):
    d, h, w = shape
    if min(shape) < 3:
        assert p.units == 0
        return
    n, qw = d - 2, -(-w // 8)
    assert p.units == p.segments * p.nb * p.nrb
    assert (p.segments - 1) * p.tz < n <= p.segments * p.tz
    assert p.pw <= H.MAX_BAND and p.nb * p.pw >= qw > (p.nb - 1) * p.pw
    assert p.rb * p.pw <= H.THREADS and p.nrb * p.rb >= h - 2
    assert 1 <= p.blocks <= min(max(p.units, 1), slots)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(d=st.integers(3, 140), h=st.integers(3, 140), w=st.integers(3, 140),
       q=st.integers(0, 1), slots=st.sampled_from([1, 7, 132, H.H100_SLOTS]))
def test_walk_visits_each_interior_class_voxel_once(d, h, w, q, slots):
    shape = (d, h, w)
    _assert_plan(shape, H.plan(shape, slots), slots)
    _assert_walk(shape, q, slots)


@pytest.mark.parametrize("q", [0, 1])
@pytest.mark.parametrize("w", WIDTHS)
def test_walk_on_ragged_and_aligned_widths(w, q):
    for d, h in ((3, 3), (5, 9), (12, 40)):
        _assert_walk((d, h, w), q)


@pytest.mark.parametrize("shape", [(30, 256, 256), (64, 256, 256), (256, 256, 256),
                                   (32, 2048, 2048), (4, 1448, 1452)])
def test_plan_of_the_main_path_volumes(shape):
    """The volumes chip_smoke.py and tile_probe.py run: a valid plan on an
    H100's slots that keeps every block busy in its first round."""
    p = H.plan(shape)
    _assert_plan(shape, p, H.H100_SLOTS)
    assert p.blocks == min(p.units, H.H100_SLOTS)


def test_walk_of_a_small_in_l2_shape_in_full():
    """The 30 x 256 x 256 session volume's walk, both classes."""
    for q in (0, 1):
        _assert_walk((30, 256, 256), q)


def test_plan_without_an_interior_has_no_units():
    for shape in ((2, 9, 9), (9, 2, 9), (9, 9, 2)):
        p = H.plan(shape)
        assert p.units == 0 and p.blocks == 1
        updates, writes = H.walk_cells(shape, 0, p)
        assert not updates.any() and not writes.any()


def test_check_aligned_refuses_a_misaligned_volume():
    u = torch.zeros(4 * 5 * 8 + 1)[1:].view(4, 5, 8)        # 4 bytes past an aligned start
    locked = torch.zeros(4 * 5 * 8 + 1, dtype=torch.bool)[1:].view(4, 5, 8)
    ok_u, ok_l = torch.zeros(4, 5, 8), torch.zeros(4, 5, 8, dtype=torch.bool)
    assert ok_u.data_ptr() % H.U_ALIGN == 0 and ok_l.data_ptr() % H.LOCKED_ALIGN == 0
    H.check_aligned(ok_u, ok_l)
    with pytest.raises(ValueError, match="u aligned to 16"):
        H.check_aligned(u, ok_l)
    with pytest.raises(ValueError, match="locked aligned to 4"):
        H.check_aligned(ok_u, locked)


def _state_pair(shape, seed, t0):
    d, h, w = shape
    rng = np.random.default_rng(seed)
    u = np.full(shape, -1e6, np.float32)
    locked = rng.random(shape) < 0.1
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    u[d // 2, h // 2, w // 2] = 0.0
    locked[d // 2, h // 2, w // 2] = True
    j = dataclasses.replace(JG.make_state(u, locked, 1e-2), iteration=jnp.int32(t0))
    return j, TG.state_from_numpy(TG.state_to_numpy(j), device="cpu")


@pytest.mark.parametrize("w", [3, 5, 8, 9, 17])
def test_cpu_route_matches_jax_k7_on_ragged_widths(w):
    """The wrapper's CPU route (the plain version) against K7 in interpret
    mode: a 3-sweep tick from an odd iteration and a solve."""
    j, t = _state_pair((6, 7, w), w, 1)
    k7 = pallas_sweep3d.update_n(j, 3, interpret=True)
    out = H.update_n(t, 3)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(k7.u), **FIELD)
    np.testing.assert_allclose(float(out.delta), float(k7.delta), **DELTA)
    j, t = _state_pair((6, 7, w), w, 0)
    k7 = pallas_sweep3d.solve(j, 10, interpret=True)
    out = H.solve(t, 10)
    assert int(out.iteration) == int(k7.iteration) and bool(out.converged)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(k7.u), **FIELD)


def test_mesh_planner_is_exported_and_import_leaves_jax_out():
    assert epic_tpu_torch.MeshPlanner is epic_tpu_torch.planner_mesh.MeshPlanner
    assert "MeshPlanner" in epic_tpu_torch.__all__
    code = ("import sys, epic_tpu_torch; assert epic_tpu_torch.MeshPlanner; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'epic_tpu.'))"
            " or m == 'epic_tpu']; assert not bad, bad")
    root = pathlib.Path(__file__).resolve().parents[1]
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True, timeout=120)
