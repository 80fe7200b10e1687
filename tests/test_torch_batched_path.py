"""epic_tpu_torch's batched walkers against epic_tpu's (batched_path.walk,
batched_path3d.walk), on the same field bits: a maze solved by the JAX core
in 2D (both corner modes), volumes solved by it in 3D.

Against the JAX walker run op by op (``jax.disable_jit``, a few dozen
steps, since eager JAX is slow) every output is bit-equal: both run the same
float32 ops in the same order. Against the jitted walker, per lane
``lengths``, ``reached_goal`` and ``terminated`` are equal and positions
agree within POS_ATOL: XLA fuses some multiply-adds, so a coordinate's last
bit may differ, and the walk carries that along (the reference corner mode,
which extrapolates, amplifies it to about 1e-2 over a few hundred steps).
The early stop of the port's eager loop changes nothing: a run without it
gives the same bits.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epic_tpu import grid as JG
from epic_tpu import maps
from epic_tpu.solver import batched_path as jbp
from epic_tpu.solver import batched_path3d as jbp3
from epic_tpu.solver import core as jcore
from epic_tpu_torch.solver import batched_path, batched_path3d

POS_ATOL = 0.05   # a quarter of the 0.2 step


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and torch's default of one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def maze_field():
    img = maps.recursive_maze(40, 40, seed=2)
    st = jcore.solve(JG.from_occupancy_image(img, 1e-2))
    u, locked = np.array(st.u), np.array(st.locked)
    rng = np.random.default_rng(0)
    ys, xs = np.nonzero(~locked)
    pick = rng.choice(len(ys), 14, replace=False)
    starts = np.stack([xs[pick] + rng.uniform(-0.4, 0.4, 14),
                       ys[pick] + rng.uniform(-0.4, 0.4, 14)], 1)
    # Two invalid lanes: off the map and on an obstacle cell.
    oy, ox = np.argwhere(img == 0)[5]
    starts = np.concatenate([starts, [[-3.0, 5.0], [float(ox), float(oy)]]]).astype(np.float32)
    return u, locked, starts


def _volume_field(density):
    rng = np.random.default_rng(7)
    d, h, w = 12, 16, 20
    u = np.full((d, h, w), -1e6, np.float32)
    locked = np.zeros((d, h, w), bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    locked |= rng.random((d, h, w)) < density
    u[6, 8, 10], locked[6, 8, 10] = 0.0, True
    st = jcore.solve(JG.make_state(u, locked, 1e-3), 100)
    u, locked = np.array(st.u), np.array(st.locked)
    zs, ys, xs = np.nonzero(~locked)
    pick = rng.choice(len(zs), 12, replace=False)
    starts = np.stack([xs[pick] + 0.3, ys[pick] - 0.2, zs[pick] + 0.1], 1)
    starts = np.concatenate([starts, [[-1.0, -1.0, -1.0], [30.0, 2.0, 2.0]]]).astype(np.float32)
    return u, locked, starts


def _assert_lanes_match(ours, theirs, end_key):
    for k in ("lengths", "reached_goal", "terminated"):
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(theirs[k]), err_msg=k)
    np.testing.assert_allclose(ours["positions"].numpy(), np.asarray(theirs["positions"]),
                               rtol=0, atol=POS_ATOL)
    np.testing.assert_allclose(ours[end_key].numpy(), np.asarray(theirs[end_key]),
                               rtol=0, atol=POS_ATOL)


def _assert_same_bits(ours, theirs):
    for k, v in ours.items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(theirs[k]), err_msg=k)


@pytest.mark.parametrize("mode", ["bilinear", "reference"])
def test_2d_walker_matches_jax_op_by_op(maze_field, mode):
    u, locked, starts = maze_field
    kw = dict(step_size=0.2, cd_precision=0.4, max_steps=40, mode=mode)
    with jax.disable_jit():
        theirs = jbp.walk(jnp.asarray(u), jnp.asarray(locked), jnp.asarray(starts), **kw)
    _assert_same_bits(batched_path.walk(torch.from_numpy(u), torch.from_numpy(locked),
                                        starts, **kw), theirs)


def test_3d_walker_matches_jax_op_by_op():
    u, locked, starts = _volume_field(0.1)
    kw = dict(step_size=0.2, cd_precision=0.4, max_steps=24)
    with jax.disable_jit():
        theirs = jbp3.walk(jnp.asarray(u), jnp.asarray(locked), jnp.asarray(starts), **kw)
    _assert_same_bits(batched_path3d.walk(torch.from_numpy(u), torch.from_numpy(locked),
                                          starts, **kw), theirs)


@pytest.mark.parametrize("mode", ["bilinear", "reference"])
def test_2d_walker_matches_jax(maze_field, mode):
    u, locked, starts = maze_field
    kw = dict(step_size=0.2, cd_precision=0.4, max_steps=600, mode=mode)
    theirs = jbp.walk(u, locked, starts, **kw)
    ours = batched_path.walk(torch.from_numpy(u), torch.from_numpy(locked), starts, **kw)
    _assert_lanes_match(ours, theirs, "end_xy")
    lengths = ours["lengths"].numpy()
    assert lengths[-2] == 1 and lengths[-1] == 1          # invalid starts never walk
    assert ours["reached_goal"].numpy().sum() >= 4
    assert ours["positions"].shape == (len(starts), 601, 2)


@pytest.mark.parametrize("density", [0.0, 0.1])
def test_3d_walker_matches_jax(density):
    u, locked, starts = _volume_field(density)
    kw = dict(step_size=0.2, cd_precision=0.4, max_steps=400)
    theirs = jbp3.walk(u, locked, starts, **kw)
    ours = batched_path3d.walk(torch.from_numpy(u), torch.from_numpy(locked), starts, **kw)
    _assert_lanes_match(ours, theirs, "end_xyz")
    assert ours["lengths"].numpy()[-2:].tolist() == [1, 1]
    if density == 0.0:
        assert ours["reached_goal"].numpy()[:-2].all()


def test_early_stop_changes_nothing(maze_field, monkeypatch):
    """All lanes stop long before the budget; the loop that stops early and
    the loop that runs every step give the same bits."""
    u, locked, starts = maze_field
    ut, lt = torch.from_numpy(u), torch.from_numpy(locked)
    kw = dict(step_size=0.2, cd_precision=0.4, max_steps=3000)
    early = batched_path.walk(ut, lt, starts, **kw)
    vol_u, vol_locked, vol_starts = _volume_field(0.0)
    early3 = batched_path3d.walk(torch.from_numpy(vol_u), torch.from_numpy(vol_locked),
                                 vol_starts, **kw)
    assert early["terminated"].all() and early3["terminated"].all()
    monkeypatch.setattr(batched_path, "CHECK_EVERY", 10**9)
    monkeypatch.setattr(batched_path3d, "CHECK_EVERY", 10**9)
    full = batched_path.walk(ut, lt, starts, **kw)
    full3 = batched_path3d.walk(torch.from_numpy(vol_u), torch.from_numpy(vol_locked),
                                vol_starts, **kw)
    for a, b in ((early, full), (early3, full3)):
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_walker_without_trajectories_and_bad_mode(maze_field):
    u, locked, starts = maze_field
    ut, lt = torch.from_numpy(u), torch.from_numpy(locked)
    out = batched_path.walk(ut, lt, starts, 0.2, 0.4, 300, record_trajectories=False)
    ref = batched_path.walk(ut, lt, starts, 0.2, 0.4, 300)
    assert "positions" not in out
    for k in ("lengths", "reached_goal", "terminated", "end_xy"):
        assert torch.equal(out[k], ref[k])
    with pytest.raises(ValueError):
        batched_path.walk(ut, lt, starts, mode="nearest")
