"""epic_tpu_torch.VolumePlanner against epic_tpu.planner3d.VolumePlanner:
one session, step by step, on a 16 x 20 x 24 volume (tests/test_planner3d.py's
fixture). The JAX planner runs with backend="pallas", which on the CPU runs
the Pallas kernel the port replaces (K7, pallas_sweep3d) in interpret mode;
the port runs its plain version on the CPU.

Tolerances: fields rtol=2e-6, atol=1e-3 (the two packages' CPU exp differ by
an ulp), iteration counts equal. Walks on the same field bits through the
port's path3d are bit-exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

from epic_tpu import constants as JC
from epic_tpu import path3d as jpath3d
from epic_tpu.planner3d import VolumePlanner as JVolumePlanner
from epic_tpu.planner3d import VolumePlannerConfig as JVolumePlannerConfig
import epic_tpu_torch as T
from epic_tpu_torch import path3d
from epic_tpu_torch.errors import EpicError, InvalidLocationError
from epic_tpu_torch.planner3d import VolumePlanner, VolumePlannerConfig

FIELD = dict(rtol=2e-6, atol=1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and torch's default of one OpenMP thread per core oversubscribes them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**kw):
    jp = JVolumePlanner(JVolumePlannerConfig(backend="pallas", **kw))
    tp = VolumePlanner(VolumePlannerConfig(**kw), device="cpu")
    for p in (jp, tp):
        p.init(24, 20, 16)   # width, height, depth
    return jp, tp


def _assert_fields(jp, tp):
    np.testing.assert_allclose(tp.state.u.numpy(), np.asarray(jp.state.u), **FIELD)
    np.testing.assert_array_equal(tp.state.locked.numpy(), np.asarray(jp.state.locked))
    assert int(tp.state.iteration) == int(jp.state.iteration)


def test_session_matches_jax_planner_on_its_pallas_kernel():
    jp, tp = _pair(epsilon=1e-2, steps_per_update=25)
    _assert_fields(jp, tp)
    for p in (jp, tp):
        assert p.add_goals([(12.0, 10.0, 8.0)])
        assert not p.add_goals([(0.0, 6.0, 6.0)])        # the shell is an obstacle
    for _ in range(4):
        jp.update()
        tp.update()
    _assert_fields(jp, tp)
    for p in (jp, tp):                                     # an obstacle edit mid-session
        p.set_cells([(6, 6, 6), (7, 6, 6), (99, 1, 1)], [JC.CELL_TYPE_OBSTACLE] * 3)
        p.update(13)
    _assert_fields(jp, tp)
    assert tp.get_cell(6, 6, 6) == jp.get_cell(6, 6, 6) == -1e6
    for p in (jp, tp):                                     # the cold restart
        p.reset_free_cells()
        p.update(9)
    _assert_fields(jp, tp)
    jp.solve()
    tp.solve()
    assert bool(tp.state.converged) and bool(jp.state.converged)
    _assert_fields(jp, tp)
    assert tp.get_cell(12, 10, 8) == 0.0
    for start in [(4.0, 4.0, 4.0), (20.0, 15.0, 12.0)]:
        ours = tp.compute_path(start, step_size=0.2, cd_precision=0.4)
        theirs = jp.compute_path(start, step_size=0.2, cd_precision=0.4)
        assert dataclasses.astuple(ours[0]) == dataclasses.astuple(theirs[0])
        assert abs(ours[-1].x - theirs[-1].x) < 1.0 and abs(ours[-1].z - theirs[-1].z) < 1.0
        end = ours[-1]
        assert abs(end.x - 12) < 2 and abs(end.y - 10) < 2 and abs(end.z - 8) < 2


def test_walks_on_jax_field_bits_are_bit_exact():
    """The same field bits through both 3D walkers give the same points."""
    jp = JVolumePlanner(JVolumePlannerConfig(backend="xla", epsilon=1e-2))
    jp.init(24, 20, 16)
    jp.set_cells([(5, 5, 5), (5, 6, 5), (14, 12, 9)], [JC.CELL_TYPE_OBSTACLE] * 3)
    jp.add_goals([(12.0, 10.0, 8.0)])
    jp.solve()
    u, locked = np.asarray(jp.state.u), np.asarray(jp.state.locked)
    rng = np.random.default_rng(3)
    zs, ys, xs = np.nonzero(~locked)
    compared = 0
    for i in rng.choice(len(zs), 12, replace=False):
        args = (float(xs[i]) + 0.3, float(ys[i]) - 0.2, float(zs[i]) + 0.1, 0.2, 0.4, 100_000)
        try:
            theirs = jpath3d.compute_path(u, locked, *args)
        except Exception as e:  # the port raises its own class of the same name
            with pytest.raises(EpicError) as ours_err:
                path3d.compute_path(u, locked, *args)
            assert type(ours_err.value).__name__ == type(e).__name__
            continue
        ours = path3d.compute_path(u, locked, *args)
        assert ours.shape == theirs.shape and np.max(np.abs(ours - theirs)) == 0.0
        assert path3d.path_reaches_goal(u, locked, ours) == jpath3d.path_reaches_goal(u, locked, theirs)
        compared += 1
    assert compared >= 8


def test_compute_paths_batch_matches_jax():
    """Batched 3D paths: the same lanes are None (invalid start), the rest
    end where the JAX walker's end."""
    jp, tp = _pair(epsilon=1e-2)
    for p in (jp, tp):
        p.add_goals([(12.0, 10.0, 8.0)])
        p.solve()
    starts = [(4.0, 4.0, 4.0), (-5.0, 1.0, 1.0), (20.0, 15.0, 12.0), (0.0, 0.0, 0.0)]
    ours = tp.compute_paths_batch(starts, step_size=0.2, cd_precision=0.4, max_steps=600)
    theirs = jp.compute_paths_batch(starts, step_size=0.2, cd_precision=0.4, max_steps=600)
    assert [p is None for p in ours] == [p is None for p in theirs] == [False, True, False, True]
    for a, b in zip(ours, theirs):
        if a is not None:
            assert len(a) == len(b)
            assert abs(a[-1].x - b[-1].x) < 0.05 and abs(a[-1].z - b[-1].z) < 0.05
            assert abs(a[-1].x - 12) < 2 and abs(a[-1].y - 10) < 2 and abs(a[-1].z - 8) < 2


def test_occupancy_ingest_matches_jax():
    jp, tp = _pair(epsilon=1e-2)
    rng = np.random.default_rng(2)
    data = rng.choice(np.array([0, 100, JC.OCCUPANCY_NO_CHANGE], np.int8), size=(16, 20, 24),
                      p=[.8, .15, .05])
    for p in (jp, tp):
        p.add_goals([(12.0, 10.0, 8.0)])
        p.update_occupancy(data, resolution=1.0, origin=(0.0, 0.0, 0.0))
    _assert_fields(jp, tp)
    assert tp.get_cell(12, 10, 8) == 0.0                  # the goal survived
    for p in (jp, tp):                                    # a resize reinitialises
        p.update_occupancy(np.zeros((10, 12, 14), np.int8))
    _assert_fields(jp, tp)


def test_verbs_transforms_and_errors():
    tp = VolumePlanner(VolumePlannerConfig(epsilon=1e-2, resolution=0.5, origin_x=-2.0,
                                           origin_y=1.0, origin_z=0.25), device="cpu")
    with pytest.raises(EpicError):
        tp.get_cell(0, 0, 0)
    tp.init(20, 20, 20)
    assert tp.world_to_map(-1.0, 2.0, 1.25) == (2.0, 2.0, 2.0)
    assert tp.map_to_world(2.0, 2.0, 2.0) == (-1.0, 2.0, 1.25)
    with pytest.raises(InvalidLocationError):
        tp.world_to_map(100.0, 0.0, 0.0)
    with pytest.raises(InvalidLocationError):
        tp.get_cell(20, 0, 0)
    assert tp.add_goals([(3.0, 6.0, 5.0)])
    assert tp.remove_goals([(3.0, 6.0, 5.0), (500.0, 0.0, 0.0)])
    assert not bool(tp.state.locked[9, 10, 10])
    tp.set_status(True)
    tp.update()
    assert int(tp.state.iteration) == 0
    tp.set_status(False)
    tp.update(7)
    assert int(tp.state.iteration) == 7
    tp.solve(max_iterations=3)
    assert not bool(tp.state.converged) and int(tp.state.iteration) == 100
    with pytest.raises(ValueError):
        VolumePlannerConfig(backend="pallas")
    assert isinstance(T.VolumePlanner(device="cpu").config, T.VolumePlannerConfig)
