"""The port's checkpoints (epic_tpu_torch.checkpoint): tests/test_maps_checkpoint.py's
cases on the port, and checkpoints crossing between the two packages in
both directions with the same bits (the same npz keys)."""

import numpy as np
import pytest
import torch

import epic_tpu
from epic_tpu import checkpoint as jcheckpoint
from epic_tpu import maps
from epic_tpu.planner import Planner as JPlanner
from epic_tpu.planner import PlannerConfig as JPlannerConfig
from epic_tpu.solver import core as jcore
import epic_tpu_torch as T
from epic_tpu_torch import checkpoint
from epic_tpu_torch.planner import Planner, PlannerConfig
from epic_tpu_torch.solver import core


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same_state(a, b):
    """Two states (either package's) with the same bits in every field."""
    for k in ("u", "locked", "iteration", "delta", "converged", "epsilon"):
        x, y = T.state_to_numpy(a)[k], T.state_to_numpy(b)[k]
        assert x.dtype == y.dtype, k
        np.testing.assert_array_equal(x, y, err_msg=k)


def test_checkpoint_resume_equals_continuous(tmp_path):
    img = maps.random_obstacles(24, 24, density=0.1, seed=2)
    mid = core.update_n(T.from_occupancy_image(img, 1e-3, device="cpu"), 7)
    checkpoint.save(tmp_path / "ck.npz", mid)
    resumed = checkpoint.load(tmp_path / "ck.npz", device="cpu")
    _same_state(resumed, mid)
    assert int(resumed.iteration) == 7
    a, b = core.update_n(mid, 5), core.update_n(resumed, 5)
    assert torch.equal(a.u, b.u) and float(a.delta) == float(b.delta)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_state_checkpoint_crosses_packages(tmp_path, direction):
    """A mid-relaxation state saved by one package loads in the other with
    the same bits; both go on to the same solve (iterations equal)."""
    img = maps.recursive_maze(48, 48, seed=1)
    f = tmp_path / "ck.npz"
    if direction == "port_to_jax":
        src = core.update_n(T.from_occupancy_image(img, 1e-3, device="cpu"), 11)
        checkpoint.save(f, src)
        dst = jcheckpoint.load(f)
    else:
        src = jcore.update_n(epic_tpu.from_occupancy_image(img, epsilon=1e-3), 11)
        jcheckpoint.save(f, src)
        dst = checkpoint.load(f, device="cpu")
    _same_state(src, dst)
    with np.load(f) as z:
        assert set(z.files) == {"u", "locked", "iteration", "delta", "converged", "epsilon"}


def _session(pl):
    pl.init(32, 32)
    pl.add_goals([(6.0, 11.0)])   # world coords through the transform
    pl.update(101)
    pl.set_status(True)
    return pl


def test_planner_session_checkpoint_roundtrip(tmp_path):
    """A planner survives save -> restart -> load and resumes warm: the same
    fields, transforms, pause flag, and the same further relaxation."""
    pl = _session(Planner(PlannerConfig(epsilon=1e-2, resolution=0.5, origin_x=-2.0,
                                        origin_y=3.0, interpolation="bilinear"), device="cpu"))
    p = tmp_path / "session.npz"
    checkpoint.save_planner(p, pl)
    restored = checkpoint.load_planner(p, device="cpu")
    assert restored.paused is True and restored.device == torch.device("cpu")
    assert restored.config.resolution == 0.5 and restored.config.origin_x == -2.0
    assert restored.config.interpolation == "bilinear"
    _same_state(restored.state, pl.state)
    restored.set_status(False)
    pl.set_status(False)
    restored.update(50)
    pl.update(50)
    assert torch.equal(restored.state.u, pl.state.u)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_planner_checkpoint_crosses_packages(tmp_path, direction):
    kw = dict(epsilon=1e-2, resolution=0.5, origin_x=-2.0, origin_y=3.0, steps_per_update=17)
    p = tmp_path / "session.npz"
    if direction == "port_to_jax":
        src = _session(Planner(PlannerConfig(**kw), device="cpu"))
        checkpoint.save_planner(p, src)
        dst = jcheckpoint.load_planner(p)
    else:
        src = _session(JPlanner(JPlannerConfig(**kw)))
        jcheckpoint.save_planner(p, src)
        dst = checkpoint.load_planner(p, device="cpu")
    _same_state(src.state, dst.state)
    assert dst.paused is True
    for k in ("resolution", "origin_x", "origin_y", "steps_per_update", "interpolation",
              "epsilon"):
        assert getattr(dst.config, k) == pytest.approx(getattr(src.config, k)), k


def test_load_planner_config_override_not_mutated(tmp_path):
    pl = Planner(PlannerConfig(epsilon=1e-2), device="cpu")
    pl.init(16, 16)
    pl.add_goals([(8.0, 8.0)])
    f = tmp_path / "s.npz"
    checkpoint.save_planner(f, pl)
    mine = PlannerConfig(epsilon=5e-4)
    restored = checkpoint.load_planner(f, config=mine, device="cpu")
    assert mine.epsilon == 5e-4 and mine.resolution == 1.0
    assert restored.config.epsilon == 5e-4
    assert float(restored.state.epsilon) == np.float32(5e-4)
    restored2 = checkpoint.load_planner(f, device="cpu")
    assert restored2.config.epsilon == np.float32(1e-2)


def _volume_session(pl):
    pl.init(20, 16, 12)
    pl.add_goals([(3.0, 5.0, 3.0)])
    pl.update(30)
    pl.set_status(True)
    return pl


def test_volume_planner_checkpoint_roundtrip(tmp_path):
    p = _volume_session(T.VolumePlanner(T.VolumePlannerConfig(
        epsilon=1e-2, resolution=0.5, origin_x=-1.0, origin_y=2.0, origin_z=0.5,
        steps_per_update=21), device="cpu"))
    f = tmp_path / "vol_session.npz"
    checkpoint.save_volume_planner(f, p)
    q = checkpoint.load_volume_planner(f, device="cpu")
    assert q.paused and q.config.steps_per_update == 21
    assert q.config.origin_z == 0.5 and q.config.resolution == 0.5
    assert int(q.state.iteration) == 30
    _same_state(q.state, p.state)
    q.set_status(False)
    q.update(10)
    p.set_status(False)
    p.update(10)
    assert torch.equal(q.state.u, p.state.u)


@pytest.mark.parametrize("direction", ["port_to_jax", "jax_to_port"])
def test_volume_checkpoint_crosses_packages(tmp_path, direction):
    kw = dict(epsilon=1e-2, resolution=0.5, origin_x=-1.0, origin_y=2.0, origin_z=0.5,
              steps_per_update=21)
    f = tmp_path / "vol.npz"
    if direction == "port_to_jax":
        src = _volume_session(T.VolumePlanner(T.VolumePlannerConfig(**kw), device="cpu"))
        checkpoint.save_volume_planner(f, src)
        dst = jcheckpoint.load_volume_planner(f)
    else:
        src = _volume_session(epic_tpu.VolumePlanner(epic_tpu.VolumePlannerConfig(**kw)))
        jcheckpoint.save_volume_planner(f, src)
        dst = checkpoint.load_volume_planner(f, device="cpu")
    _same_state(src.state, dst.state)
    assert dst.paused and dst.config.origin_z == 0.5 and dst.config.steps_per_update == 21


def test_save_refuses_an_uninitialized_planner(tmp_path):
    with pytest.raises(ValueError):
        checkpoint.save_planner(tmp_path / "x.npz", Planner(device="cpu"))
    with pytest.raises(ValueError):
        checkpoint.save_volume_planner(tmp_path / "y.npz", T.VolumePlanner(device="cpu"))
