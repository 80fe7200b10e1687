"""The CUDA kernels of epic_tpu_torch against their plain torch version, on
the card. Every test here needs a CUDA card and skips without one.

This file imports neither JAX nor epic_tpu, so it runs on a host that has
only torch. tests/conftest.py imports jax, so run it there without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: the same bits. The kernels and torch's CUDA exp/log call the
same accurate expf/logf, in the same op order (solver/_sweep_body.py).
"""

import dataclasses
import pathlib

import numpy as np
import pytest
import torch

from epic_tpu_torch import constants as C
from epic_tpu_torch import grid as TG
from epic_tpu_torch import maps
from epic_tpu_torch.planner import Planner, PlannerConfig
from epic_tpu_torch.solver import core, hopper_sweep

pytestmark = pytest.mark.cuda

GOLDENS = pathlib.Path(__file__).parent / "goldens"


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _state(name, dev, t0=0):
    """A fuzz golden's start state, or a seeded non-square maze, at
    iteration ``t0``."""
    if name == "maze64x96":
        st = TG.from_occupancy_image(maps.recursive_maze(64, 96, seed=1), 1e-2, device=dev)
    else:
        g = np.load(GOLDENS / f"{name}.npz")
        st = TG.make_state(g["u0"], g["locked"], float(g["epsilon"]), device=dev)
    return dataclasses.replace(st, iteration=torch.tensor(t0, dtype=torch.int32, device=dev))


def _assert_same(k, p):
    torch.cuda.synchronize()
    assert torch.equal(k.u, p.u)
    assert torch.equal(k.delta, p.delta)
    assert int(k.iteration) == int(p.iteration)
    assert bool(k.converged) == bool(p.converged)


NAMES = ["fuzz2d_seed0", "fuzz2d_seed2", "maze64x96"]


@pytest.mark.parametrize("t0", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_chunk_kernel_gives_the_plain_versions_bits(dev, name, t0):
    for num_steps in (1, 2, 50):
        before = hopper_sweep.launches["epic_sweep2d_chunk"]
        k = hopper_sweep.update_n(_state(name, dev, t0), num_steps)
        p = core.update_n(_state(name, dev, t0), num_steps)
        _assert_same(k, p)
        assert hopper_sweep.launches["epic_sweep2d_chunk"] == before + 1


@pytest.mark.parametrize("stagger,cap", [(100, 1_000_000), (1, 1_000_000), (7, 1_000_000),
                                         (100, 250), (10, 95)])
@pytest.mark.parametrize("name", NAMES)
def test_solve_kernel_gives_the_plain_versions_bits(dev, name, stagger, cap):
    """Converged solves at several staggers, and capped ones that end on a
    cycle boundary, as the plain version does."""
    before = hopper_sweep.launches["epic_sweep2d_solve"]
    k = hopper_sweep.solve(_state(name, dev, t0=5), stagger, cap)
    p = core.solve(_state(name, dev, t0=5), stagger, cap)
    _assert_same(k, p)
    assert hopper_sweep.launches["epic_sweep2d_solve"] == before + 1
    if cap == 1_000_000:
        assert bool(k.converged) and int(k.iteration) % stagger == 1 % stagger


def test_planner_session_runs_the_kernels(dev):
    """A Planner on the card: every tick and the solve launch a kernel, the
    plain version never runs, and the field equals a plain replay."""
    img = maps.random_obstacles(48, 72, density=0.15, seed=3)
    occ = np.where(img == 0, 100, 0).astype(np.int8)
    tp = Planner(PlannerConfig(epsilon=1e-2, steps_per_update=25), device=dev)
    tp.update_occupancy(occ)
    assert tp.add_goals([(36.0, 24.0)])
    # A copy: the kernels relax the planner's u in place.
    replay = dataclasses.replace(tp.state, u=tp.state.u.clone())
    launches, calls = dict(hopper_sweep.launches), dict(core.calls)
    for _ in range(4):
        tp.update()
    tp.set_cells([(10, 10)], [C.CELL_TYPE_OBSTACLE])
    tp.update(13)
    tp.solve()
    assert bool(tp.state.converged)
    assert tp.get_cell(36, 24) == 0.0 and tp.get_cell(10, 10) == -1e6
    assert hopper_sweep.launches["epic_sweep2d_chunk"] == launches["epic_sweep2d_chunk"] + 5
    assert hopper_sweep.launches["epic_sweep2d_solve"] == launches["epic_sweep2d_solve"] + 1
    assert core.calls == calls

    for _ in range(4):
        replay = core.update_n(replay, 25)
    replay = core.update_n(TG.set_cells(replay, [(10, 10)], [C.CELL_TYPE_OBSTACLE]), 13)
    _assert_same(tp.state, core.solve(replay))
    poses = tp.compute_path((5.0, 5.0), step_size=0.2, cd_precision=0.4)
    assert abs(poses[-1].x - 36) < 2 and abs(poses[-1].y - 24) < 2


def test_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Checked before any launch; nothing falls back to the plain version."""
    st = TG.empty_state(16, 16, 1e-2, device=dev)
    launches, calls = dict(hopper_sweep.launches), dict(core.calls)
    bad = [
        (NotImplementedError, dict(u=torch.zeros(4, 5, 6, device=dev),
                                   locked=torch.zeros(4, 5, 6, dtype=torch.bool, device=dev))),
        (TypeError, dict(u=st.u.double())),
        (TypeError, dict(locked=st.locked.to(torch.uint8))),
        (ValueError, dict(u=st.u.t())),                       # not contiguous
        (ValueError, dict(locked=st.locked.cpu())),
        (ValueError, dict(locked=st.locked[:, :8].contiguous())),
        (TypeError, dict(iteration=st.iteration.long())),
        (ValueError, dict(epsilon=st.epsilon.cpu())),
    ]
    for exc, fields in bad:
        for call in (lambda s: hopper_sweep.update_n(s, 3), lambda s: hopper_sweep.solve(s)):
            with pytest.raises(exc):
                call(dataclasses.replace(st, **fields))
    assert hopper_sweep.launches == launches and core.calls == calls
