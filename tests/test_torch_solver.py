"""epic_tpu_torch's plain solver against epic_tpu: the XLA core and the two
Pallas kernels it stands in for (pallas_sweep.sweep_chunk for K1,
pallas_sweep.solve for K2), run in interpret mode as the JAX package's own
CPU tests run them.

Tolerances follow tests/test_pallas.py:40-68: fields rtol=2e-6, atol=1e-3;
deltas rtol=1e-5, with atol=1e-5 in place of its 1e-6. Torch's and XLA's
CPU exp differ by one ulp on some inputs, so the two packages are not
bit-equal on the CPU, and a delta is a difference of field values: one ulp
of a cell near u = -30 is 3.8e-6, which a delta carries whole. Iteration
counts follow the stagger rule (equal, or whole stagger cycles apart with
a threshold-marginal deciding delta). On the card the CUDA kernels must give
the plain version's bits exactly: tests/test_torch_cuda.py.
"""

import dataclasses
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epic_tpu import grid as JG
from epic_tpu import maps
from epic_tpu.solver import core as jcore
from epic_tpu.solver import pallas_sweep
import epic_tpu_torch.solver as TS
from epic_tpu_torch import grid as TG
from epic_tpu_torch.solver import core, hopper_sweep

GOLDENS = pathlib.Path(__file__).parent / "goldens"
FIELD = dict(rtol=2e-6, atol=1e-3)
DELTA = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and torch's default of one OpenMP thread per core oversubscribes them
    (spin-waiting threads slowed this file about 30-fold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(name):
    """(u0, locked, eps) from a golden or a seeded procedural maze."""
    if name == "maze64":
        st = JG.from_occupancy_image(maps.recursive_maze(64, 64, seed=0), 1e-2)
        return np.asarray(st.u), np.asarray(st.locked), 1e-2
    g = np.load(GOLDENS / f"{name}.npz")
    return g["u0"], g["locked"], float(g["epsilon"])


CASES = ["fuzz2d_seed0", "fuzz2d_seed2", "maze64"]


def _states(name, iteration=0):
    u0, locked, eps = _case(name)
    j = dataclasses.replace(JG.make_state(u0, locked, eps), iteration=jnp.int32(iteration))
    t = dataclasses.replace(TG.make_state(u0, locked, eps, device="cpu"),
                            iteration=torch.tensor(iteration, dtype=torch.int32))
    return j, t


def _assert_stagger_rule(ours, theirs, eps, stagger=100):
    it_o, it_t = int(ours.iteration), int(theirs.iteration)
    if it_o != it_t:
        assert (it_o - it_t) % stagger == 0
        assert abs(float(ours.delta) - eps) <= 5e-4 or abs(float(theirs.delta) - eps) <= 5e-4


@pytest.mark.parametrize("t0", [0, 7])
@pytest.mark.parametrize("name", CASES)
def test_update_n_matches_jax_core_and_k1(name, t0):
    """A 50-sweep tick from an even and an odd start iteration."""
    j, t = _states(name, t0)
    padded = pallas_sweep.pad_state(j)
    k1_u, k1_delta = pallas_sweep.sweep_chunk(padded.u, padded.frozen, jnp.int32(t0), 50, True)
    k1_u = np.asarray(k1_u)[: padded.height, : padded.width]
    jc = jcore.update_n(j, 50)
    out = core.update_n(t, 50)
    for ref_u, ref_delta in ((np.asarray(jc.u), float(jc.delta)), (k1_u, float(k1_delta))):
        np.testing.assert_allclose(out.u.numpy(), ref_u, **FIELD)
        np.testing.assert_allclose(float(out.delta), ref_delta, **DELTA)
    assert int(out.iteration) == t0 + 50 and out.iteration.dtype == torch.int32
    assert not bool(out.converged)


@pytest.mark.parametrize("name", CASES)
def test_solve_matches_jax_core_and_k2(name):
    j, t = _states(name)
    eps = float(j.epsilon)
    k2 = pallas_sweep.solve(j, 100, interpret=True)
    jc = jcore.solve(_states(name)[0], 100)
    out = core.solve(t, 100)
    assert bool(out.converged)
    assert int(out.iteration) % 100 == 1
    for ref in (jc, k2):
        _assert_stagger_rule(out, ref, eps)
        if int(out.iteration) == int(ref.iteration):
            np.testing.assert_allclose(out.u.numpy(), np.asarray(ref.u), **FIELD)
            np.testing.assert_allclose(float(out.delta), float(ref.delta), **DELTA)


@pytest.mark.parametrize("stagger,cap", [(1, 1_000_000), (7, 1_000_000), (100, 250), (10, 95)])
def test_solve_protocol_matches_jax_core(stagger, cap):
    """Stagger cadence and capped exits: a cap that is not a whole number of
    cycles still ends on a cycle boundary, as in epic_tpu."""
    j, t = _states("fuzz2d_seed0")
    jc = jcore.solve(j, stagger, cap)
    out = core.solve(t, stagger, cap)
    assert int(out.iteration) == int(jc.iteration)
    assert bool(out.converged) == bool(jc.converged)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(jc.u), **FIELD)
    np.testing.assert_allclose(float(out.delta), float(jc.delta), **DELTA)


@pytest.mark.parametrize("t0", [0, 1])
def test_single_sweep_parity_and_converged_flag(t0):
    """One sweep updates the (y + x) % 2 != t % 2 class only, and a 1-sweep
    tick records a fresh verdict."""
    rng = np.random.default_rng(t0)
    u0, locked, eps = _case("fuzz2d_seed0")
    u0 = np.where(locked, u0, rng.uniform(-30, -1, u0.shape)).astype(np.float32)
    j = dataclasses.replace(JG.make_state(u0, locked, eps), iteration=jnp.int32(t0))
    t = TG.state_from_numpy(TG.state_to_numpy(j), device="cpu")
    out = core.update_n(t, 1)
    jc = jcore.update_n(j, 1)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(jc.u), **FIELD)
    assert bool(out.converged) == bool(jc.converged)
    changed = out.u.numpy() != t.u.numpy()
    yy, xx = np.nonzero(changed)
    assert len(yy) and np.all((yy + xx) % 2 != t0 % 2)


def test_3d_parity_matches_jax_core():
    """The plain core is rank-generic like epic_tpu's: 3D flips the class."""
    rng = np.random.default_rng(3)
    shape = (6, 7, 9)
    locked = rng.random(shape) < 0.2
    u = np.where(locked, -1e6, rng.uniform(-20, 0, shape)).astype(np.float32)
    jc = jcore.update_n(JG.make_state(u, locked, 1e-2), 5)
    out = core.update_n(TG.make_state(u, locked, 1e-2, device="cpu"), 5)
    np.testing.assert_allclose(out.u.numpy(), np.asarray(jc.u), **FIELD)
    np.testing.assert_allclose(float(out.delta), float(jc.delta), **DELTA)


@pytest.mark.parametrize("seed", [0, 2])
def test_fuzz2d_solve_matches_reference_golden(seed):
    """tests/test_goldens.py's rule for the reference binary's own solve."""
    g = np.load(GOLDENS / f"fuzz2d_seed{seed}.npz")
    eps = float(g["epsilon"])
    out = core.solve(TG.make_state(g["u0"], g["locked"], eps, device="cpu"))
    ref_iters = int(g["ref_iters"])
    checks = dict(zip(g["check_iters"].tolist(), g["check_deltas"].tolist()))
    if int(out.iteration) != ref_iters:
        assert (int(out.iteration) - ref_iters) % 100 == 0
        deciding = checks.get(min(int(out.iteration), ref_iters) - 1, float(out.delta))
        assert abs(deciding - eps) <= 5e-4
    free = ~g["locked"]
    assert np.max(np.abs(out.u.numpy()[free] - g["ref_u"][free])) <= 1e-3


@pytest.mark.parametrize("name", ["maze", "umass"])
def test_demo_bounded_sweeps_match_golden(name):
    g = np.load(GOLDENS / f"{name}.npz")
    out = core.update_n(TG.from_occupancy_image(g["img"], device="cpu"), 300)
    np.testing.assert_allclose(out.u.numpy(), g["ref_u300"], rtol=0, atol=1e-3)


def test_hopper_sweep_routes_cpu_tensors_to_the_plain_version():
    """On a CPU tensor the kernel wrappers run core (counted there), launch
    nothing, and give core's bits."""
    _, t = _states("fuzz2d_seed0", 3)
    before_calls, before_launches = dict(core.calls), dict(hopper_sweep.launches)
    a = hopper_sweep.update_n(t, 20)
    b = core.update_n(t, 20)
    np.testing.assert_array_equal(a.u.numpy(), b.u.numpy())
    assert float(a.delta) == float(b.delta) and int(a.iteration) == 23
    s = hopper_sweep.solve(t, 100)
    np.testing.assert_array_equal(s.u.numpy(), core.solve(t, 100).u.numpy())
    assert core.calls["update_n"] == before_calls["update_n"] + 2
    assert core.calls["solve"] == before_calls["solve"] + 2
    assert hopper_sweep.launches == before_launches


def test_solver_entry_points_route_by_device():
    _, t = _states("fuzz2d_seed0")
    a = TS.update_grid(t, 10)
    np.testing.assert_array_equal(a.u.numpy(), core.update_n(t, 10).u.numpy())
    s = TS.solve_grid(t)
    assert bool(s.converged) and int(s.iteration) == int(core.solve(t).iteration)
    with pytest.raises(ValueError):
        TS.update_grid(t, 0)


def test_cuda_checks_run_before_any_launch():
    """The wrapper refuses what the kernel does not take (checked without a
    card: the device test comes first)."""
    _, t = _states("fuzz2d_seed0")
    with pytest.raises(ValueError):
        hopper_sweep._check_cuda_state(t)
