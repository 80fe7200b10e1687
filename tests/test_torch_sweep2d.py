"""The tile family's plain model (``solver.tiled``'s ``update_n`` and
``solve``) at full-width band tiles, on the CPU.

A tile of (band rows, W) with K sweeps between halo exchanges is the
schedule of K1/K2 held in the shared memory of thread-block clusters, a band
a cluster, exchanging K-deep edge bands every K sweeps (the design PERF.md
records as measured and not shipped). Here that schedule is held:

- to ``core`` bit for bit;
- to ``epic_tpu.solver.pallas_sweep``'s K1 (``sweep_chunk``) and K2
  (``solve``) run in interpret mode, as tests/test_torch_solver.py runs
  them;

on maze-like grids whose bands start on odd and on even rows (the last
band shorter than K in some), from iterations 0 and 1, at 1, K - 1, K,
K + 1 and 50 sweeps and at staggers 1, 7 and 100.

Tolerance: the same bits against ``core``; against ``epic_tpu``
tests/test_torch_solver.py's (fields rtol 2e-6, atol 1e-3; deltas rtol
1e-5, atol 1e-5: torch's and XLA's CPU exp differ by an ulp on some
inputs).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from epic_tpu import grid as JG
from epic_tpu.solver import core as jcore
from epic_tpu.solver import pallas_sweep
from epic_tpu_torch import grid as TG
from epic_tpu_torch import maps
from epic_tpu_torch.solver import core, tiled

FIELD = dict(rtol=2e-6, atol=1e-3)
DELTA = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _maze_state(h, w, seed, t0=0):
    img = maps.recursive_maze(h, w, seed=seed)
    st = TG.from_occupancy_image(img, 1e-2, device="cpu")
    return dataclasses.replace(st, iteration=torch.tensor(t0, dtype=torch.int32))


def _jax_state(st):
    j = JG.make_state(st.u.numpy(), st.locked.numpy(), float(st.epsilon))
    return dataclasses.replace(j, iteration=jnp.int32(int(st.iteration)))


# (h, w, seed, band, k): bands of 5 rows start on odd rows, of 6 and 8 only
# on even ones; the last band of 41 and 43 rows is shorter than k.
LAYOUTS = [(41, 37, 1, 5, 4), (48, 29, 2, 6, 3), (64, 45, 3, 8, 8), (43, 50, 4, 8, 8)]


@pytest.mark.parametrize("sweeps", ["1", "k-1", "k", "k+1", "50"])
@pytest.mark.parametrize("t0", [0, 1])
@pytest.mark.parametrize("case", LAYOUTS)
def test_band_model_tick_gives_core_bits(case, t0, sweeps):
    h, w, seed, band, k = case
    n = max(1, {"1": 1, "k-1": k - 1, "k": k, "k+1": k + 1, "50": 50}[sweeps])
    st = _maze_state(h, w, seed, t0)
    got = tiled.update_n(st, n, k=k, tile=(band, w))
    ref = core.update_n(st, n)
    assert torch.equal(got.u, ref.u) and torch.equal(got.delta, ref.delta)
    assert int(got.iteration) == t0 + n and bool(got.converged) == bool(ref.converged)


@pytest.mark.parametrize("stagger,cap", [(1, 1_000_000), (7, 1_000_000), (100, 1_000_000),
                                         (100, 250), (7, 60)])
@pytest.mark.parametrize("case", LAYOUTS)
def test_band_model_solve_gives_core_bits(case, stagger, cap):
    h, w, seed, band, k = case
    got = tiled.solve(_maze_state(h, w, seed), stagger, cap, k=k, tile=(band, w))
    ref = core.solve(_maze_state(h, w, seed), stagger, cap)
    assert torch.equal(got.u, ref.u) and torch.equal(got.delta, ref.delta)
    assert int(got.iteration) == int(ref.iteration)
    assert bool(got.converged) == bool(ref.converged)


@pytest.mark.parametrize("sweeps", ["1", "k", "k+1", "50"])
@pytest.mark.parametrize("t0", [0, 1])
@pytest.mark.parametrize("case", LAYOUTS[:2])
def test_band_model_tick_matches_k1(case, t0, sweeps):
    """Against ``pallas_sweep.sweep_chunk`` (K1) in interpret mode."""
    h, w, seed, band, k = case
    n = {"1": 1, "k": k, "k+1": k + 1, "50": 50}[sweeps]
    st = _maze_state(h, w, seed, t0)
    got = tiled.update_n(st, n, k=k, tile=(band, w))
    padded = pallas_sweep.pad_state(_jax_state(st))
    k1_u, k1_delta = pallas_sweep.sweep_chunk(padded.u, padded.frozen, jnp.int32(t0), n, True)
    np.testing.assert_allclose(got.u.numpy(), np.asarray(k1_u)[:h, :w], **FIELD)
    np.testing.assert_allclose(float(got.delta), float(k1_delta), **DELTA)


@pytest.mark.parametrize("stagger", [1, 7, 100])
@pytest.mark.parametrize("case", LAYOUTS[:2])
def test_band_model_solve_matches_k2_and_jax_core(case, stagger):
    """Against ``pallas_sweep.solve`` (K2, interpret mode) at stagger 100
    and against ``epic_tpu``'s core solve at every stagger: iterations
    equal, or a whole number of stagger cycles apart with a
    threshold-marginal deciding delta."""
    h, w, seed, band, k = case
    got = tiled.solve(_maze_state(h, w, seed), stagger, k=k, tile=(band, w))
    assert bool(got.converged) and int(got.iteration) % stagger == 1 % stagger
    refs = [jcore.solve(_jax_state(_maze_state(h, w, seed)), stagger)]
    if stagger == 100:
        refs.append(pallas_sweep.solve(_jax_state(_maze_state(h, w, seed)), stagger,
                                       interpret=True))
    for ref in refs:
        it_o, it_r = int(got.iteration), int(ref.iteration)
        if it_o != it_r:
            assert (it_o - it_r) % stagger == 0
            eps = float(got.epsilon)
            assert min(abs(float(got.delta) - eps), abs(float(ref.delta) - eps)) <= 5e-4
        else:
            np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), **FIELD)
            np.testing.assert_allclose(float(got.delta), float(ref.delta), **DELTA)
