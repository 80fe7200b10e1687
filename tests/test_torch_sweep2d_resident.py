"""K2's resident route on the CPU: its tile plan, its routing rule, and the
plain tile model at the plan's tile.

``hopper_sweep.resident_plan`` cuts a grid into at most one tile an SM; the
kernel (``csrc/sweep2d.cu`` ``epic_sweep2d_solve_resident``) keeps each tile
with a ``RESIDENT_DEPTH``-deep halo in shared memory and runs up to that many
sweeps between grid barriers. Here:

- the plan tiles the grid exactly, holds no more tiles than SMs, fits the
  shared memory it is given, and is the smallest extended tile of every cut
  that does (against a brute force on small grids); on an H100's numbers the
  demo maps get at least 128 of the 132 SMs;
- the route rule (``plan_on`` is not None) at the boundary of the largest
  square whose plan fits, on a card's properties stood in for, and its
  depth, ``RESIDENT_DEPTH``, read when it is asked;
- ``tiled.solve`` at the plan's tile and depth equals ``core.solve`` bit for
  bit (iteration, delta, verdict and field) on crops of the maze and umass
  goldens around their goals, at staggers 1, 7 and 100, converged and cut by
  ``max_iterations``.

The kernel itself is held to ``core`` on the card (tests/test_torch_cuda.py).
"""

import dataclasses
import pathlib
import types

import numpy as np
import pytest
import torch

from epic_tpu_torch import grid as TG
from epic_tpu_torch.solver import core, hopper_sweep, tiled

GOLDENS = pathlib.Path(__file__).parent / "goldens"
K = hopper_sweep.RESIDENT_DEPTH
# An H100 80GB: its SMs, and the dynamic shared memory a resident block may
# take (the opt-in limit less the block's static shared memory).
SMS = 132
LIMIT = 232_448 - hopper_sweep.RESIDENT_STATIC_SMEM
# Crops of the goldens that hold their goals: (rows, columns).
CROPS = {"maze": (slice(420, 482), slice(200, 296)), "umass": (slice(0, 60), slice(720, 816))}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check_plan(h, w, sms, limit, plan):
    (th, tw), (ny, nx) = plan.tile, plan.tiles
    assert tw % 2 == 0 and th >= 1
    assert (ny - 1) * th < h <= ny * th and (nx - 1) * tw < w <= nx * tw
    assert plan.n_tiles == ny * nx <= sms
    assert plan.smem_bytes == hopper_sweep.resident_smem_bytes(plan.tile, K) <= limit


@pytest.mark.parametrize("shape", [(482, 482), (310, 940)])
def test_plan_gives_the_demo_maps_nearly_every_sm(shape):
    plan = hopper_sweep.resident_plan(*shape, SMS, LIMIT, K)
    _check_plan(*shape, SMS, LIMIT, plan)
    assert plan.n_tiles >= 128


@pytest.mark.parametrize("shape", [(3, 3), (5, 1000), (1000, 5), (487, 479), (2048, 2048),
                                   (1, 1), (2, 7), (2530, 2530)])
def test_plan_tiles_the_grid_within_the_card(shape):
    plan = hopper_sweep.resident_plan(*shape, SMS, LIMIT, K)
    _check_plan(*shape, SMS, LIMIT, plan)


@pytest.mark.parametrize("sms", [1, 3, 8, 17])
def test_plan_is_the_smallest_extended_tile_that_fits(sms):
    """Against every cut (TH, TW even) of small grids: no cut that fits the
    SMs and the shared memory has a smaller extended tile."""
    rng = np.random.default_rng(sms)
    for h, w in rng.integers(1, 60, size=(12, 2)):
        h, w = int(h), int(w)
        limit = int(rng.integers(2_000, 12_000))
        plan = hopper_sweep.resident_plan(h, w, sms, limit, K)
        fits = [(th + 2 * K) * (tw + 2 * K)
                for th in range(1, h + 1) for tw in range(2, w + 2, 2)
                if -(-h // th) * -(-w // tw) <= sms
                and hopper_sweep.resident_smem_bytes((th, tw), K) <= limit]
        if not fits:
            assert plan is None
            continue
        _check_plan(h, w, sms, limit, plan)
        th, tw = plan.tile
        assert (th + 2 * K) * (tw + 2 * K) == min(fits)


def test_plan_refuses_what_no_tile_fits():
    assert hopper_sweep.resident_plan(2531, 2531, SMS, LIMIT, K) is None
    assert hopper_sweep.resident_plan(100, 100, SMS, 1_000, K) is None
    assert hopper_sweep.resident_smem_bytes((41, 44), K) == 14_136


def _h100(monkeypatch):
    props = types.SimpleNamespace(multi_processor_count=SMS,
                                  shared_memory_per_block_optin=232_448)
    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: props)


def test_route_rule_at_the_boundary(monkeypatch):
    """On an H100's properties the largest square that fits is 2530², and
    the rule sends it to the resident entry and 2531² in place."""
    _h100(monkeypatch)
    assert hopper_sweep.plan_on((2530, 2530), "cuda:0") is not None
    assert hopper_sweep.plan_on((2531, 2531), "cuda:0") is None
    assert hopper_sweep.plan_on((482, 482), "cuda:0") is not None
    assert hopper_sweep.plan_on((310, 940), "cuda:0") is not None
    assert hopper_sweep.plan_on((2530, 2530), "cuda:0").tile == (211, 230)
    assert hopper_sweep.plan_on((2000, 4000), "cuda:0") is None


@pytest.mark.parametrize("k", [2, 4, 8])
def test_route_rule_plans_at_the_depth_it_is_given(monkeypatch, k):
    """``plan_on`` reads ``RESIDENT_DEPTH`` when asked, so a kernel built at
    another K (``tile_probe --resident``) runs on its own plan; a shallower
    halo holds a larger square."""
    _h100(monkeypatch)
    monkeypatch.setattr(hopper_sweep, "RESIDENT_DEPTH", k)
    for shape in ((482, 482), (310, 940), (2048, 2048)):
        plan = hopper_sweep.plan_on(shape, "cuda:0")
        assert plan == hopper_sweep.resident_plan(*shape, SMS, LIMIT, k)
        assert plan.smem_bytes == hopper_sweep.resident_smem_bytes(plan.tile, k)
    assert (hopper_sweep.plan_on((2531, 2531), "cuda:0") is None) == (k == 8)


def _crop(name):
    img = np.load(GOLDENS / f"{name}.npz")["img"][CROPS[name]]
    assert (img == 255).any()
    return TG.from_occupancy_image(img, 1e-3, device="cpu")


@pytest.mark.parametrize("stagger,cap", [(100, 1_000_000), (7, 1_000_000), (1, 1_000_000),
                                         (100, 250), (7, 95), (1, 40)])
@pytest.mark.parametrize("name", ["maze", "umass"])
def test_tile_model_at_the_plans_tile_equals_core(name, stagger, cap):
    st = _crop(name)
    plan = hopper_sweep.resident_plan(*st.u.shape, SMS, LIMIT, K)
    got = tiled.solve(st, stagger, cap, k=K, tile=plan.tile)
    want = core.solve(dataclasses.replace(st, u=st.u.clone()), stagger, cap)
    assert int(got.iteration) == int(want.iteration)
    assert torch.equal(got.delta, want.delta)
    assert bool(got.converged) == bool(want.converged) == (cap == 1_000_000)
    assert torch.equal(got.u, want.u)
