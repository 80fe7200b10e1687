"""The CUDA kernels of epic_tpu_torch against their plain torch version, on
the card: the 2D kernels (csrc/sweep2d.cu), the 2D tile kernels for grids
beyond the L2 (csrc/tile2d.cu), the 3D kernels (csrc/sweep3d.cu), the 3D
tile kernels for volumes beyond it (csrc/tile3d.cu), the batched scenario
kernels (csrc/batched2d.cu, and their tiled route's entries in
csrc/tile2d.cu), the shard chunk of the 2D mesh and the
resident route's cycle and solve entries (in csrc/tile2d.cu) and the mesh
solver and MeshPlanner on a virtual mesh of eight shards on the one card,
the shard chunk of the 3D mesh
and its device route's cycle and solve entries (csrc/shard3d.cu) and the
3D mesh solver and MeshVolumePlanner on virtual meshes of the card, the planners that drive them, and the batched walkers
on the card against the same walkers on the CPU; the cascade solve and the
nav_core plugin on the card's kernels, and the plain route of a rank-4 grid
on the card.
Every test here needs a CUDA card and skips without one.

This file imports neither JAX nor epic_tpu, so it runs on a host that has
only torch. tests/conftest.py imports jax, so run it there without it:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tolerance: the same bits. The kernels and torch's CUDA exp/log call the
same accurate expf/logf, in the same op order (solver/_sweep_body.py); the
walkers use only IEEE-exact ops (+, -, *, /, sqrt) and gathers.
"""

import copy
import ctypes
import dataclasses
import math
import pathlib

import numpy as np
import pytest
import torch

from epic_tpu_torch import constants as C
from epic_tpu_torch import grid as TG
from epic_tpu_torch import maps, native, path
import epic_tpu_torch.solver as TS
from epic_tpu_torch.errors import EpicError
from epic_tpu_torch.planner import Planner, PlannerConfig
from epic_tpu_torch.planner3d import VolumePlanner, VolumePlannerConfig
from epic_tpu_torch.planner_mesh import MeshPlanner, MeshVolumePlanner
from epic_tpu_torch.parallel import (hopper_resident2d, hopper_resident3d, hopper_shard2d,
                                     hopper_shard3d, make_mesh, make_mesh3d, sharded, sharded3d)
from epic_tpu_torch.parallel.sharded import Mesh
from epic_tpu_torch.services import EpicNavCorePlugin
from epic_tpu_torch.solver import (_build, batched, batched_path3d, cascade, core,
                                   hopper_batched, hopper_sweep, hopper_sweep3d, hopper_tile2d,
                                   hopper_tile3d, tiled, tiled3d)

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


def _volume(shape, density, seed, dev, t0=0):
    """Boundary-locked volume with one goal voxel and seeded obstacles, as
    tests/test_pallas3d.py builds them, at iteration ``t0``."""
    d, h, w = shape
    rng = np.random.default_rng(seed)
    u = np.full(shape, -1e6, dtype=np.float32)
    locked = np.zeros(shape, dtype=bool)
    locked[0], locked[-1] = True, True
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    locked |= rng.random(shape) < density
    u[d // 2, h // 2, w // 2] = 0.0
    locked[d // 2, h // 2, w // 2] = True
    st = TG.make_state(u, locked, 1e-2, device=dev)
    return dataclasses.replace(st, iteration=torch.tensor(t0, dtype=torch.int32, device=dev))


VOLUMES = [((7, 9, 21), 0.15, 3), ((6, 8, 17), 0.1, 1), ((10, 12, 14), 0.1, 2),
           ((5, 9, 131), 0.0, 0), ((3, 3, 3), 0.0, 0), ((4, 40, 3), 0.1, 5)]


@pytest.mark.parametrize("t0", [0, 1])
@pytest.mark.parametrize("vol", VOLUMES, ids=lambda v: "x".join(map(str, v[0])))
def test_chunk3d_kernel_gives_the_plain_versions_bits(dev, vol, t0):
    for num_steps in (1, 2, 50):
        before = hopper_sweep3d.launches["epic_sweep3d_chunk"]
        k = hopper_sweep3d.update_n(_volume(*vol, dev, t0), num_steps)
        p = core.update_n(_volume(*vol, dev, t0), num_steps)
        _assert_same(k, p)
        assert hopper_sweep3d.launches["epic_sweep3d_chunk"] == before + 1


@pytest.mark.parametrize("stagger,cap", [(100, 1_000_000), (1, 1_000_000), (7, 1_000_000),
                                         (100, 250), (10, 95)])
@pytest.mark.parametrize("vol", VOLUMES[:4], ids=lambda v: "x".join(map(str, v[0])))
def test_solve3d_kernel_gives_the_plain_versions_bits(dev, vol, stagger, cap):
    before = hopper_sweep3d.launches["epic_sweep3d_solve"]
    k = TS.solve_volume(_volume(*vol, dev, t0=5), stagger, cap)
    p = core.solve(_volume(*vol, dev, t0=5), stagger, cap)
    _assert_same(k, p)
    assert hopper_sweep3d.launches["epic_sweep3d_solve"] == before + 1
    if cap == 1_000_000:
        assert bool(k.converged) and int(k.iteration) % stagger == 1 % stagger


# K7 (csrc/sweep3d.cu) on every kind of row: rows of 3..8 voxels, a half
# quad at a row end (W % 8 == 4), whole quads, the voxel-by-voxel walk of
# W % 4 != 0; the 3D session's volume; planes past 1448^2 (4 x 1448 x 1452).
SWEEP3D_WIDTHS = [((6, 11, w), 0.1, w) for w in (3, 4, 5, 8, 9, 16, 17, 131, 256)]
SWEEP3D_VOLUMES = SWEEP3D_WIDTHS + [((30, 256, 256), 0.1, 7), ((4, 1448, 1452), 0.1, 8)]


@pytest.mark.parametrize("vol", SWEEP3D_VOLUMES, ids=lambda v: "x".join(map(str, v[0])))
def test_sweep3d_widths_give_the_plain_versions_bits(dev, vol):
    for t0 in (0, 1):
        for num_steps in (1, 2, 7):
            k = hopper_sweep3d.update_n(_volume(*vol, dev, t0), num_steps)
            _assert_same(k, core.update_n(_volume(*vol, dev, t0), num_steps))
    before = hopper_sweep3d.launches["epic_sweep3d_solve"]
    k = hopper_sweep3d.solve(_volume(*vol, dev), 7, 300)
    _assert_same(k, core.solve(_volume(*vol, dev), 7, 300))
    assert hopper_sweep3d.launches["epic_sweep3d_solve"] == before + 1


def test_sweep3d_plan_matches_its_model(dev):
    """The C entries' plan on this card equals hopper_sweep3d.plan at the
    card's slots (the CPU tests hold plan's walk to the interior)."""
    lib = _build.load()
    chunk_slots, solve_slots = hopper_sweep3d.slots(dev)
    assert chunk_slots >= torch.cuda.get_device_properties(dev).multi_processor_count
    assert solve_slots >= torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in [(30, 256, 256), (64, 256, 256), (256, 256, 256), (32, 2048, 2048),
                  (4, 1448, 1452), (6, 11, 131), (3, 3, 3), (2, 9, 9), (300, 17, 5)]:
        for slots in (chunk_slots, solve_slots):
            out = (ctypes.c_int * 7)()
            assert lib.epic_sweep3d_plan(*shape, slots, ctypes.addressof(out)) == 0
            p = hopper_sweep3d.plan(shape, slots)
            assert list(out) == [p.segments, p.tz, p.pw, p.rb, p.nb, p.nrb, p.units], shape


def test_sweep3d_refuses_a_misaligned_volume(dev):
    """u 4 bytes past a 16-byte boundary: both entries raise before any
    launch, and nothing falls back to the plain version."""
    st = _volume((6, 7, 8), 0.1, 1, dev)
    u = torch.empty(st.u.numel() + 1, device=dev)[1:].view(st.u.shape).copy_(st.u)
    launches, calls = dict(hopper_sweep3d.launches), dict(core.calls)
    for call in (lambda s: hopper_sweep3d.update_n(s, 3), lambda s: hopper_sweep3d.solve(s)):
        with pytest.raises(ValueError, match="aligned to 16"):
            call(dataclasses.replace(st, u=u))
    assert hopper_sweep3d.launches == launches and core.calls == calls


def test_volume_planner_session_runs_the_kernels(dev):
    """A VolumePlanner on the card: every tick and the solve launch a 3D
    kernel, the plain version never runs, and the field equals a plain
    replay; the batched walker on the card gives the CPU walker's bits."""
    rng = np.random.default_rng(4)
    occ = np.where(rng.random((12, 20, 28)) < 0.05, 100, 0).astype(np.int8)
    occ[6, 10, 14] = 0   # the goal voxel is free
    tp = VolumePlanner(VolumePlannerConfig(epsilon=1e-2, steps_per_update=25), device=dev)
    tp.update_occupancy(occ)
    assert tp.add_goals([(14.0, 10.0, 6.0)])
    replay = dataclasses.replace(tp.state, u=tp.state.u.clone())
    launches, calls = dict(hopper_sweep3d.launches), dict(core.calls)
    for _ in range(4):
        tp.update()
    tp.set_cells([(5, 5, 5)], [C.CELL_TYPE_OBSTACLE])
    tp.update(13)
    tp.solve()
    assert bool(tp.state.converged)
    assert tp.get_cell(14, 10, 6) == 0.0 and tp.get_cell(5, 5, 5) == -1e6
    assert hopper_sweep3d.launches["epic_sweep3d_chunk"] == launches["epic_sweep3d_chunk"] + 5
    assert hopper_sweep3d.launches["epic_sweep3d_solve"] == launches["epic_sweep3d_solve"] + 1
    assert core.calls == calls

    for _ in range(4):
        replay = core.update_n(replay, 25)
    replay = core.update_n(TG.set_cells_3d(replay, [(5, 5, 5)], [C.CELL_TYPE_OBSTACLE]), 13)
    _assert_same(tp.state, core.solve(replay))

    starts = np.array([[3.0, 3.0, 3.0], [25.0, 17.0, 9.0], [-1.0, 0.0, 0.0]], np.float32)
    kw = dict(step_size=0.2, cd_precision=0.4, max_steps=500)
    on_card = batched_path3d.walk(tp.state.u, tp.state.locked, starts, **kw)
    on_cpu = batched_path3d.walk(tp.state.u.cpu(), tp.state.locked.cpu(), starts, **kw)
    for key, v in on_card.items():
        assert torch.equal(v.cpu(), on_cpu[key]), key
    cpu = VolumePlanner(VolumePlannerConfig(epsilon=1e-2), device="cpu")
    cpu.state = TG.state_from_numpy(TG.state_to_numpy(tp.state), device="cpu")
    ours = tp.compute_paths_batch(starts.tolist(), 0.2, 0.4, 500)
    theirs = cpu.compute_paths_batch(starts.tolist(), 0.2, 0.4, 500)
    assert ours[2] is None and theirs[2] is None
    assert [None if a is None else [dataclasses.astuple(q) for q in a] for a in ours] == \
        [None if b is None else [dataclasses.astuple(q) for q in b] for b in theirs]


def test_planner_compute_paths_batch_on_the_card(dev):
    """The 2D batched walker on the card gives the CPU walker's bits."""
    img = maps.random_obstacles(48, 72, density=0.15, seed=3)
    occ = np.where(img == 0, 100, 0).astype(np.int8)
    tp = Planner(PlannerConfig(epsilon=1e-2), device=dev)
    tp.update_occupancy(occ)
    assert tp.add_goals([(36.0, 24.0)])
    tp.solve()
    cpu = Planner(PlannerConfig(epsilon=1e-2), device="cpu")
    cpu.state = TG.state_from_numpy(TG.state_to_numpy(tp.state), device="cpu")
    starts = [(5.0, 5.0), (60.0, 40.0), (-3.0, 2.0)]
    ours = tp.compute_paths_batch(starts, 0.2, 0.4, 2000)
    theirs = cpu.compute_paths_batch(starts, 0.2, 0.4, 2000)
    assert ours[2] is None and theirs[2] is None
    for a, b in zip(ours[:2], theirs[:2]):
        assert list(a) == list(b)
        assert abs(a[-1].x - 36) < 2 and abs(a[-1].y - 24) < 2


def test_planner_poses_after_k2_equal_the_pose_loop(dev):
    """On the maze solved by K2, ``Planner.compute_path``'s poses hold the
    bits of the per-point loop it replaced, run on the walk over the same
    field: the arrays and the poses they give."""
    g = np.load(GOLDENS / "maze.npz")
    img = g["img"]
    tp = Planner(PlannerConfig(epsilon=1e-3, resolution=0.1, origin_x=-12.3, origin_y=4.5),
                 device=dev)
    tp.state = TG.from_occupancy_image(img, 1e-3, device=dev)
    before = hopper_sweep.launches["epic_sweep2d_solve"]
    tp.solve()
    assert hopper_sweep.launches["epic_sweep2d_solve"] == before + 1
    assert bool(tp.state.converged)
    u, locked = TG.host_u(tp.state), TG.host_locked(tp.state)
    h, w = u.shape
    done = 0
    for x, y in g["starts"]:
        start = tp.map_to_world(float(x), float(y))
        try:
            pts = path.compute_path(u, locked, *tp.world_to_map(*start), 0.05, 0.5,
                                    int(w * h / 0.05))
        except EpicError:
            with pytest.raises(EpicError):
                tp.compute_path(start)
            continue
        loop = [(*tp.map_to_world(float(pts[0, 0]), float(pts[0, 1])), 0.0)]
        for i in range(1, len(pts)):
            px, py = float(pts[i, 0]), float(pts[i, 1])
            yaw = math.atan2(py - float(pts[i - 1, 1]), px - float(pts[i - 1, 0]))
            loop.append((*tp.map_to_world(px, py), yaw))
        ours = tp.compute_path(start)
        got = np.stack([ours.x, ours.y, ours.yaw], axis=1)
        assert np.array_equal(got.view(np.uint64), np.array(loop).view(np.uint64))
        assert list(ours) == loop
        done += len(pts) > 10_000
    assert done >= 2


def test_3d_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Checked before any launch; nothing falls back to the plain version."""
    st = TG.empty_volume(6, 7, 8, 1e-2, device=dev)
    launches, calls = dict(hopper_sweep3d.launches), dict(core.calls)
    bad = [
        (ValueError, dict(u=torch.zeros(5, 6, device=dev),
                          locked=torch.zeros(5, 6, dtype=torch.bool, device=dev))),
        (TypeError, dict(u=st.u.double())),
        (TypeError, dict(locked=st.locked.to(torch.uint8))),
        (ValueError, dict(u=st.u.transpose(0, 2))),           # not contiguous
        (ValueError, dict(locked=st.locked.cpu())),
        (ValueError, dict(locked=st.locked[:, :, :4].contiguous())),
        (TypeError, dict(iteration=st.iteration.long())),
        (ValueError, dict(epsilon=st.epsilon.cpu())),
    ]
    for exc, fields in bad:
        for call in (lambda s: hopper_sweep3d.update_n(s, 3), lambda s: hopper_sweep3d.solve(s)):
            with pytest.raises(exc):
                call(dataclasses.replace(st, **fields))
    four_d = dataclasses.replace(st, u=torch.zeros(3, 4, 5, 6, device=dev),
                                 locked=torch.zeros(3, 4, 5, 6, dtype=torch.bool, device=dev))
    with pytest.raises(NotImplementedError, match="plain core"):
        hopper_sweep.update_n(four_d, 1)
    with pytest.raises(NotImplementedError, match="hopper_sweep3d"):
        hopper_sweep.update_n(st, 1)
    assert hopper_sweep3d.launches == launches and core.calls == calls


def _batch(lanes, h, w, density, seed, dev, goalless=()):
    """[B, H, W] lanes as tools/probe.py builds them (-1e6 everywhere, seeded
    obstacle cells, the ring locked, one goal cell a lane); the lanes in
    ``goalless`` keep no goal, so they retire at their first check past
    max(H, W)."""
    rng = np.random.default_rng(seed)
    u = np.full((lanes, h, w), -1e6, np.float32)
    locked = rng.random((lanes, h, w)) < density
    locked[:, 0], locked[:, -1] = True, True
    locked[:, :, 0], locked[:, :, -1] = True, True
    gy = rng.integers(1, max(h - 1, 2), lanes)
    gx = rng.integers(1, max(w - 1, 2), lanes)
    for lane in range(lanes):
        if lane not in goalless:
            u[lane, gy[lane], gx[lane]] = 0.0
            locked[lane, gy[lane], gx[lane]] = True
    return batched.batch_from_numpy(u, locked, device=dev)


def _assert_same_solve(k, p):
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and torch.equal(a, b)


# (lanes, H, W, obstacle density, seed): odd H and W, a lane wider than a
# warp's two strides, lanes with a one-cell interior, one-row interiors of
# odd widths beyond 128, "fit" / "over": the largest odd square lane that
# lane_resident admits on the card and the smallest it refuses, and a lane
# just past the resident limit with an odd height.
BATCHES = [(6, 24, 32, 0.1, 0), (5, 23, 27, 0.15, 1), (3, 9, 131, 0.05, 2), (4, 3, 3, 0.0, 3),
           (3, 3, 131, 0.05, 5), (2, 3, 257, 0.0, 6), (2, "fit", "fit", 0.1, 7),
           (2, "over", "over", 0.1, 8), (2, 239, 235, 0.1, 10)]
SOLVE_BATCHES = BATCHES[:3] + BATCHES[-3:]
LANE_RESIDENT = hopper_batched.lane_resident   # the rules, whatever a test patches
LANE_CLUSTER = hopper_batched.lane_cluster
ROUTES = ("resident", "cluster", "tiled")


def _batch_shape(shape, dev):
    """A BATCHES entry with "fit" / "over" resolved on ``dev``."""
    lanes, h, w, density, seed = shape
    if h in ("fit", "over"):
        side = 3
        while LANE_RESIDENT(side + 2, side + 2, dev):
            side += 2
        h = w = side if h == "fit" else side + 2
    return lanes, h, w, density, seed


def _past_clusters(dev):
    """The smallest odd square side that neither the resident nor the
    cluster route takes on ``dev``."""
    side = 237
    while LANE_RESIDENT(side, side, dev) or LANE_CLUSTER(side, side, dev):
        side += 2
    return side


@pytest.fixture(params=["resident", "tiled", "cluster2", "cluster3", "cluster4", "cluster8"])
def route(request, monkeypatch):
    """The route a test's launches take: "resident" follows the rule
    (lane_resident, then lane_cluster), "tiled" makes both refuse every
    lane, so that small lanes go through the lane tiles too, and "clusterC"
    sends every lane to clusters of C blocks. Returns the route each batch
    shape (lanes, H, W) takes."""
    if request.param != "resident":
        c = int(request.param[len("cluster"):]) if request.param.startswith("cluster") else 0
        monkeypatch.setattr(hopper_batched, "lane_resident", lambda h, w, device: False)
        monkeypatch.setattr(hopper_batched, "lane_cluster", lambda h, w, device, lanes=None: c)
    return lambda b, h, w, dev: hopper_batched._blocks(b, h, w, dev)[1]


def _took(before, route_name, n=1):
    """``n`` launches since ``before`` (a copy of ``routes``), all on ``route_name``."""
    return all(hopper_batched.routes[r] == before[r] + (n if r == route_name else 0)
               for r in ROUTES)


@pytest.mark.parametrize("t0", [0, 1])
@pytest.mark.parametrize("shape", BATCHES, ids=lambda s: "x".join(map(str, s[:3])))
def test_batch_chunk_kernel_gives_the_plain_versions_bits(dev, route, shape, t0):
    """K12's counterpart on both routes: u and the per-lane sweep-0 deltas,
    with and without per-lane active flags (inactive lanes untouched, delta
    0), and with only the last lane active."""
    shape = _batch_shape(shape, dev)
    u, locked = _batch(*shape, dev)
    taken = route(*shape[:3], dev)
    active = torch.arange(u.shape[0], device=dev) % 3 != 1
    last = torch.zeros(u.shape[0], dtype=torch.bool, device=dev)
    last[-1] = True
    for num_steps in (1, 2, 50):
        for gate in (None, active, last):
            before = hopper_batched.launches["epic_batched2d_chunk"]
            routes = dict(hopper_batched.routes)
            it = torch.tensor(t0, dtype=torch.int32, device=dev) if num_steps == 2 else t0
            k = hopper_batched.update_n_batch(u.clone(), locked, it, num_steps, gate)
            p = batched.update_n_batch(u, locked, t0, num_steps, gate)
            _assert_same_solve(k, p)
            assert hopper_batched.launches["epic_batched2d_chunk"] == before + 1
            assert _took(routes, taken)
            if gate is not None:
                assert torch.equal(k[0][~gate], u[~gate]) and bool((k[1][~gate] == 0).all())


@pytest.mark.parametrize("stagger,cap", [(100, 1_000_000), (1, 1_000_000), (7, 1_000_000),
                                         (100, 250), (10, 95)])
@pytest.mark.parametrize("shape", SOLVE_BATCHES, ids=lambda s: "x".join(map(str, s[:3])))
def test_batch_solve_kernels_give_the_plain_versions_bits(dev, route, shape, stagger, cap):
    """K13's counterpart (one launch) and the host-driven lockstep over K12's,
    on both routes: the plain version's bits in u, iterations, deltas and
    converged, with a goalless lane that retires long before the others,
    and capped solves."""
    shape = _batch_shape(shape, dev)
    u, locked = _batch(*shape, dev, goalless=(0,))
    taken = route(*shape[:3], dev)
    before = dict(hopper_batched.launches)
    plain = batched.solve_batch(u, locked, 1e-2, stagger, cap)
    routes = dict(hopper_batched.routes)
    one = hopper_batched.solve_batch_device(u.clone(), locked, 1e-2, stagger, cap)
    assert _took(routes, taken)
    host = hopper_batched.solve_batch(u.clone(), locked, 1e-2, stagger, cap)
    _assert_same_solve(one, plain)
    _assert_same_solve(host, plain)
    assert hopper_batched.launches["epic_batched2d_solve"] == before["epic_batched2d_solve"] + 1
    chunks = hopper_batched.launches["epic_batched2d_chunk"] - before["epic_batched2d_chunk"]
    assert chunks > 0 and _took(routes, taken, 1 + chunks)
    iters = one[1].cpu().numpy()
    if cap == 1_000_000:
        assert bool(one[3].all()) and np.all(iters % stagger == 1 % stagger)
        assert iters[0] == iters.min()           # the goalless lane retires first
        assert stagger == 100 or iters[0] < iters.max()
        assert bool((one[0][0] == u[0]).all())   # and never moved


def test_batch_entries_refuse_a_resident_lane_that_does_not_fit(dev):
    """Asked for the resident route on a lane beyond shared memory, both C
    entries return an error and launch nothing: no other route is taken.
    The wrapper's layout size is the entry's own."""
    from epic_tpu_torch.solver import _build

    lib = _build.load()
    side = _batch_shape((1, "over", "over", 0.1, 0), dev)[1]
    assert not LANE_RESIDENT(side, side, dev)
    for h, w in ((128, 128), (3, 131), (side - 2, side - 2), (side, side), (9, 5)):
        assert lib.epic_batched2d_smem_bytes(h, w) == hopper_batched.lane_smem_bytes(h, w)
    u, locked = _batch(2, side, side, 0.1, 9, dev)
    start = u.clone()
    it = torch.zeros((), dtype=torch.int32, device=dev)
    delta = torch.zeros(2, dtype=torch.float32, device=dev)
    eps = torch.full((2,), 1e-2, device=dev)
    retired = torch.zeros(2, dtype=torch.uint8, device=dev)
    iters = torch.zeros(2, dtype=torch.int32, device=dev)
    deltas = eps + 1.0
    stream = torch.cuda.current_stream(dev).cuda_stream
    errs = [lib.epic_batched2d_chunk(u.data_ptr(), locked.data_ptr(), 2, side, side, it.data_ptr(),
                                     10, None, delta.data_ptr(), 1, stream, dev.index),
            lib.epic_batched2d_solve(u.data_ptr(), locked.data_ptr(), 2, side, side,
                                     eps.data_ptr(), side, 1000, 10, retired.data_ptr(),
                                     iters.data_ptr(), deltas.data_ptr(), 1, stream, dev.index)]
    torch.cuda.synchronize()
    for name, err in zip(("epic_batched2d_chunk", "epic_batched2d_solve"), errs):
        assert err != 0
        with pytest.raises(RuntimeError, match=name):
            _build.check(err, name)
    assert torch.equal(u, start) and bool((delta == 0).all()) and bool((iters == 0).all())
    assert bool((retired == 0).all()) and torch.equal(deltas, eps + 1.0)


@pytest.mark.parametrize("lanes", [1, 2, 7])
@pytest.mark.parametrize("stagger,cap", [(100, 250), (10, 95)])
def test_batch_solve_past_the_largest_cluster_takes_the_tiles(dev, stagger, cap, lanes):
    """Lanes just past the largest cluster take the tiled route under the
    rule, whatever the batch's size; capped solves (one launch and
    host-driven) and a chunk give the plain version's bits."""
    side = _past_clusters(dev)
    taken = hopper_batched._blocks(lanes, side, side, dev)[1]
    assert taken == "tiled"
    u, locked = _batch(lanes, side, side, 0.1, 11, dev, goalless=(0,))
    routes = dict(hopper_batched.routes)
    one = hopper_batched.solve_batch_device(u.clone(), locked, 1e-2, stagger, cap)
    assert _took(routes, taken)
    host = hopper_batched.solve_batch(u.clone(), locked, 1e-2, stagger, cap)
    _assert_same_solve(one, batched.solve_batch(u, locked, 1e-2, stagger, cap))
    _assert_same_solve(host, one)
    routes = dict(hopper_batched.routes)
    _assert_same_solve(hopper_batched.update_n_batch(u.clone(), locked, 1, 3),
                       batched.update_n_batch(u, locked, 1, 3))
    assert _took(routes, taken)


@pytest.fixture()
def tiled_route(monkeypatch):
    """Every lane on the tiled route: lane_resident and lane_cluster
    refuse each one."""
    monkeypatch.setattr(hopper_batched, "lane_resident", lambda h, w, device: False)
    monkeypatch.setattr(hopper_batched, "lane_cluster", lambda h, w, device, lanes=None: 0)


# (lanes, H, W, seed) for the tiled route at each depth: lanes on the small
# tile (too few jobs for two big tiles an SM), with odd H and a ragged last
# tile, and lanes on the big tile with odd W.
LANE_TILE_BATCHES = [(3, 101, 150, 12), (40, 200, 331, 13)]


@pytest.mark.parametrize("k", range(1, 17))
def test_lane_tiles_give_the_models_bits_at_every_depth(dev, tiled_route, monkeypatch, k):
    """The tiled route's chunk at every depth 1..16, each its own call
    pattern of the pass (F3 repeated its two call sites): an odd and an
    even chunk count, with and without gating, against tiled's model of the
    lane tiles and the plain version, bit for bit; then a solve whose lanes
    retire at different cycles, against the model on the small tile and the
    plain version on the big one."""
    monkeypatch.setattr(hopper_batched, "DEPTH", k)
    tile = hopper_tile2d.TILE
    for lanes, h, w, seed in LANE_TILE_BATCHES:
        u, locked = _batch(lanes, h, w, 0.1, seed, dev, goalless=(1,))
        gate = torch.arange(lanes, device=dev) % 3 != 2
        for num_steps, active in ((2 * k + 1, None), (2 * k, gate), (1, None)):
            routes = dict(hopper_batched.routes)
            got = hopper_batched.update_n_batch(u.clone(), locked, 1, num_steps, active)
            assert _took(routes, "tiled")
            model = tiled.lanes_update_n(u, locked, 1, num_steps, active, k=k, tile=tile)
            _assert_same_solve(got, model)
            _assert_same_solve(got, batched.update_n_batch(u, locked, 1, num_steps, active))
        cap = 3 * max(h, w)
        got = hopper_batched.solve_batch_device(u.clone(), locked, 1e-2, 7, cap)
        _assert_same_solve(got, tiled.lanes_solve(u, locked, 1e-2, 7, cap, k=k, tile=tile)
                           if lanes < 10 else batched.solve_batch(u, locked, 1e-2, 7, cap))
        assert len(set(got[1].tolist())) > 1   # the lanes retired at different cycles


@pytest.mark.parametrize("stagger,cap", [(1, 400), (7, 403), (100, 550), (100, 1_000_000),
                                         (7, 1_000_000)])
def test_lane_tiles_retire_lanes_unevenly(dev, tiled_route, stagger, cap):
    """The tiled route's solve, one launch and host-driven, on lanes that
    retire at different cycles (a goalless lane first, lanes whose goal
    lies far from most cells later, some never under the cap), capped
    mid-cycle too: the plain version's bits in u, iterations, deltas and
    converged."""
    u, locked = _batch(6, 48, 77, 0.1, 14, dev, goalless=(0, 3))
    eps = torch.tensor([1e-2, 1e-3, 5e-2, 2e-3, 1e-2, 1e-4], device=dev)
    plain = batched.solve_batch(u, locked, eps, stagger, cap)
    one = hopper_batched.solve_batch_device(u.clone(), locked, eps, stagger, cap)
    host = hopper_batched.solve_batch(u.clone(), locked, eps, stagger, cap)
    _assert_same_solve(one, plain)
    _assert_same_solve(host, plain)
    assert len(set(one[1].tolist())) > 2


def test_batch_cluster_rule_on_the_card(dev):
    """The card co-schedules clusters of 8 at least; a 384^2 lane takes a
    cluster whose band fits, a wider one where its batch's clusters would
    fill at most half the SMs, lanes past every cluster the tiles, and the C
    entry's layout size is the wrapper's."""
    from epic_tpu_torch.solver import _build

    lib = _build.load()
    largest = hopper_batched.max_cluster(dev)
    assert 8 <= largest <= 16
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    c = LANE_CLUSTER(384, 384, dev)
    assert 2 <= c <= largest and hopper_batched.cluster_smem_bytes(384, 384, c) <= limit
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for lanes in (1, 8, 16, 32, sms // (2 * c), sms // (2 * c) + 1, 256):
        wide = [k for k in hopper_batched.CLUSTER_SIZES
                if c <= k <= largest and 2 * lanes * k <= sms]
        assert LANE_CLUSTER(384, 384, dev, lanes) == (wide[-1] if wide else c)
        assert hopper_batched._blocks(lanes, 384, 384, dev) == (wide[-1] if wide else c,
                                                                  "cluster")
    side = _past_clusters(dev)
    assert hopper_batched._blocks(1, side, side, dev) == (0, "tiled")
    assert hopper_batched._blocks(2, side, side, dev) == (0, "tiled")
    assert all(hopper_batched.cluster_smem_bytes(side, side, k) > limit
               for k in range(2, largest + 1))
    for h, w in ((384, 384), (3, 131), (5, 60_000), (side, side), (239, 235), (1000, 7)):
        for k in (1, 2, 3, 4, 8, 16):
            assert lib.epic_batched2d_cluster_smem_bytes(h, w, k) == \
                hopper_batched.cluster_smem_bytes(h, w, k)


def test_batch_entries_refuse_a_cluster_that_does_not_fit(dev):
    """Asked for a cluster whose band does not fit, a cluster beyond 16, no
    blocks or a negative block count, both C entries return an error and
    launch nothing: no other route is taken."""
    from epic_tpu_torch.solver import _build

    lib = _build.load()
    limit = torch.cuda.get_device_properties(dev).shared_memory_per_block_optin
    side = _past_clusters(dev)
    cases = [(384, 2), (384, 17), (384, 0), (384, -1), (side, 16)]
    assert hopper_batched.cluster_smem_bytes(384, 384, 2) > limit
    for lanes_side, c in cases:
        u, locked = _batch(2, lanes_side, lanes_side, 0.1, 9, dev)
        start = u.clone()
        it = torch.zeros((), dtype=torch.int32, device=dev)
        delta = torch.zeros(2, dtype=torch.float32, device=dev)
        eps = torch.full((2,), 1e-2, device=dev)
        retired = torch.zeros(2, dtype=torch.uint8, device=dev)
        iters = torch.zeros(2, dtype=torch.int32, device=dev)
        deltas = eps + 1.0
        stream = torch.cuda.current_stream(dev).cuda_stream
        errs = [lib.epic_batched2d_chunk(u.data_ptr(), locked.data_ptr(), 2, lanes_side,
                                         lanes_side, it.data_ptr(), 10, None, delta.data_ptr(),
                                         c, stream, dev.index),
                lib.epic_batched2d_solve(u.data_ptr(), locked.data_ptr(), 2, lanes_side,
                                         lanes_side, eps.data_ptr(), lanes_side, 1000, 10,
                                         retired.data_ptr(), iters.data_ptr(),
                                         deltas.data_ptr(), c, stream, dev.index)]
        torch.cuda.synchronize()
        for name, err in zip(("epic_batched2d_chunk", "epic_batched2d_solve"), errs):
            assert err != 0, (lanes_side, c, name)
            with pytest.raises(RuntimeError, match=name):
                _build.check(err, name)
        assert torch.equal(u, start) and bool((delta == 0).all()) and bool((iters == 0).all())
        assert bool((retired == 0).all()) and torch.equal(deltas, eps + 1.0)


def test_batch_solve_per_lane_epsilon_and_solo_lanes(dev):
    """Epsilon as one value a lane; every lane equals a solo core.solve of
    it on the card, bit for bit."""
    u, locked = _batch(4, 24, 32, 0.1, 4, dev)
    eps = torch.tensor([1e-2, 1e-3, 5e-2, 2e-3], device=dev)
    one = hopper_batched.solve_batch_device(u.clone(), locked, eps, 10)
    _assert_same_solve(hopper_batched.solve_batch(u.clone(), locked, eps, 10), one)
    _assert_same_solve(batched.solve_batch(u, locked, eps, 10), one)
    assert len(set(one[1].tolist())) > 1
    for lane in range(4):
        solo = core.solve(TG.make_state(u[lane], locked[lane], float(eps[lane]), device=dev), 10)
        assert int(solo.iteration) == int(one[1][lane])
        assert torch.equal(solo.u, one[0][lane]) and torch.equal(solo.delta, one[2][lane])


def test_make_goal_batch_on_the_card(dev):
    """The device builder gives the CPU's bits; solve_batch_goals is one
    launch of the solve kernel and equals the plain solve of that batch."""
    img = maps.random_obstacles(24, 32, density=0.12, seed=5)
    base_u = np.full(img.shape, np.float32(-1e6))
    goal_xy = np.array([[[5, 5], [-1, -1]], [[20, 14], [3, 30]], [[9, 9], [33, 2]]], np.int32)
    obstacle_xy = np.array([[[6, 6]], [[-1, -1]], [[9, 9]]], np.int32)
    on_card = hopper_batched.make_goal_batch(base_u, img == 0, goal_xy, obstacle_xy, device=dev)
    on_cpu = hopper_batched.make_goal_batch(base_u, img == 0, goal_xy, obstacle_xy, device="cpu")
    for a, b in zip(on_card, on_cpu):
        assert a.is_contiguous() and torch.equal(a.cpu(), b)
    before = dict(hopper_batched.launches)
    out = hopper_batched.solve_batch_goals(base_u, img == 0, goal_xy, obstacle_xy, 1e-2, 10,
                                           device=dev)
    assert hopper_batched.launches["epic_batched2d_solve"] == before["epic_batched2d_solve"] + 1
    _assert_same_solve(out, batched.solve_batch(*on_card, 1e-2, 10))
    assert bool(out[3].all())


def test_batch_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Checked before any launch; nothing falls back to the plain version."""
    u, locked = _batch(3, 8, 10, 0.1, 0, dev)
    launches, calls = dict(hopper_batched.launches), dict(batched.calls)
    bad = [
        (TypeError, u.double(), locked),
        (TypeError, u, locked.to(torch.uint8)),
        (ValueError, u[0], locked[0]),                               # rank 2
        (ValueError, u.transpose(1, 2), locked.transpose(1, 2)),     # not contiguous
        (ValueError, u, locked.cpu()),
        (ValueError, u, locked[:, :, :5].contiguous()),
    ]
    for exc, bu, bl in bad:
        for call in (lambda a, b: hopper_batched.update_n_batch(a, b, 0, 3),
                     lambda a, b: hopper_batched.solve_batch(a, b),
                     lambda a, b: hopper_batched.solve_batch_device(a, b)):
            with pytest.raises(exc):
                call(bu, bl)
    for exc, kw in ((TypeError, dict(active=torch.ones(3, dtype=torch.uint8, device=dev))),
                    (TypeError, dict(active=torch.ones(2, dtype=torch.bool, device=dev))),
                    (ValueError, dict(active=torch.ones(3, dtype=torch.bool))),
                    (TypeError, dict(iteration=torch.tensor(0, device=dev))),
                    (ValueError, dict(iteration=torch.tensor(0, dtype=torch.int32)))):
        args = {"iteration": 0, "active": None, **kw}
        with pytest.raises(exc):
            hopper_batched.update_n_batch(u, locked, args["iteration"], 3, args["active"])
    assert hopper_batched.launches == launches and batched.calls == calls


def _grid(h, w, dev, seed=3, eps=1e-2, t0=0):
    """A seeded random-obstacle grid at iteration ``t0``."""
    st = TG.from_occupancy_image(maps.random_obstacles(h, w, density=0.12, seed=seed), eps,
                                 device=dev)
    return dataclasses.replace(st, iteration=torch.tensor(t0, dtype=torch.int32, device=dev))


# (H, W) over the kernels' tiles: ragged edges over 3 x 3 tiles of 96 x 160,
# a grid smaller than one tile, a grid within one tile's halo, a tall ragged
# column of tiles, grids whose last row and column of 96 x 160 tiles are
# one cell high and wide (odd extents: an odd count of cells in a class
# row), and a ragged grid of more than two 96 x 160 tiles a SM of an H100,
# which runs on that tile (the others run on the small one, 32 x 96).
TILE_GRIDS = [(250, 400), (37, 91), (20, 30), (300, 45), (97, 161), (193, 321), (2017, 2083)]
# The deepest halo the 96 x 160 tile takes in an H100's shared memory
# (hopper_shard2d.max_depth; the tests that use it check that they do).
H100_MAX_DEPTH = 55


@pytest.mark.parametrize("k", [1, 8, 16, 32, H100_MAX_DEPTH])
@pytest.mark.parametrize("grid", TILE_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_tile_chunk_kernel_gives_the_plain_versions_bits(dev, grid, k):
    """K3/K5 (and T1 with u1): one chunk at depths 1, about k/2 and k, from an
    even and an odd iteration, against the plain tile version and core."""
    h, w = grid
    assert k <= hopper_shard2d.max_depth(dev)
    for t0 in (0, 1):
        st = _grid(h, w, dev, t0=t0)
        for ns in sorted({1, k // 2 + 1, k}):
            for u1 in (False, True):
                before = hopper_tile2d.launches["epic_tile2d_chunk"]
                src = st.u.clone()
                dst, delta, first = hopper_tile2d.sweep_chunk(src, st.locked, st.iteration, ns,
                                                              k=k, u1=u1)
                p_dst, p_delta, p_first = tiled.sweep_chunk(st.u, st.locked, st.iteration, ns,
                                                            k=k, tile=hopper_tile2d.TILE, u1=u1)
                torch.cuda.synchronize()
                assert hopper_tile2d.launches["epic_tile2d_chunk"] == before + 1
                assert torch.equal(src, st.u)                      # the source is untouched
                assert torch.equal(dst, p_dst) and torch.equal(delta, p_delta)
                assert torch.equal(dst, core.update_n(st, ns).u)
                if u1:
                    assert torch.equal(first, p_first)
                    assert torch.equal(first, core.update_n(st, 1).u)


@pytest.mark.parametrize("n_chunks,num_sweeps", [(1, 5), (2, 32), (3, 40), (4, 61), (5, 5)])
def test_tile_cycle_kernel_gives_the_plain_versions_bits(dev, n_chunks, num_sweeps):
    """K4/K6: odd and even chunk counts in one launch, per-chunk deltas; the
    state ends in a for an even count and in b for an odd one."""
    for h, w in TILE_GRIDS[:3]:
        st = _grid(h, w, dev, seed=5, t0=7)
        a, b = st.u.clone(), torch.full_like(st.u, -1e6)
        before = hopper_tile2d.launches["epic_tile2d_cycle"]
        ka, kb, kd = hopper_tile2d.sweep_cycle(a, b, st.locked, st.iteration, n_chunks,
                                               num_sweeps, k=16)
        pa, pb, pd = tiled.sweep_cycle(st.u, st.u, st.locked, st.iteration, n_chunks,
                                       num_sweeps, k=16, tile=hopper_tile2d.TILE)
        torch.cuda.synchronize()
        assert hopper_tile2d.launches["epic_tile2d_cycle"] == before + 1
        assert ka is a and kb is b
        assert torch.equal(kd, pd) and kd.shape == (n_chunks,)
        final = ka if n_chunks % 2 == 0 else kb
        assert torch.equal(final, pa if n_chunks % 2 == 0 else pb)
        assert torch.equal(final, core.update_n(st, num_sweeps).u)


@pytest.mark.parametrize("k", [1, 8, 16, 32])
@pytest.mark.parametrize("stagger,cap", [(100, 1_000_000), (1, 1_000_000), (7, 1_000_000),
                                         (13, 1_000_000), (100, 250), (10, 95)])
def test_tile_solve_kernel_gives_the_plain_versions_bits(dev, stagger, cap, k):
    """The one-launch protocol: converged and capped solves on ragged grids
    (3 x 3 ragged tiles, and a grid smaller than one tile), core's bits;
    the segmented solve gives the same."""
    for h, w in TILE_GRIDS[:2]:
        st = _grid(h, w, dev, seed=7, t0=5)
        before = dict(hopper_tile2d.launches)
        kern = hopper_tile2d.solve(dataclasses.replace(st, u=st.u.clone()), stagger, cap, k)
        seg = hopper_tile2d.solve_segments(dataclasses.replace(st, u=st.u.clone()), stagger,
                                           cap, 37, k)
        plain = core.solve(st, stagger, cap)
        _assert_same(kern, plain)
        _assert_same(seg, plain)
        assert hopper_tile2d.launches["epic_tile2d_solve"] > before["epic_tile2d_solve"] + 1
        if cap == 1_000_000:
            assert bool(kern.converged) and int(kern.iteration) % stagger == 1 % stagger


def test_tile_update_n_runs_cycle_and_remainder_chunk(dev):
    """A tick of an even chunk count is one cycle launch; an odd count adds
    the remainder chunk, copied back into the caller's u."""
    st = _grid(150, 300, dev, seed=9, t0=3)
    for n, cycles, chunks in ((50, 1, 0), (100, 1, 1), (1, 0, 1), (16, 0, 1), (33, 1, 1)):
        before = dict(hopper_tile2d.launches)
        k = hopper_tile2d.update_n(dataclasses.replace(st, u=st.u.clone()), n)
        _assert_same(k, core.update_n(st, n))
        assert hopper_tile2d.launches["epic_tile2d_cycle"] == before["epic_tile2d_cycle"] + cycles
        assert hopper_tile2d.launches["epic_tile2d_chunk"] == before["epic_tile2d_chunk"] + chunks


def test_planner_beyond_l2_runs_the_tile_kernels(dev):
    """A Planner whose grid is past the routing crossover (two thirds of the
    card's L2; this one is past three quarters) ticks and solves on the tile
    kernels, and gives core's bits; a small grid stays on sweep2d."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    side = int((0.75 * l2 / 5) ** 0.5) + 64
    assert hopper_tile2d.use_tiles((side, side), dev)
    assert not hopper_tile2d.use_tiles((512, 512), dev)
    tp = Planner(PlannerConfig(epsilon=1e-2, steps_per_update=25), device=dev)
    tp.state = TG.from_occupancy_image(maps.random_obstacles(side, side, seed=2), 1e-2,
                                       device=dev)
    replay = dataclasses.replace(tp.state, u=tp.state.u.clone())
    u = tp.state.u
    launches, sweep, calls = dict(hopper_tile2d.launches), dict(hopper_sweep.launches), \
        dict(core.calls)
    tp.update()
    tp.update(100)
    tp.solve(max_iterations=300)
    assert hopper_tile2d.launches["epic_tile2d_cycle"] == launches["epic_tile2d_cycle"] + 2
    assert hopper_tile2d.launches["epic_tile2d_chunk"] == launches["epic_tile2d_chunk"] + 1
    assert hopper_tile2d.launches["epic_tile2d_solve"] == launches["epic_tile2d_solve"] + 1
    assert hopper_sweep.launches == sweep and core.calls == calls
    replay = core.update_n(core.update_n(replay, 25), 100)
    _assert_same(tp.state, core.solve(replay, 100, 300))
    assert tp.state.u is u                 # relaxed in place, like every wrapper


def test_planner_between_two_thirds_and_three_quarters_of_l2_runs_the_tiles(dev):
    """The band the crossover moved: a grid just past two thirds of the L2
    (and under three quarters) ticks and solves on the tile kernels with
    core's bits; one just under two thirds stays on sweep2d."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    side = int((2 * l2 / 15) ** 0.5) + 16
    assert 15 * side * side > 2 * l2 and 20 * side * side < 3 * l2
    assert hopper_tile2d.use_tiles((side, side), dev)
    assert not hopper_tile2d.use_tiles((side - 32, side - 32), dev)
    tp = Planner(PlannerConfig(epsilon=1e-2, steps_per_update=25), device=dev)
    tp.state = TG.from_occupancy_image(maps.random_obstacles(side, side, seed=3), 1e-2,
                                       device=dev)
    replay = dataclasses.replace(tp.state, u=tp.state.u.clone())
    launches, sweep = dict(hopper_tile2d.launches), dict(hopper_sweep.launches)
    tp.update()
    tp.solve(max_iterations=300)
    assert hopper_tile2d.launches["epic_tile2d_solve"] == launches["epic_tile2d_solve"] + 1
    assert sum(hopper_tile2d.launches.values()) >= sum(launches.values()) + 2
    assert hopper_sweep.launches == sweep
    _assert_same(tp.state, core.solve(core.update_n(replay, 25), 100, 300))


def test_tile_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Checked before any launch; nothing falls back to the plain version."""
    st = _grid(40, 70, dev)
    u, locked = st.u, st.locked
    launches, calls = dict(hopper_tile2d.launches), dict(tiled.calls)
    with pytest.raises(ValueError, match="distinct"):
        hopper_tile2d.sweep_chunk(u, locked, 0, 3, out=u)
    with pytest.raises(ValueError, match="distinct"):
        hopper_tile2d.sweep_cycle(u, u, locked, 0, 2)
    bad = [
        (TypeError, u.double(), locked),
        (TypeError, u, locked.to(torch.uint8)),
        (ValueError, u.t(), locked.t()),                          # not contiguous
        (ValueError, u, locked.cpu()),
        (ValueError, u[None], locked[None]),                      # rank 3
    ]
    for exc, bu, bl in bad:
        with pytest.raises(exc):
            hopper_tile2d.sweep_chunk(bu, bl, 0, 3)
        with pytest.raises(exc):
            hopper_tile2d.sweep_cycle(bu, torch.empty_like(bu), bl, 0, 2)
    with pytest.raises(ValueError):
        hopper_tile2d.sweep_chunk(u, locked, 0, 3, out=torch.empty_like(u).cpu())
    with pytest.raises(ValueError):
        hopper_tile2d.sweep_chunk(u, locked, 0, 17)                # deeper than k
    with pytest.raises(ValueError, match="shared memory"):
        hopper_tile2d.update_n(st, 5, k=100)
    for exc, fields in ((TypeError, dict(u=st.u.double())), (ValueError, dict(locked=locked.cpu())),
                        (TypeError, dict(iteration=st.iteration.long()))):
        for call in (lambda s: hopper_tile2d.update_n(s, 3), lambda s: hopper_tile2d.solve(s)):
            with pytest.raises(exc):
                call(dataclasses.replace(st, **fields))
    assert hopper_tile2d.launches == launches and tiled.calls == calls


# Volumes over the kernels' 32 x 128 columns (hopper_tile3d.COLUMN): ragged on
# every axis over several columns, a volume smaller than one column, one
# within a column's halo, a deep ragged column, and two deeper ones. The
# tile rule cuts z into segments (TZ < D) wherever the card has room for
# more blocks: 20 and 19 into two of 10, 70 into eight of 9, 100 into twelve
# of 9, the last segments ragged; 5 and 9 keep TZ = D.
TILE_VOLUMES = [(20, 37, 150), (5, 6, 7), (9, 18, 70), (19, 20, 40), (70, 20, 70),
                (100, 33, 65)]


@pytest.fixture(params=["rule", "short"])
def segments(request, monkeypatch):
    """The tile rule as it stands, or with segments of 3 planes and more
    (shorter than the deepest halo: the z halo of a segment reaches past its
    neighbours)."""
    if request.param == "short":
        monkeypatch.setattr(hopper_tile3d, "MIN_SEGMENT", 3)
    return request.param


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("shape", TILE_VOLUMES, ids=lambda s: "x".join(map(str, s)))
def test_tile3d_chunk_kernel_gives_the_plain_versions_bits(dev, shape, k, segments):
    """K8/K10 (T3, and with u1 the K10 check): one chunk at depths 1 and k,
    from an even and an odd iteration, against the plain tile version (on
    the rule's tile) and core."""
    tile = hopper_tile3d.tile_for(shape, dev)
    if segments == "short":
        assert tile[0] < shape[0] or shape[0] < 6
    for t0 in (0, 1):
        st = _volume(shape, 0.1, 3, dev, t0)
        for ns in sorted({1, (k + 1) // 2, k}):
            for u1 in (False, True):
                before = hopper_tile3d.launches["epic_tile3d_chunk"]
                src = st.u.clone()
                dst, delta, first = hopper_tile3d.sweep_chunk(src, st.locked, st.iteration, ns,
                                                              k=k, u1=u1)
                p_dst, p_delta, p_first = tiled3d.sweep_chunk(
                    st.u, st.locked, st.iteration, ns, k=k, tile=tile, u1=u1)
                torch.cuda.synchronize()
                assert hopper_tile3d.launches["epic_tile3d_chunk"] == before + 1
                assert torch.equal(src, st.u)                      # the source is untouched
                assert torch.equal(dst, p_dst) and torch.equal(delta, p_delta)
                assert torch.equal(dst, core.update_n(st, ns).u)
                assert torch.equal(delta, core.update_n(st, ns).delta)
                if u1:
                    assert torch.equal(first, p_first)
                    assert torch.equal(first, core.update_n(st, 1).u)


# An odd and an even chunk count at every depth 1..MAX_DEPTH (each depth is
# its own kernel instantiation), and more counts at K = 2.
@pytest.mark.parametrize("n_chunks,num_sweeps,k", [(3, 3, 1), (4, 4, 1), (1, 2, 2), (2, 4, 2),
                                                   (3, 5, 2), (3, 6, 2), (4, 7, 2), (3, 8, 3),
                                                   (4, 11, 3), (3, 12, 4), (4, 14, 4),
                                                   (3, 13, 5), (4, 19, 5)])
def test_tile3d_cycle_kernel_gives_the_plain_versions_bits(dev, n_chunks, num_sweeps, k,
                                                           segments):
    """K9/K11: odd and even chunk counts in one launch, per-chunk deltas; the
    state ends in a for an even count and in b for an odd one."""
    for shape in TILE_VOLUMES[:3] + TILE_VOLUMES[4:]:
        st = _volume(shape, 0.1, 5, dev, t0=7)
        a, b = st.u.clone(), torch.full_like(st.u, -1e6)
        before = hopper_tile3d.launches["epic_tile3d_cycle"]
        ka, kb, kd = hopper_tile3d.sweep_cycle(a, b, st.locked, st.iteration, n_chunks,
                                               num_sweeps, k=k)
        pa, pb, pd = tiled3d.sweep_cycle(st.u, st.u, st.locked, st.iteration, n_chunks,
                                         num_sweeps, k=k, tile=hopper_tile3d.tile_for(shape, dev))
        torch.cuda.synchronize()
        assert hopper_tile3d.launches["epic_tile3d_cycle"] == before + 1
        assert ka is a and kb is b
        assert torch.equal(kd, pd) and kd.shape == (n_chunks,)
        final = ka if n_chunks % 2 == 0 else kb
        assert torch.equal(final, pa if n_chunks % 2 == 0 else pb)
        assert torch.equal(final, core.update_n(st, num_sweeps).u)


@pytest.mark.parametrize("k", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("stagger,cap", [(100, 1_000_000), (1, 1_000_000), (7, 1_000_000),
                                         (100, 250), (10, 95)])
def test_tile3d_solve_kernel_gives_the_plain_versions_bits(dev, stagger, cap, k, segments):
    """The one-launch protocol: converged and capped solves on ragged
    volumes (several ragged columns, a volume smaller than one column, one
    cut into segments), core's bits; the segmented solve, resumed at
    stagger-aligned bounds, gives the same."""
    for shape in (TILE_VOLUMES[0], TILE_VOLUMES[1], TILE_VOLUMES[4]):
        st = _volume(shape, 0.1, 7, dev, t0=5)
        before = dict(hopper_tile3d.launches)
        kern = hopper_tile3d.solve(dataclasses.replace(st, u=st.u.clone()), stagger, cap, k)
        seg = hopper_tile3d.solve_segments(dataclasses.replace(st, u=st.u.clone()), stagger,
                                           cap, 37, k)
        plain = core.solve(st, stagger, cap)
        _assert_same(kern, plain)
        _assert_same(seg, plain)
        _assert_same(tiled3d.solve_segments(st, stagger, cap, 37, k=k,
                                            tile=hopper_tile3d.tile_for(shape, dev)), plain)
        assert hopper_tile3d.launches["epic_tile3d_solve"] > before["epic_tile3d_solve"] + 1
        if cap == 1_000_000:
            assert bool(kern.converged) and int(kern.iteration) % stagger == 1 % stagger


def test_tile3d_update_n_runs_cycle_and_remainder_chunk(dev):
    """A tick of an even chunk count is one cycle launch; an odd count adds
    the remainder chunk, copied back into the caller's u. The twin is
    scratch kept across calls for the last shape; u1 only a solve takes."""
    st = _volume(TILE_VOLUMES[4], 0.1, 9, dev, t0=3)
    k = hopper_tile3d.DEFAULT_DEPTH
    scratch = hopper_tile3d._kernels.scratch
    scratch.clear()
    twin = None
    for n in (1, 2, 3, 5, 50, 100, 33):
        before = dict(hopper_tile3d.launches)
        out = hopper_tile3d.update_n(dataclasses.replace(st, u=st.u.clone()), n)
        _assert_same(out, core.update_n(st, n))
        _, n_chunks, tail = tiled3d.tick_schedule(n, k)
        assert hopper_tile3d.launches["epic_tile3d_cycle"] == \
            before["epic_tile3d_cycle"] + (n_chunks > 0)
        assert hopper_tile3d.launches["epic_tile3d_chunk"] == \
            before["epic_tile3d_chunk"] + (tail > 0)
        twin = scratch["twin"] if twin is None else twin
        assert scratch["twin"] is twin and "u1" not in scratch
    hopper_tile3d.solve(dataclasses.replace(st, u=st.u.clone()), 10, 40)
    assert scratch["twin"] is twin and "u1" in scratch
    hopper_tile3d.update_n(_volume(TILE_VOLUMES[1], 0.1, 9, dev), 3)
    assert scratch["twin"].shape == TILE_VOLUMES[1]


def test_router_sends_every_volume_to_the_z_walk(dev):
    """Every volume runs on K7 (its z walk measured as fast or faster than
    the tiles everywhere, tile_probe.py --volumes): a VolumePlanner on a
    wide-plane volume beyond the L2, a cube past it and a small volume ticks
    and solves on sweep3d and gives core's bits; the tile kernels and the
    plain version do not run."""
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    side = int((1.5 * l2 / 5) ** (1 / 3)) + 4
    for shape in ((8, 1536, 1536), (side, side, side), (12, 20, 28)):
        tp = VolumePlanner(VolumePlannerConfig(epsilon=1e-2, steps_per_update=25), device=dev)
        tp.state = _volume(shape, 0.1, 2, dev)
        replay = dataclasses.replace(tp.state, u=tp.state.u.clone())
        u = tp.state.u
        t3, s3, calls = dict(hopper_tile3d.launches), dict(hopper_sweep3d.launches), \
            dict(core.calls)
        tp.update()
        tp.update(100)
        tp.solve(max_iterations=300)
        moved = {n: hopper_tile3d.launches[n] - t3[n] for n in t3}
        moved_k7 = {n: hopper_sweep3d.launches[n] - s3[n] for n in s3}
        assert moved_k7 == {"epic_sweep3d_chunk": 2, "epic_sweep3d_solve": 1}
        assert not any(moved.values())
        assert core.calls == calls
        replay = core.update_n(core.update_n(replay, 25), 100)
        _assert_same(tp.state, core.solve(replay, 100, 300))
        assert tp.state.u is u                 # relaxed in place, like every wrapper


def test_tile3d_wrappers_refuse_what_the_kernels_do_not_take(dev):
    """Checked before any launch; nothing falls back to the plain version."""
    st = _volume((9, 18, 70), 0.1, 1, dev)
    u, locked = st.u, st.locked
    launches, calls = dict(hopper_tile3d.launches), dict(tiled3d.calls)
    with pytest.raises(ValueError, match="distinct"):
        hopper_tile3d.sweep_chunk(u, locked, 0, 2, out=u)
    with pytest.raises(ValueError, match="distinct"):
        hopper_tile3d.sweep_cycle(u, u, locked, 0, 2)
    bad = [
        (TypeError, u.double(), locked),
        (TypeError, u, locked.to(torch.uint8)),
        (ValueError, u.transpose(0, 2), locked.transpose(0, 2)),     # not contiguous
        (ValueError, u, locked.cpu()),
        (ValueError, u[0], locked[0]),                               # rank 2
    ]
    for exc, bu, bl in bad:
        with pytest.raises(exc):
            hopper_tile3d.sweep_chunk(bu, bl, 0, 2)
        with pytest.raises(exc):
            hopper_tile3d.sweep_cycle(bu, torch.empty_like(bu), bl, 0, 2)
    with pytest.raises(ValueError):
        hopper_tile3d.sweep_chunk(u, locked, 0, 2, out=torch.empty_like(u).cpu())
    with pytest.raises(ValueError):
        hopper_tile3d.sweep_chunk(u, locked, 0, hopper_tile3d.DEFAULT_DEPTH + 1)  # > k
    deep = hopper_tile3d.MAX_DEPTH + 1
    for call in (lambda: hopper_tile3d.update_n(st, 5, k=deep),
                 lambda: hopper_tile3d.solve(st, 10, 100, k=deep),
                 lambda: hopper_tile3d.sweep_chunk(u, locked, 0, deep, k=deep)):
        with pytest.raises(ValueError, match="shared memory"):     # too deep for a block
            call()
    for exc, fields in ((TypeError, dict(u=st.u.double())), (ValueError, dict(locked=locked.cpu())),
                        (TypeError, dict(iteration=st.iteration.long()))):
        for call in (lambda s: hopper_tile3d.update_n(s, 3), lambda s: hopper_tile3d.solve(s)):
            with pytest.raises(exc):
                call(dataclasses.replace(st, **fields))
    assert hopper_tile3d.launches == launches and tiled3d.calls == calls


# -- the 2D mesh: epic_shard2d_chunk in csrc/tile2d.cu ---------------------------------------

# (h, w, k): one shard's centre and halo depth: ragged over several 96 x 160
# tiles, a non-aligned small shard with odd extents (he x we = 53 x 107: odd
# class rows), a centre smaller than its halo, the deepest halo the tile
# takes in an H100's shared memory, a one-column shard at k = 1, shards
# whose last tiles are one row high and one column wide (odd extents at
# odd and even depths), and a ragged shard of more than two 96 x 160 tiles
# a SM (the big tile; the others run on the small one).
SHARDS = [(250, 400, 16), (37, 91, 8), (5, 9, 7), (70, 140, H100_MAX_DEPTH), (33, 1, 1),
          (97, 161, 3), (193, 321, 12), (64, 127, 5), (2001, 2083, 16)]


def _shard_block(h, w, k, dev, seed):
    """A random extended block (obstacles, goals, a frozen out-of-mesh edge)
    inside a buffer with a 3 cells deeper halo: views with a row pitch."""
    rng = np.random.default_rng(seed)
    H = k + 3
    he, we = h + 2 * H, w + 2 * H
    u = np.where(rng.random((he, we)) < 0.05, 0.0, -rng.random((he, we)) * 40).astype(np.float32)
    frozen = rng.random((he, we)) < 0.15
    frozen[:H + 1, :] = True        # a shard on the mesh's top edge
    u[frozen & (rng.random((he, we)) < 0.5)] = -1e6
    view = (slice(H - k, H + h + k), slice(H - k, H + w + k))
    return (torch.from_numpy(u).to(dev), torch.from_numpy(frozen).to(dev), view)


@pytest.mark.parametrize("shard", SHARDS, ids=lambda s: f"{s[0]}x{s[1]}-k{s[2]}")
def test_shard_chunk_kernel_gives_the_plain_versions_bits(dev, shard):
    """K14/K15: odd and even origins and iterations, ns = 1, < k and = k,
    u1 on and off, against the plain per-shard version on the same view."""
    h, w, k = shard
    assert k <= hopper_shard2d.max_depth(dev)
    for seed, par0 in ((0, 0), (1, 1)):
        u, frozen, view = _shard_block(h, w, k, dev, seed)
        for t0 in (0, 3):
            for ns in sorted({1, k // 2 + 1, k}):
                for with_u1 in (False, True):
                    dst, u1 = torch.full_like(u, 5.0), torch.full_like(u, 5.0)
                    before = hopper_shard2d.launches["epic_shard2d_chunk"]
                    calls = hopper_shard2d.calls["sweep_k_local"]
                    src = u.clone()
                    d = hopper_shard2d.chunk(src[view], dst[view], frozen[view], k=k, par0=par0,
                                             iteration=t0, ns=ns,
                                             u1=u1[view] if with_u1 else None, want_delta=True)
                    torch.cuda.synchronize()
                    assert hopper_shard2d.launches["epic_shard2d_chunk"] == before + 1
                    assert hopper_shard2d.calls["sweep_k_local"] == calls
                    ref, ref_d, ref_u1 = hopper_shard2d.sweep_k_local(
                        u[view], frozen[view], par0, t0, ns, u1=True)
                    c = (slice(k, h + k), slice(k, w + k))
                    assert torch.equal(src, u)
                    assert torch.equal(dst[view][c], ref[c]) and torch.equal(d, ref_d)
                    outside = torch.ones_like(dst, dtype=torch.bool)
                    outside[view[0].start + k:view[0].start + k + h,
                            view[1].start + k:view[1].start + k + w] = False
                    assert (dst[outside] == 5.0).all()       # only the centre is written
                    if with_u1:
                        assert torch.equal(u1[view][c], ref_u1[c])
                    else:
                        assert (u1 == 5.0).all()


def test_tile_smem_formulas_are_what_the_kernels_ask_for(dev):
    """The wrappers' shared-memory formulas (the 2D class-split layout, the
    3D ring of K + 3 planes) equal the bytes each library's launches ask for, and
    H100_MAX_DEPTH is the 2D kernels' deepest halo on this card."""
    from epic_tpu_torch.solver import _build
    lib = _build.load()
    for k in range(1, 80):
        assert lib.epic_tile2d_smem_bytes(k) == hopper_tile2d.smem_bytes(k)
    for k in range(1, hopper_tile3d.MAX_DEPTH + 1):
        assert lib.epic_tile3d_smem_bytes(k) == hopper_tile3d.smem_bytes(k)
    if torch.cuda.get_device_properties(dev).shared_memory_per_block_optin == 232_448:
        assert hopper_shard2d.max_depth(dev) == H100_MAX_DEPTH


def test_shard_chunk_refuses_what_the_kernel_does_not_take(dev):
    u, frozen, view = _shard_block(20, 30, 4, dev, 0)
    src, dst = u[view], u.clone()[view]
    launches = dict(hopper_shard2d.launches)
    kw = dict(k=4, par0=0, iteration=0, ns=2)
    with pytest.raises(ValueError, match="distinct"):
        hopper_shard2d.chunk(src, src, frozen[view], **kw)
    with pytest.raises(TypeError):
        hopper_shard2d.chunk(src, dst, frozen[view].to(torch.uint8), **kw)
    with pytest.raises(ValueError, match="pitch"):
        hopper_shard2d.chunk(src, dst.contiguous(), frozen[view], **kw)
    with pytest.raises(ValueError, match="1..k"):
        hopper_shard2d.chunk(src, dst, frozen[view], k=4, par0=0, iteration=0, ns=5)
    with pytest.raises(ValueError, match="no centre"):
        hopper_shard2d.chunk(src, dst, frozen[view], k=20, par0=0, iteration=0, ns=2)
    deep = hopper_shard2d.max_depth(dev) + 1
    u, frozen, view = _shard_block(2 * deep, 2 * deep, deep, dev, 0)
    with pytest.raises(ValueError, match="shared memory"):
        hopper_shard2d.chunk(u[view], u.clone()[view], frozen[view], k=deep, par0=0, iteration=0,
                             ns=1)
    assert hopper_shard2d.launches == launches


@pytest.mark.parametrize("shape,depth", [((2, 4), 16), ((2, 4), 64), ((8, 1), 4), ((1, 1), 16)])
def test_virtual_mesh_update_and_solve_give_cores_bits(dev, shape, depth):
    """The mesh solver on P shards of the one card, on the per-shard route
    ("pallas") and the resident route ("resident", which "auto" takes):
    ticks from both parities and solves (converged, capped, and in
    segments on the resident route) equal core's; only the CUDA entries
    run."""
    mesh = make_mesh(shape, devices=[dev] * (shape[0] * shape[1]))
    before = dict(hopper_shard2d.launches), dict(hopper_resident2d.launches)
    calls = dict(hopper_shard2d.calls), dict(hopper_resident2d.calls)
    for kernel in ("pallas", "resident", "auto"):
        for t0 in (0, 1):
            st = _grid(67, 101, dev, t0=t0)
            for n in (1, 50):
                _assert_same(sharded.update_n(st, n, mesh, chunk_depth=depth, kernel=kernel),
                             core.update_n(st, n))
        st = _grid(67, 101, dev, seed=5, eps=1e-1)
        for stagger, cap in ((100, 1_000_000), (7, 1_000_000), (10, 95)):
            out = sharded.solve(st, mesh, stagger, cap, chunk_depth=depth, kernel=kernel)
            _assert_same(out, core.solve(st, stagger, cap))
    out = sharded.solve(st, mesh, 100, chunk_depth=depth, kernel="resident",
                        segment_iterations=150)
    _assert_same(out, core.solve(st, 100))
    assert hopper_shard2d.launches["epic_shard2d_chunk"] > before[0]["epic_shard2d_chunk"]
    for name, n in hopper_resident2d.launches.items():
        assert n > before[1][name]
    assert (dict(hopper_shard2d.calls), dict(hopper_resident2d.calls)) == calls
    for kernel in ("xla", "pallas_interpret", "resident_interpret"):   # the plain versions' names
        with pytest.raises(ValueError, match="plain version"):
            sharded.update_n(st, 3, mesh, kernel=kernel)


def test_mesh_planner_on_the_card_equals_the_planner(dev):
    """A MeshPlanner on a 2 x 4 virtual mesh and a Planner on the card run
    one session to the same bits; the mesh never runs a plain version or a
    single-device kernel."""
    img = maps.recursive_maze(96, 160, seed=3)
    occ = np.where(img == 0, 100, 0).astype(np.int8)
    gy, gx = [int(v) for v in np.argwhere(img == 255)[0]]
    cfg = PlannerConfig(epsilon=1e-2, steps_per_update=25)
    mp = MeshPlanner(cfg, mesh=make_mesh((2, 4), devices=[dev] * 8), kernel="pallas")
    sp = Planner(PlannerConfig(epsilon=1e-2, steps_per_update=25), device=dev)
    for pl in (mp, sp):
        pl.init(160, 96)
        pl.update_occupancy(occ)
        assert pl.add_goals([(float(gx), float(gy))])
    counts = (dict(hopper_shard2d.launches), dict(hopper_shard2d.calls), dict(core.calls))
    for pl in (mp, sp):
        for _ in range(3):
            pl.update()
        pl.set_cells([(10, 10)], [C.CELL_TYPE_OBSTACLE])
        pl.update(13)
        pl.solve()
    assert hopper_shard2d.launches["epic_shard2d_chunk"] > counts[0]["epic_shard2d_chunk"]
    assert hopper_shard2d.calls == counts[1] and core.calls == counts[2]
    assert mp.get_cell(10, 10) == sp.get_cell(10, 10) == -1e6
    a, b = mp.state, sp.state
    assert a.u.device == dev and torch.equal(a.u, b.u)
    assert int(a.iteration) == int(b.iteration) and bool(a.converged) and bool(b.converged)


# -- the 2D resident route: epic_resident2d_cycle and epic_resident2d_solve -------------------

# Grids for the resident route on 2 x 4: shards of 75 x 75 (one ragged
# 96 x 160 tile each), of 97 x 161 (odd extents, the last tiles one row
# high and one column wide), and of 1001 x 1001 (ragged, more than two
# 96 x 160 tiles a SM of an H100 in all: that tile; the others the small).
RESIDENT_GRIDS = [(150, 300), (194, 644), (2002, 4004)]


def _resident_grid(dev, t0=0, seed=0, halo=16, eps=1e-2, image=False, shape=(150, 300)):
    """A ShardedGrid on a 2 x 4 virtual mesh of the card: ``shape`` (by
    default 150 x 300, shards of 75 x 75, one ragged 96 x 160 tile
    each), a random field with obstacles and goals (or, with ``image``, a
    seeded random-obstacle map that converges), its frozen halos exchanged
    and u1 blocks allocated."""
    if image:
        st = _grid(*shape, dev, seed=seed, eps=eps, t0=t0)
    else:
        rng = np.random.default_rng(seed)
        u = np.where(rng.random(shape) < 0.05, 0.0, -rng.random(shape) * 40).astype(np.float32)
        st = TG.make_state(u, rng.random(shape) < 0.15, eps, device=dev)
        st = dataclasses.replace(st, iteration=torch.tensor(t0, dtype=torch.int32, device=dev))
    mesh = make_mesh((2, 4), devices=[dev] * 8)
    sh = sharded.shard_state(st, mesh, halo=halo)
    sharded._frozen_halos(sh, halo)
    sh.u1_blocks = sharded._blank(mesh, sh.u_blocks[0, 0].shape, sharded.FILL, torch.float32)
    return sh


def _copy_grid(sh):
    c = copy.copy(sh)
    for name in ("u_blocks", "twin_blocks", "u1_blocks", "frozen_blocks"):
        setattr(c, name, {ij: b.clone() for ij, b in getattr(sh, name).items()})
    return c


def _same_blocks(a, b):
    torch.cuda.synchronize()
    for name in ("u_blocks", "twin_blocks", "u1_blocks"):
        for ij in a.mesh.local:
            assert torch.equal(getattr(a, name)[ij], getattr(b, name)[ij]), (name, ij)


@pytest.mark.parametrize("grid", RESIDENT_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
@pytest.mark.parametrize("n_chunks,total", [(1, 16), (2, 32), (3, 40), (2, 17), (3, 4)])
def test_resident_cycle_gives_the_plain_versions_bits(dev, n_chunks, total, grid):
    """K16/K17: 1, 2 and 3 chunks (spread, a ragged remainder) on all eight
    shards in one launch, with and without u1, from both parities, against
    the plain version on the same blocks: every block and every chunk's
    delta the same bits."""
    for t0 in (0, 1):
        for with_u1 in (False, True):
            sh = _resident_grid(dev, t0=t0, seed=t0, shape=grid)
            ref = _copy_grid(sh)
            plan = hopper_resident2d.plans(sh.mesh)[0]
            assert plan.whole and len(plan.slots) == 8
            before, calls = dict(hopper_resident2d.launches), dict(hopper_resident2d.calls)
            d = hopper_resident2d.cycle(sh, plan, 16, sh.iteration, total, n_chunks, u1=with_u1)
            torch.cuda.synchronize()
            assert hopper_resident2d.launches["epic_resident2d_cycle"] == \
                before["epic_resident2d_cycle"] + 1
            assert hopper_resident2d.calls == calls
            p = hopper_resident2d.plain_cycle(ref, plan, 16, ref.iteration, total, n_chunks,
                                              u1=with_u1)
            assert torch.equal(d, p) and bool((d > 0).all())
            _same_blocks(sh, ref)


@pytest.mark.parametrize("grid", RESIDENT_GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_resident_cycle_with_copied_neighbours_gives_the_same_bits(dev, grid):
    """Neighbours forced to "copied" in the plan: the host copies their
    halos between one-chunk launches, and the result is the all-direct
    three-chunk launch's, bit for bit, with the same deltas."""
    sh = _resident_grid(dev, t0=1, seed=4, shape=grid)
    ref = _copy_grid(sh)
    plan = hopper_resident2d.plans(sh.mesh)[0]
    d_all = hopper_resident2d.cycle(ref, plan, 16, ref.iteration, 40, 3, u1=True)
    sharded._swap(ref)                        # three chunks: the state is in the twins
    kinds = {ij: dict(nb) for ij, nb in plan.kinds.items()}
    for ij, offsets in {(0, 1): [(0, 1), (1, 1), (1, 0), (1, -1)], (1, 2): [(-1, -1), (0, -1)],
                        (1, 3): [(-1, 0), (-1, -1)]}.items():
        for d in offsets:
            kinds[ij][d] = hopper_resident2d.COPIED
    forced = hopper_resident2d.Plan(plan.device, list(plan.slots), kinds)
    assert not forced.whole
    transfers = hopper_resident2d.copied_transfers(sh.mesh, [forced], sh.h_loc, sh.w_loc,
                                                   sh.halo, 16)
    with pytest.raises(ValueError, match="one chunk a launch"):
        hopper_resident2d.cycle(sh, forced, 16, sh.iteration, 40, 3)
    deltas = []
    for c, ns in enumerate((14, 13, 13)):
        sharded._run_phase(sh.mesh, sh.u_blocks, transfers)
        deltas.append(hopper_resident2d.cycle(sh, forced, 16, sh.iteration, ns, 1,
                                              t_off=sum((14, 13, 13)[:c]), u1=c == 0)[0])
        sharded._swap(sh)
    torch.cuda.synchronize()
    assert torch.equal(torch.stack(deltas), d_all)
    for ij in sh.mesh.local:
        for name in ("u_blocks", "u1_blocks"):
            a, b = sh.centre(getattr(sh, name), ij), ref.centre(getattr(ref, name), ij)
            assert torch.equal(a, b), (name, ij)


@pytest.mark.parametrize("stagger,cap", [(100, 1_000_000), (7, 1_000_000), (10, 95)])
def test_resident_solve_resumed_across_segments_gives_one_launchs_bits(dev, stagger, cap):
    """The solve entry resumed at the segment bounds of 37 sweeps against
    one launch, and both against the plain version and core: the same bits,
    iterations and verdicts, and one launch leaves every block (the twin
    and u1 too) as the plain version does."""
    st = _grid(150, 300, dev, seed=5, eps=1e-1)
    runs, grids = {}, {}
    for name in ("one", "segments", "plain"):
        sh = grids[name] = _resident_grid(dev, seed=5, eps=1e-1, image=True)
        plan = hopper_resident2d.plans(sh.mesh)[0]
        it = torch.zeros((), dtype=torch.int32, device=dev)
        delta = (sh.epsilon + 1.0).to(torch.float32)
        done = torch.zeros((), dtype=torch.int32, device=dev)
        bounds = tiled.segment_bounds(stagger, cap, 37) if name == "segments" else [cap]
        run = hopper_resident2d.plain_solve if name == "plain" else hopper_resident2d.solve
        for bound in bounds:
            run(sh, plan, 16, stagger, bound, it, delta, done)
            if bool(done):
                break
        torch.cuda.synchronize()
        runs[name] = (sharded.unshard(sh).u, int(it), float(delta), int(done))
    ref = core.solve(st, stagger, cap)
    _same_blocks(grids["one"], grids["plain"])       # the twin and u1 blocks too
    for name in ("segments", "plain"):
        assert torch.equal(runs[name][0], runs["one"][0]) and runs[name][1:] == runs["one"][1:]
    assert torch.equal(runs["one"][0], ref.u)
    assert runs["one"][1:] == (int(ref.iteration), float(ref.delta), int(ref.converged))


def test_resident_mesh_planner_on_the_card_equals_the_planner(dev):
    """A MeshPlanner on the resident route ("auto" takes it) and a Planner
    run one session to the same bits; on the mesh only the resident
    entries run."""
    img = maps.recursive_maze(96, 160, seed=3)
    occ = np.where(img == 0, 100, 0).astype(np.int8)
    gy, gx = [int(v) for v in np.argwhere(img == 255)[0]]
    for kernel in ("resident", "auto"):
        mp = MeshPlanner(PlannerConfig(epsilon=1e-2, steps_per_update=25),
                         mesh=make_mesh((2, 4), devices=[dev] * 8), kernel=kernel)
        sp = Planner(PlannerConfig(epsilon=1e-2, steps_per_update=25), device=dev)
        for pl in (mp, sp):
            pl.init(160, 96)
            pl.update_occupancy(occ)
            assert pl.add_goals([(float(gx), float(gy))])
        counts = (dict(hopper_shard2d.launches), dict(hopper_resident2d.launches),
                  dict(hopper_resident2d.calls), dict(core.calls))
        for _ in range(3):
            mp.update()
        mp.set_cells([(10, 10)], [C.CELL_TYPE_OBSTACLE])
        mp.update(13)
        mp.solve(segment_iterations=500)
        torch.cuda.synchronize()
        assert hopper_shard2d.launches == counts[0]
        assert all(hopper_resident2d.launches[n] > counts[1][n] for n in counts[1])
        assert hopper_resident2d.calls == counts[2] and core.calls == counts[3]
        for _ in range(3):
            sp.update()
        sp.set_cells([(10, 10)], [C.CELL_TYPE_OBSTACLE])
        sp.update(13)
        sp.solve()
        a, b = mp.state, sp.state
        assert torch.equal(a.u, b.u) and int(a.iteration) == int(b.iteration)
        assert bool(a.converged) and bool(b.converged)


def test_resident_entries_refuse_what_they_do_not_take(dev):
    deep = hopper_shard2d.max_depth(dev) + 1        # 56 on an H100: within the 75-cell shards
    sh = _resident_grid(dev, halo=deep)
    plan = hopper_resident2d.plans(sh.mesh)[0]
    launches = dict(hopper_resident2d.launches)
    with pytest.raises(ValueError, match="shared memory"):
        hopper_resident2d.cycle(sh, plan, deep, 0, deep, 1)
    with pytest.raises(ValueError, match=f"depth {deep + 1}"):
        hopper_resident2d.cycle(sh, plan, deep + 1, 0, deep + 1, 1)
    with pytest.raises(ValueError, match="chunks of 1..16"):
        hopper_resident2d.cycle(sh, plan, 16, 0, 49, 3)
    twin = sh.twin_blocks[0, 0]
    sh.twin_blocks[0, 0] = sh.u_blocks[0, 0]
    with pytest.raises(ValueError, match="distinct"):
        hopper_resident2d.cycle(sh, plan, 16, 0, 16, 1)
    sh.twin_blocks[0, 0] = twin
    it, done = torch.zeros((), dtype=torch.int32), torch.zeros((), dtype=torch.int32)
    with pytest.raises(ValueError, match="scalars"):
        hopper_resident2d.solve(sh, plan, 16, 100, 1000, it, torch.ones(()), done)
    assert hopper_resident2d.launches == launches


# -- the 3D mesh: epic_shard3d_chunk in csrc/shard3d.cu -------------------------------------

# (centre, halo): one shard's centre (d, h, w) and the halo of each axis (0
# where the mesh does not cut it): a plane-mesh shard (z whole), a z-mesh
# shard (whole planes), a shard of a mixed mesh, and a centre thinner than
# its halo.
SHARDS3D = [((20, 30, 45), (0, 4, 4)), ((9, 40, 70), (3, 0, 0)), ((11, 13, 17), (5, 5, 5)),
            ((2, 3, 5), (6, 6, 6))]


def _shard3d_block(centre, halo, dev, seed):
    """A random extended block (obstacles, goals, a frozen out-of-mesh face,
    frozen faces on the uncut axes) inside a buffer 2 voxels deeper on each
    side: a view with a plane and a row pitch."""
    rng = np.random.default_rng(seed)
    shape = tuple(n + 2 * h + 4 for n, h in zip(centre, halo))
    u = np.where(rng.random(shape) < 0.05, 0.0, -rng.random(shape) * 40).astype(np.float32)
    frozen = rng.random(shape) < 0.15
    view = tuple(slice(2, s - 2) for s in shape)
    block = frozen[view]
    block[:, :halo[1] + 1, :] = True            # a shard on the mesh's y edge
    for axis, h in enumerate(halo):
        if h == 0:                              # the volume's shell
            block[(slice(None),) * axis + (0,)] = True
            block[(slice(None),) * axis + (-1,)] = True
    u[frozen & (rng.random(shape) < 0.5)] = -1e6
    return torch.from_numpy(u).to(dev), torch.from_numpy(frozen).to(dev), view


@pytest.mark.parametrize("shard", SHARDS3D, ids=lambda s: "x".join(map(str, s[0] + s[1])))
def test_shard3d_chunk_kernel_gives_the_plain_versions_bits(dev, shard):
    """K18-K21: odd and even origins and iterations, ns = 1, < k and = k,
    u1 on and off, against the plain per-shard version on the same view."""
    centre, halo = shard
    k = min(h for h in halo if h)
    for seed, par0 in ((0, 0), (1, 1)):
        u, frozen, view = _shard3d_block(centre, halo, dev, seed)
        c = tuple(slice(h, h + n) for n, h in zip(centre, halo))
        for t0 in (0, 3):
            for ns in sorted({1, k // 2 + 1, k}):
                for with_u1 in (False, True):
                    work, u1 = u.clone(), torch.full_like(u, 5.0)
                    before = hopper_shard3d.launches["epic_shard3d_chunk"]
                    calls = hopper_shard3d.calls["sweep_k_local3d"]
                    d = hopper_shard3d.chunk(work[view], frozen[view], halo=halo, par0=par0,
                                             iteration=t0, ns=ns,
                                             u1=u1[view] if with_u1 else None, want_delta=True)
                    torch.cuda.synchronize()
                    assert hopper_shard3d.launches["epic_shard3d_chunk"] == before + 1
                    assert hopper_shard3d.calls["sweep_k_local3d"] == calls
                    ref, ref_d, ref_u1 = hopper_shard3d.sweep_k_local3d(
                        u[view], frozen[view], par0, t0, ns, halo=halo, u1=True)
                    assert torch.equal(work[view], ref) and torch.equal(d, ref_d)
                    outside = torch.ones_like(work, dtype=torch.bool)
                    outside[view] = False
                    assert torch.equal(work[outside], u[outside])   # only the view is written
                    if with_u1:
                        assert torch.equal(u1[view][c], ref_u1[c])
                        inner = torch.zeros_like(outside)
                        inner[view] = True
                        inner[view][c] = False
                        assert (u1[inner | outside] == 5.0).all()   # only the centre
                    else:
                        assert (u1 == 5.0).all()


def test_shard3d_chunk_refuses_what_the_kernel_does_not_take(dev):
    u, frozen, view = _shard3d_block((6, 8, 10), (0, 3, 3), dev, 0)
    kw = dict(halo=(0, 3, 3), par0=0, iteration=0, ns=2)
    launches = dict(hopper_shard3d.launches)
    with pytest.raises(ValueError, match="another buffer"):
        hopper_shard3d.chunk(u[view], frozen[view], u1=u[view], **kw)
    with pytest.raises(TypeError):
        hopper_shard3d.chunk(u[view], frozen[view].to(torch.uint8), **kw)
    with pytest.raises(ValueError, match="pitch"):
        hopper_shard3d.chunk(u[view], frozen[view], u1=u.clone()[view].contiguous(), **kw)
    with pytest.raises(ValueError, match="sweeps"):
        hopper_shard3d.chunk(u[view], frozen[view], halo=(0, 3, 3), par0=0, iteration=0, ns=4)
    with pytest.raises(ValueError, match="no centre"):
        hopper_shard3d.chunk(u[view], frozen[view], halo=(0, 7, 3), par0=0, iteration=0, ns=1)
    assert hopper_shard3d.launches == launches


@pytest.mark.parametrize("row", [1, 2, 31, 33, 64, 65, 80, 130])
def test_shard3d_chunk_rows_give_the_plain_versions_bits(dev, row):
    """K18-K21 on centres whose rows hold ``row`` voxels (a lane a class
    voxel: rows shorter, as long as and longer than a warp's 32 or 64
    positions), with a halo on each combination of the axes, both parity
    origins, u1 on and off: the plain per-shard version's bits."""
    for cut in np.ndindex(2, 2, 2):
        halo = tuple(3 * c for c in cut)
        centre = (5, 6, row if cut[2] else row + 2)
        k = min([h for h in halo if h] or [4])
        u, frozen, view = _shard3d_block(centre, halo, dev, sum(cut) + row)
        c = tuple(slice(h, h + n) for n, h in zip(centre, halo))
        for par0 in (0, 1):
            for with_u1 in (False, True):
                work, u1 = u.clone(), torch.full_like(u, 5.0)
                d = hopper_shard3d.chunk(work[view], frozen[view], halo=halo, par0=par0,
                                         iteration=par0 + 2, ns=k,
                                         u1=u1[view] if with_u1 else None, want_delta=True)
                ref, ref_d, ref_u1 = hopper_shard3d.sweep_k_local3d(
                    u[view], frozen[view], par0, par0 + 2, k, halo=halo, u1=True)
                torch.cuda.synchronize()
                assert torch.equal(work[view], ref) and torch.equal(d, ref_d), (cut, par0)
                if with_u1:
                    assert torch.equal(u1[view][c], ref_u1[c]), (cut, par0)


def _vmesh(shape, dev):
    n = int(np.prod(shape))
    return (make_mesh3d if len(shape) == 3 else make_mesh)(shape, devices=[dev] * n)


def _copy_volume(sv):
    out = copy.copy(sv)
    out.u_blocks = {idx: b.clone() for idx, b in sv.u_blocks.items()}
    if sv.u1_blocks is not None:
        out.u1_blocks = {idx: b.clone() for idx, b in sv.u1_blocks.items()}
    return out


def _same_volumes(a, b):
    for idx in a.u_blocks:
        assert torch.equal(a.u_blocks[idx], b.u_blocks[idx]), idx
        if a.u1_blocks is not None:
            c = a.view(0)
            assert torch.equal(a.u1_blocks[idx][c], b.u1_blocks[idx][c]), idx


@pytest.mark.parametrize("shape", [(2, 4), (8, 1, 1), (2, 2, 2)],
                         ids=lambda s: "x".join(map(str, s)))
def test_resident3d_entries_give_the_plain_versions_bits(dev, shape):
    """epic_resident3d_cycle (1, 2 and 13 sweeps from both parities, u1 on
    and off) and epic_resident3d_solve (converged, capped, and resumed
    across segment bounds) on every shard of a virtual mesh: the plain
    versions' blocks, deltas, iterations and verdicts."""
    from epic_tpu_torch.solver.tiled import segment_bounds

    mesh = _vmesh(shape, dev)
    (plan,) = hopper_resident3d.plans(mesh)
    st = _volume((21, 30, 45), 0.1, 3, dev)
    sv = sharded3d.shard_state3d(st, mesh, halo=2)
    sv.u1_blocks = sharded3d._blank(mesh, sv.block_shape(sv.halo), 5.0, torch.float32)
    for t0 in (0, 1):
        for ns in (1, 2, 13):
            for with_u1 in (False, True):
                k, p = _copy_volume(sv), _copy_volume(sv)
                before = hopper_resident3d.launches["epic_resident3d_cycle"]
                dk = hopper_resident3d.cycle(k, plan, t0, ns, u1=with_u1)
                dp = hopper_resident3d.plain_cycle3d(p, plan, t0, ns, u1=with_u1)
                torch.cuda.synchronize()
                assert hopper_resident3d.launches["epic_resident3d_cycle"] == before + 1
                assert torch.equal(dk, dp)
                _same_volumes(k, p)
    st = dataclasses.replace(_volume((18, 24, 30), 0.1, 5, dev),
                             epsilon=torch.tensor(1e-1, device=dev))
    for stagger, cap, seg in ((100, 1_000_000, None), (7, 1_000_000, 30), (10, 95, None),
                              (1, 1_000_000, None), (10, 1_000_000, 40)):
        runs = {}
        for name, fn in (("kernel", hopper_resident3d.solve),
                         ("plain", hopper_resident3d.plain_solve3d)):
            sv = sharded3d.shard_state3d(st, mesh)
            it = torch.zeros((), dtype=torch.int32, device=dev)
            delta = torch.full((), 2.0, device=dev)
            done = torch.zeros((), dtype=torch.int32, device=dev)
            for bound in ([cap] if seg is None else segment_bounds(stagger, cap, seg)):
                fn(sv, plan, stagger, bound, it, delta, done)
            runs[name] = (sv, int(it), float(delta), int(done))
        (a, *ka), (b, *kb) = runs["kernel"], runs["plain"]
        assert ka == kb, (stagger, cap, seg)
        _same_volumes(a, b)
        ref = core.solve(st, stagger, cap)
        assert torch.equal(sharded3d.unshard3d(a).u, ref.u) and ka[0] == int(ref.iteration)


def test_resident3d_entries_refuse_what_they_do_not_take(dev):
    """A plan with a copied face (a shard of another process), blocks of
    another pitch, ns < 1 and stagger < 1: refused before a launch."""
    st = _volume((10, 16, 24), 0.1, 1, dev)
    mesh = _vmesh((2, 2, 2), dev)
    sv = sharded3d.shard_state3d(st, mesh)
    (plan,) = hopper_resident3d.plans(mesh)
    it, delta, done = (torch.zeros((), dtype=torch.int32, device=dev),
                       torch.ones((), device=dev), torch.zeros((), dtype=torch.int32, device=dev))
    launches = dict(hopper_resident3d.launches)
    devs = np.empty((2, 2, 2), dtype=object)
    devs.fill(dev)
    ranks = np.zeros((2, 2, 2), dtype=int)
    ranks[1] = 1
    (split,) = hopper_resident3d.plans(Mesh(devs, ranks, 0))
    with pytest.raises(ValueError, match="whole plan"):
        hopper_resident3d.cycle(sv, split, 0, 3)
    with pytest.raises(ValueError, match="whole plan"):
        hopper_resident3d.solve(sv, split, 10, 50, it, delta, done)
    with pytest.raises(ValueError, match="at least one sweep"):
        hopper_resident3d.cycle(sv, plan, 0, 0)
    with pytest.raises(ValueError, match="stagger"):
        hopper_resident3d.solve(sv, plan, 0, 50, it, delta, done)
    idx = mesh.local[3]
    wide = torch.zeros(sv.u_blocks[idx].shape[:2] + (sv.u_blocks[idx].shape[2] + 4,),
                       device=dev)[:, :, 2:-2]
    wide.copy_(sv.u_blocks[idx])
    kept, sv.u_blocks[idx] = sv.u_blocks[idx], wide
    with pytest.raises(ValueError, match="pitch"):
        hopper_resident3d.cycle(sv, plan, 0, 3)
    sv.u_blocks[idx] = kept
    with pytest.raises(ValueError, match="0-d"):
        hopper_resident3d.solve(sv, plan, 10, 50, it.long(), delta, done)
    assert hopper_resident3d.launches == launches


@pytest.mark.parametrize("shape,depth", [((2, 4), 8), ((8, 1, 1), 8), ((2, 2, 2), 3),
                                         ((1, 1), 8), ((8, 1), 64)])
def test_virtual_mesh3d_update_and_solve_give_cores_bits(dev, shape, depth):
    """The 3D mesh solver on P shards of the one card: ticks from both
    parities and solves (converged, capped, in segments) equal core's on the
    device route ("auto", "resident") and the per-shard route ("pallas");
    only the CUDA entries run."""
    mesh = _vmesh(shape, dev)
    kernels = ("auto", "pallas") if shape == (2, 2, 2) else ("auto", "resident", "pallas")
    before = (dict(hopper_shard3d.launches), dict(hopper_resident3d.launches))
    calls = (dict(hopper_shard3d.calls), dict(hopper_resident3d.calls))
    for t0 in (0, 1):
        st = _volume((41, 37, 53), 0.1, 3, dev, t0=t0)
        for steps in (1, 50):
            ref = core.update_n(st, steps)
            for kernel in kernels:
                _assert_same(sharded3d.update_n(st, steps, mesh, chunk_depth=depth, kernel=kernel),
                             ref)
    st = _volume((24, 30, 36), 0.1, 5, dev)
    st = dataclasses.replace(st, epsilon=torch.tensor(1e-1, device=dev))
    for stagger, cap, seg in ((100, 1_000_000, None), (7, 1_000_000, 30), (10, 95, None)):
        ref = core.solve(st, stagger, cap)
        for kernel in kernels:
            _assert_same(sharded3d.solve(st, mesh, stagger, cap, kernel=kernel,
                                         segment_iterations=seg), ref)
    assert hopper_shard3d.launches["epic_shard3d_chunk"] > before[0]["epic_shard3d_chunk"]
    for name, n in hopper_resident3d.launches.items():
        assert n > before[1][name], name
    assert (dict(hopper_shard3d.calls), dict(hopper_resident3d.calls)) == calls
    for kernel in ("xla", "pallas_interpret", "resident_interpret"):   # the plain version's names
        with pytest.raises(ValueError, match="plain version"):
            sharded3d.update_n(st, 3, mesh, kernel=kernel)


def test_mesh_volume_planner_on_the_card_equals_the_volume_planner(dev):
    """A MeshVolumePlanner on a 2 x 4 virtual mesh (the device route) and a
    VolumePlanner on the card run one session to the same bits; the mesh
    never runs a plain version or a single-device kernel. mesh=None picks a
    mesh over the card."""
    shape = (20, 48, 40)
    occ = np.where(np.random.default_rng(2).random(shape) < 0.1, 100, 0).astype(np.int8)
    occ[10, 24, 20] = 0
    cfg = dict(epsilon=1e-2, steps_per_update=25)
    mp = MeshVolumePlanner(VolumePlannerConfig(**cfg), mesh=make_mesh((2, 4), devices=[dev] * 8))
    sp = VolumePlanner(VolumePlannerConfig(**cfg), device=dev)
    for pl in (mp, sp):
        pl.init(40, 48, 20)
        pl.update_occupancy(occ)
        assert pl.add_goals([(20.0, 24.0, 10.0)])
    for pl in (mp, sp):
        others = (dict(hopper_shard3d.calls), dict(hopper_resident3d.calls), dict(core.calls),
                  dict(hopper_sweep3d.launches), dict(hopper_tile3d.launches),
                  dict(hopper_shard3d.launches))
        launches = dict(hopper_resident3d.launches)
        for _ in range(3):
            pl.update()
        pl.set_cells([(10, 10, 5)], [C.CELL_TYPE_OBSTACLE])
        pl.update(13)
        pl.solve()
        if pl is mp:
            assert all(hopper_resident3d.launches[n] > launches[n] for n in launches)
            assert (dict(hopper_shard3d.calls), dict(hopper_resident3d.calls), dict(core.calls),
                    dict(hopper_sweep3d.launches), dict(hopper_tile3d.launches),
                    dict(hopper_shard3d.launches)) == others
    assert mp.get_cell(10, 10, 5) == sp.get_cell(10, 10, 5) == -1e6
    a, b = mp.state, sp.state
    assert a.u.device == dev and torch.equal(a.u, b.u)
    assert int(a.iteration) == int(b.iteration) and bool(a.converged) and bool(b.converged)
    auto = MeshVolumePlanner(VolumePlannerConfig(**cfg))
    auto.init(40, 48, 20)
    assert auto.device == dev and auto.mesh.devices.size == torch.cuda.device_count()


def _counts():
    return (dict(hopper_sweep.launches), dict(hopper_tile2d.launches),
            dict(hopper_sweep3d.launches), dict(core.calls))


def _ran(before, after):
    """The counts that moved between two ``_counts()``."""
    return {k: after[i][k] - before[i][k] for i in range(4) for k in after[i]
            if after[i][k] != before[i][k]}


@pytest.mark.parametrize("side,entry", [(128, "epic_sweep2d_solve"),
                                        (3072, "epic_tile2d_solve")])
def test_planner_cascade_runs_the_kernels(dev, side, entry):
    """Planner(cascade=True) on the card: the coarse levels on the native
    library, the fine level (capped) on K2 within the L2 and on the tile
    solve past two thirds of it; the same bits as the same cascade with the
    plain core.solve on the card as its final solver."""
    assert native.available(), native.build_info
    img = maps.random_obstacles(side, side, density=0.1, seed=0)
    cap = 1_000_000 if side == 128 else 3000
    tp = Planner(PlannerConfig(epsilon=1e-3, cascade=True), device=dev)
    tp.state = TG.from_occupancy_image(img, 1e-3, device=dev)
    before = _counts()
    tp.solve(max_iterations=cap)
    torch.cuda.synchronize()
    assert _ran(before, _counts()) == {entry: 1}
    plain, stats = cascade.solve_cascade(
        TG.from_occupancy_image(img, 1e-3, device=dev), coarse_solver=cascade.native_solver,
        solver=lambda st, stagger, max_iterations: core.solve(st, stagger, min(max_iterations,
                                                                               cap)))
    _assert_same(tp.state, plain)
    assert int(tp.state.iteration) == stats.iterations[-1] and len(stats.iterations) > 1


def test_cascade_levels_on_the_card(dev):
    """solve_cascade with the auto solver, every level on the card: K2 on each
    level of a 2D pyramid, K7 on each level of a 3D one; the plain cascade's
    bits on the card."""
    img = maps.recursive_maze(192, 160, seed=4)
    before = _counts()
    k, ks = cascade.solve_cascade(TG.from_occupancy_image(img, 1e-3, device=dev))
    torch.cuda.synchronize()
    assert _ran(before, _counts()) == {"epic_sweep2d_solve": len(ks.iterations)}
    p, ps = cascade.solve_cascade(TG.from_occupancy_image(img, 1e-3, device=dev),
                                  solver=core.solve)
    _assert_same(k, p)
    assert ks == ps
    vol = np.full((24, 48, 40), 128, np.uint8)
    vol[12, 24, 20] = 255
    before = _counts()
    k, ks = cascade.solve_cascade(TG.from_occupancy_volume(vol, 1e-2, device=dev), levels=1,
                                  min_extent=12)
    torch.cuda.synchronize()
    assert _ran(before, _counts()) == {"epic_sweep3d_solve": 2}
    p, ps = cascade.solve_cascade(TG.from_occupancy_volume(vol, 1e-2, device=dev), levels=1,
                                  min_extent=12, solver=core.solve)
    _assert_same(k, p)
    assert ks == ps and ks.shapes == ((12, 24, 20), (24, 48, 40))


def test_nav_core_on_the_card(dev):
    """EpicNavCorePlugin on the card: each make_plan solves on K2 (no plain
    version), and the plans equal a plugin whose solve is the plain
    core.solve on the card."""
    img = maps.recursive_maze(96, 96, seed=7)
    costmap = np.where(img == 0, 254, 0).astype(np.uint8)
    ours = EpicNavCorePlugin(device=dev)
    plain = EpicNavCorePlugin(device=dev, solve_fn=core.solve)
    free = np.argwhere(img == 128)
    requests = [(tuple(map(float, free[-3][::-1])), tuple(map(float, free[5][::-1]))),
                (tuple(map(float, free[17][::-1])), tuple(map(float, free[len(free) // 2][::-1])))]
    for pl in (ours, plain):
        pl.initialize(costmap)
    for start, goal in requests:
        before = _counts()
        a = ours.make_plan(start, goal)
        torch.cuda.synchronize()
        assert _ran(before, _counts()) == {"epic_sweep2d_solve": 1}
        b = plain.make_plan(start, goal)
        assert torch.equal(ours.state.u, plain.state.u)
        assert (a is None) == (b is None)
        if a is not None:
            assert a == b
    assert a is not None


def test_rank4_on_the_card_runs_the_plain_core(dev):
    """A 4D grid on the card: solver.solve_grid/update_grid run the plain core
    on the CUDA tensor and launch no kernel; the result is the CPU plain
    version's within tests/test_torch_solver.py's FIELD tolerance (the card's
    and the host's exp differ by an ulp), with equal iterations."""
    shape, goal = (16, 16, 16, 16), (5, 9, 7, 11)

    def state(device):
        st = TG.empty_grid_nd(shape, 1e-3, device=device)
        u = torch.where(st.locked, st.u, torch.full_like(st.u, -1e6))
        u[goal] = 0.0
        locked = st.locked.clone()
        locked[goal] = True
        return TG.make_state(u, locked, 1e-3, device=device)

    before = _counts()
    k = TS.solve_grid(state(dev))
    t = TS.update_grid(state(dev), 3)
    torch.cuda.synchronize()
    assert _ran(before, _counts()) == {"solve": 1, "update_n": 1}
    c = core.solve(state("cpu"))
    assert int(k.iteration) == int(c.iteration) and bool(k.converged)
    np.testing.assert_allclose(k.u.cpu().numpy(), c.u.numpy(), rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(t.u.cpu().numpy(), core.update_n(state("cpu"), 3).u.numpy(),
                               rtol=2e-6, atol=1e-3)


def test_battery_kernel_row_matches_the_native_row(dev, monkeypatch):
    """tools.batch_bench on the card on a 96^2 maze at eps 1e-3: with
    --backend pallas the kernel row log_hopper_cuda (K2: a warm-up and a
    timed run, nothing else on the card) gives log_native_cpu's iterations
    and percent-valid; with "auto" the plain row log_torch_cuda gives the
    same."""
    from epic_tpu_torch.config import EpicConfig, SolverConfig
    from epic_tpu_torch.tools import batch_bench

    img = maps.recursive_maze(96, 96, seed=4)
    monkeypatch.setitem(batch_bench.DOMAINS, "small", img.shape)
    monkeypatch.setattr(batch_bench, "load_domain", lambda name: img)
    cfg = EpicConfig(solver=SolverConfig(epsilon=1e-3))
    before = _counts()
    rows = {r[1]: r for r in batch_bench.run("small", cfg, None, backend="pallas", device=dev)}
    torch.cuda.synchronize()
    assert _ran(before, _counts()) == {"epic_sweep2d_solve": 2}
    assert set(rows) == {"cpu_sor_f32", "cpu_sor_f64", "log_native_cpu", "log_hopper_cuda"}
    assert rows["log_hopper_cuda"][6] == rows["log_native_cpu"][6]
    assert rows["log_hopper_cuda"][3] == rows["log_native_cpu"][3]
    auto = {r[1]: r for r in batch_bench.run("small", cfg, None, device=dev)}
    assert set(auto) == set(rows) | {"log_torch_cuda"}
    assert auto["log_torch_cuda"][6] == auto["log_hopper_cuda"][6] == rows["log_hopper_cuda"][6]
    assert auto["log_torch_cuda"][3] == rows["log_hopper_cuda"][3]


@pytest.mark.parametrize("kernel", ["auto", "pallas", "resident"])
def test_scaling_bench_on_the_card_gives_cores_bits(dev, kernel):
    """tools.scaling_bench on virtual meshes of 1, 2, 4 and 8 shards of the
    card: every row's field is core.update_n's on the whole grid, bit for
    bit, and the caveat names the shared card."""
    from epic_tpu_torch.tools import scaling_bench

    fields = {}
    rows = scaling_bench.run([256], 20, [1, 2, 4, 8], kernel, 16, dev, fields=fields)
    img = maps.random_obstacles(256, 256, density=0.1, seed=0)
    ref = core.update_n(TG.from_occupancy_image(img, 1e-6, device=dev), 20)
    for r in rows:
        assert torch.equal(fields[(256, r["devices"])].u, ref.u), r
        assert r["caveat"] == "virtual-mesh-shards-share-one-card" and r["backend"] == "cuda"


def test_loadtest_on_the_card(dev):
    """tools.server_loadtest with its in-process server on the card: no
    protocol error, every verb sampled, the ticks on K1."""
    from epic_tpu_torch.tools import server_loadtest

    before = _counts()
    rep = server_loadtest.main(["--clients", "2", "--rounds", "5", "--size", "64"])
    torch.cuda.synchronize()
    ran = _ran(before, _counts())
    assert ran.get("epic_sweep2d_chunk", 0) > 0 and set(ran) == {"epic_sweep2d_chunk"}
    assert rep["detail"]["protocol_errors"] == 0 and rep["detail"]["backend"] == "cuda"
    assert set(rep["detail"]["verbs"]) == {"compute_path", "get_cell", "set_cells"}
