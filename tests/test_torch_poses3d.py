"""The VolumePlanner's world poses as arrays (``planner3d.PathPoses3D``).

``VolumePlanner._poses`` computes x, y, z, yaw and pitch over whole arrays;
these tests hold it to the per-point loop it replaced (kept below as
``_loop``) bit for bit, on walks over a solved volume, on random float32
points and on repeated points, and check the sequence that carries the poses
to callers and its counter. This file imports neither JAX nor epic_tpu."""

from __future__ import annotations

import dataclasses
import gc
import math

import numpy as np
import pytest
import torch

from epic_tpu_torch import grid as G
from epic_tpu_torch import path3d, planner3d
from epic_tpu_torch.errors import EpicError
from epic_tpu_torch.planner3d import (PathPose3D, PathPoses3D, VolumePlanner,
                                      VolumePlannerConfig)

# Resolutions and origins off zero, so that the addition shows.
FRAMES = [(0.03048, 3.25, -0.7, 1.5), (0.5, -12.3, 4.5, -2.0)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loop(p: VolumePlanner, pts: np.ndarray) -> list[tuple]:
    """The pose loop ``VolumePlanner._poses`` ran before it worked on arrays."""
    poses = [(*p.map_to_world(*map(float, pts[0])), 0.0, 0.0)]
    for i in range(1, len(pts)):
        x, y, z = map(float, pts[i])
        dx = x - float(pts[i - 1, 0])
        dy = y - float(pts[i - 1, 1])
        dz = z - float(pts[i - 1, 2])
        yaw = math.atan2(dy, dx)
        pitch = math.atan2(dz, math.hypot(dx, dy))
        poses.append((*p.map_to_world(x, y, z), yaw, pitch))
    return poses


def _assert_bits(ours: PathPoses3D, ref: list[tuple]) -> None:
    assert len(ours) == len(ref)
    want = np.array(ref, dtype=np.float64)
    got = np.stack([ours.x, ours.y, ours.z, ours.yaw, ours.pitch], axis=1)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    boxed = list(ours)
    assert [dataclasses.astuple(q) for q in boxed] == ref
    assert all(type(q) is PathPose3D for q in boxed[:20])


def _planner(frame) -> VolumePlanner:
    res, ox, oy, oz = frame
    return VolumePlanner(VolumePlannerConfig(epsilon=1e-2, resolution=res, origin_x=ox,
                                             origin_y=oy, origin_z=oz), device="cpu")


@pytest.fixture(scope="module")
def solved():
    """A solved 12 x 16 x 20 volume with a few obstacles, its goal mid-volume."""
    p = _planner(FRAMES[0])
    p.init(20, 16, 12)
    p.set_cells([(5, 5, 5), (5, 6, 5), (14, 12, 9), (9, 9, 3)], [1] * 4)
    p.set_cells([(12, 10, 6)], [0])
    p.solve()
    return p


def _walks(p: VolumePlanner, n: int = 6):
    u, locked = G.host_u(p.state), G.host_locked(p.state)
    zs, ys, xs = np.nonzero(~locked)
    rng = np.random.default_rng(4)
    out = []
    for i in rng.choice(len(zs), 30, replace=False):
        try:
            out.append(path3d.compute_path(u, locked, float(xs[i]) + 0.3, float(ys[i]),
                                           float(zs[i]) - 0.2, 0.05, 0.5, 100_000))
        except EpicError:
            continue
        if len(out) == n:
            break
    assert len(out) >= 3
    return out


def _random_points(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "random":
        return (rng.standard_normal((4000, 3)) * 300).astype(np.float32)
    # Runs of one point (a zero step), and steps straight up or down (a
    # zero horizontal part), as a stalled or vertical walk makes them.
    base = (rng.random((300, 3)) * 480).astype(np.float32)
    pts = np.repeat(base, rng.integers(1, 5, size=len(base)), axis=0)
    pts[1::7, :2] = pts[:-1:7, :2]
    return pts


def test_poses_of_walks_equal_the_loop(solved):
    for pts in _walks(solved):
        _assert_bits(solved._poses(pts), _loop(solved, pts))


@pytest.mark.parametrize("kind", ["random", "repeated"])
@pytest.mark.parametrize("frame", FRAMES)
def test_poses_of_points_equal_the_loop(kind, frame):
    p = _planner(frame)
    pts = _random_points(kind)
    _assert_bits(p._poses(pts), _loop(p, pts))


def test_compute_path_equals_the_loop(solved):
    """The verb end to end: the walk from the start's map point, then the
    poses, equal the loop over the same walk."""
    u, locked = G.host_u(solved.state), G.host_locked(solved.state)
    d, h, w = u.shape
    done = 0
    for start in [(4.0, 4.0, 4.0), (17.0, 13.0, 9.0), (3.0, 12.0, 2.0)]:
        world = solved.map_to_world(*start)
        m = solved.world_to_map(*world)
        pts = path3d.compute_path(u, locked, *m, 0.05, 0.5, int(w * h * d / 0.05))
        ours = solved.compute_path(world)
        assert isinstance(ours, PathPoses3D)
        _assert_bits(ours, _loop(solved, pts))
        done += 1
    assert done == 3


def test_compute_paths_batch_lanes_are_pose_arrays(solved):
    out = solved.compute_paths_batch([solved.map_to_world(4.0, 4.0, 4.0), (-50.0, 0.0, 0.0)],
                                     step_size=0.2, cd_precision=0.4, max_steps=800)
    assert isinstance(out[0], PathPoses3D) and out[1] is None
    assert len(out[0]) > 2


@pytest.fixture(scope="module")
def long_poses(solved):
    pts = max(_walks(solved), key=len)
    return solved._poses(pts), _loop(solved, pts)


@pytest.mark.parametrize("index", [0, 1, 7, -1, -2])
def test_index_gives_the_pose(long_poses, index):
    ours, ref = long_poses
    pose = ours[index]
    assert type(pose) is PathPose3D and dataclasses.astuple(pose) == ref[index]
    assert all(type(v) is float for v in dataclasses.astuple(pose))


@pytest.mark.parametrize("cut", [slice(None), slice(3, 40), slice(-25, None),
                                 slice(None, None, 7), slice(None, None, -1), slice(5, 5)])
def test_slice_gives_path_poses(long_poses, cut):
    ours, ref = long_poses
    part = ours[cut]
    assert isinstance(part, PathPoses3D)
    assert [dataclasses.astuple(q) for q in part] == ref[cut]
    assert len(part) == len(ref[cut]) and bool(part) == bool(ref[cut])


def test_sequence_protocol(long_poses):
    ours, ref = long_poses
    assert len(ours) == len(ref) > 20 and bool(ours)
    assert [dataclasses.astuple(q) for q in reversed(ours)] == ref[::-1]
    assert ours[-1] == PathPose3D(*ref[-1]) and PathPose3D(*ref[3]) in ours[:10]
    with pytest.raises(IndexError):
        ours[len(ref)]
    empty = ours[:0]
    assert len(empty) == 0 and not empty and list(empty) == []


@pytest.mark.parametrize("field", ["x", "y", "z", "yaw", "pitch"])
def test_arrays_are_read_only(long_poses, field):
    ours, _ = long_poses
    a = getattr(ours, field)
    assert a.dtype == np.float64 and a.shape == (len(ours),)
    with pytest.raises(ValueError):
        a[0] = 1.0
    with pytest.raises(AttributeError):
        setattr(ours, field, a)


def test_poses_counter():
    p = _planner(FRAMES[1])
    pts = _random_points("random")[:300]
    before = dict(planner3d.poses)
    made = p._poses(pts)
    assert planner3d.poses == {"built": before["built"] + 300, "boxed": before["boxed"]}
    _ = made[5], made[-1], made[2:30]
    assert planner3d.poses["boxed"] == before["boxed"] + 2
    list(made)
    assert planner3d.poses == {"built": before["built"] + 300, "boxed": before["boxed"] + 302}


def test_compute_path_leaves_no_object_per_pose(solved):
    """A long path's poses are five arrays: the objects the collector tracks
    grow by a handful across the call, not by one a pose."""
    world = solved.map_to_world(17.0, 13.0, 9.0)
    solved.compute_path(world, step_size=0.01)   # builds and caches what a first call does
    gc.collect()
    before = len(gc.get_objects())
    poses = solved.compute_path(world, step_size=0.01)
    grown = len(gc.get_objects()) - before
    assert len(poses) > 500
    assert grown < 50, grown
