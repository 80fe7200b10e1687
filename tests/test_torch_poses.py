"""The Planner's world poses as arrays (``planner.PathPoses``).

``Planner._poses`` computes x, y and yaw over whole arrays; these tests hold
it to the per-point loop it replaced (kept below as ``_loop``) bit for bit,
on the walker's paths over the golden maze and umass fields, on random
float32 points and on repeated points, and check the sequence that carries
the poses to callers, its counter, and that a path leaves no Python object
per pose alive.
"""

from __future__ import annotations

import gc
import math
import pathlib

import numpy as np
import pytest

from epic_tpu_torch import grid as G
from epic_tpu_torch import path, planner
from epic_tpu_torch.errors import EpicError
from epic_tpu_torch.planner import PathPose, PathPoses, Planner, PlannerConfig

GOLDENS = pathlib.Path(__file__).parent / "goldens"

# The demos' resolutions; origins off zero so that the addition shows.
FRAMES = {"maze": (0.1, -12.3, 4.5), "umass": (0.03048, 3.25, -0.7)}


def _loop(p: Planner, pts: np.ndarray) -> list[tuple[float, float, float]]:
    """The pose loop ``Planner._poses`` ran before it worked on arrays."""
    poses = []
    sx, sy = p.map_to_world(float(pts[0, 0]), float(pts[0, 1]))
    poses.append((sx, sy, 0.0))
    for i in range(1, len(pts)):
        x, y = float(pts[i, 0]), float(pts[i, 1])
        yaw = math.atan2(y - float(pts[i - 1, 1]), x - float(pts[i - 1, 0]))
        wx, wy = p.map_to_world(x, y)
        poses.append((wx, wy, yaw))
    return poses


def _assert_bits(ours: PathPoses, ref: list[tuple[float, float, float]]) -> None:
    """The arrays and the boxed poses both hold the loop's bits."""
    assert len(ours) == len(ref)
    want = np.array(ref, dtype=np.float64)
    got = np.stack([ours.x, ours.y, ours.yaw], axis=1)
    assert np.array_equal(got.view(np.uint64), want.view(np.uint64))
    boxed = list(ours)
    assert boxed == ref
    assert all(type(v) is float for pose in boxed[:50] for v in pose)


def _planner(name: str, interpolation: str = "reference") -> tuple:
    """A CPU Planner on a golden's converged field, in the demo's frame."""
    g = np.load(GOLDENS / f"{name}.npz")
    locked = (g["img"] == 0) | (g["img"] == 255)
    res, ox, oy = FRAMES[name]
    p = Planner(PlannerConfig(resolution=res, origin_x=ox, origin_y=oy,
                              interpolation=interpolation), device="cpu")
    p.state = G.make_state(g["ref_u"], locked, 1e-3, device="cpu")
    return p, g


def _walks(name: str):
    """The walker's paths from a golden's starts that give one."""
    p, g = _planner(name)
    out = []
    for x, y in g["starts"]:
        try:
            out.append(path.compute_path(G.host_u(p.state), G.host_locked(p.state),
                                         float(x), float(y), 0.2, 0.4, int(1e6)))
        except EpicError:  # a start the reference binary also fails from
            continue
    assert len(out) >= 2
    return p, out


def _random_points(kind: str) -> np.ndarray:
    rng = np.random.default_rng(11)
    if kind == "random":
        return (rng.standard_normal((5000, 2)) * 300).astype(np.float32)
    # Runs of one point (dx = dy = 0), as a walker that stalls makes them.
    base = (rng.random((400, 2)) * 480).astype(np.float32)
    return np.repeat(base, rng.integers(1, 6, size=len(base)), axis=0)


@pytest.mark.parametrize("name", ["maze", "umass"])
def test_poses_of_golden_walks_equal_the_loop(name):
    p, walks = _walks(name)
    for pts in walks:
        _assert_bits(p._poses(pts), _loop(p, pts))


@pytest.mark.parametrize("kind", ["random", "repeated"])
@pytest.mark.parametrize("frame", ["maze", "umass"])
def test_poses_of_points_equal_the_loop(kind, frame):
    res, ox, oy = FRAMES[frame]
    p = Planner(PlannerConfig(resolution=res, origin_x=ox, origin_y=oy), device="cpu")
    pts = _random_points(kind)
    if kind == "repeated":
        assert np.any(np.all(pts[1:] == pts[:-1], axis=1))
    _assert_bits(p._poses(pts), _loop(p, pts))


@pytest.mark.parametrize("name,mode", [("maze", "reference"), ("umass", "reference"),
                                       ("maze", "bilinear")])
def test_compute_path_equals_the_loop(name, mode):
    """The verb end to end: the walk from the start's map point, then the
    poses, equal the loop over the same walk."""
    p, g = _planner(name, mode)
    h, w = p.state.u.shape
    done = 0
    for x, y in g["starts"]:
        start = p.map_to_world(float(x), float(y))
        mx, my = p.world_to_map(*start)
        try:
            pts = path.compute_path(G.host_u(p.state), G.host_locked(p.state), mx, my, 0.2, 0.4,
                                    int(w * h / 0.2), mode)
        except EpicError:
            continue
        ours = p.compute_path(start, step_size=0.2, cd_precision=0.4)
        assert isinstance(ours, PathPoses)
        _assert_bits(ours, _loop(p, pts))
        done += 1
    assert done >= 2


def test_path_pose_is_a_named_tuple():
    pose = PathPose(x=1.5, y=-2.0, yaw=0.25)
    assert pose == (1.5, -2.0, 0.25) and pose == PathPose(1.5, -2.0, 0.25)
    assert (pose.x, pose.y, pose.yaw) == (1.5, -2.0, 0.25)
    assert hash(pose) == hash((1.5, -2.0, 0.25))
    with pytest.raises(AttributeError):
        pose.x = 0.0


@pytest.fixture(scope="module")
def maze_poses():
    p, walks = _walks("maze")
    pts = max(walks, key=len)
    return p._poses(pts), _loop(p, pts)


@pytest.mark.parametrize("index", [0, 1, 7, -1, -2])
def test_index_gives_the_pose(maze_poses, index):
    ours, ref = maze_poses
    pose = ours[index]
    assert type(pose) is PathPose and pose == ref[index]
    assert all(type(v) is float for v in pose)


@pytest.mark.parametrize("cut", [slice(None), slice(3, 40), slice(-25, None), slice(None, None, 7),
                                 slice(None, None, -1), slice(5, 5)])
def test_slice_gives_path_poses(maze_poses, cut):
    ours, ref = maze_poses
    part = ours[cut]
    assert isinstance(part, PathPoses)
    assert list(part) == ref[cut] and len(part) == len(ref[cut]) and bool(part) == bool(ref[cut])


def test_sequence_protocol(maze_poses):
    ours, ref = maze_poses
    assert len(ours) == len(ref) > 100 and bool(ours)
    assert list(ours) == ref and list(iter(ours)) == ref
    assert [tuple(q) for q in ours] == ref
    assert list(reversed(ours)) == ref[::-1]
    assert ours[-1] == ref[-1] and ref[3] in ours[:10]
    empty = ours[:0]
    assert len(empty) == 0 and not empty and list(empty) == []
    with pytest.raises(IndexError):
        ours[len(ref)]


@pytest.mark.parametrize("field", ["x", "y", "yaw"])
def test_arrays_are_read_only(maze_poses, field):
    ours, _ = maze_poses
    a = getattr(ours, field)
    assert a.dtype == np.float64 and a.shape == (len(ours),)
    with pytest.raises(ValueError):
        a[0] = 1.0
    with pytest.raises(ValueError):
        ours[2:9].x[0] = 1.0
    with pytest.raises(AttributeError):
        setattr(ours, field, a)


@pytest.mark.parametrize("mode", ["reference", "bilinear"])
def test_compute_paths_batch_lanes_equal_the_loop(mode):
    """Every lane of the batched walker: its points through the loop."""
    from epic_tpu_torch import maps

    img = maps.random_obstacles(32, 48, density=0.15, seed=5)
    p = Planner(PlannerConfig(epsilon=1e-2, resolution=0.25, origin_x=-1.0, origin_y=2.0,
                              interpolation=mode), device="cpu")
    p.update_occupancy(np.where(img == 0, 100, 0).astype(np.int8))
    p.add_goals([p.map_to_world(24.0, 16.0)])
    p.solve()
    seen, poses_of = [], p._poses

    def recorded(pts):
        seen.append(np.array(pts))
        return poses_of(pts)

    p._poses = recorded
    starts = [p.map_to_world(*xy) for xy in [(5.0, 5.0), (40.0, 25.0), (30.0, 5.0)]]
    out = p.compute_paths_batch(starts + [(-50.0, 0.0)], step_size=0.2, cd_precision=0.4,
                                max_steps=800)
    assert out[-1] is None and [q is None for q in out[:3]] == [False] * 3
    assert len(seen) == 3
    for lane, pts in zip(out[:3], seen):
        assert isinstance(lane, PathPoses)
        _assert_bits(lane, _loop(p, pts))


def test_poses_counter(maze_poses):
    ours, _ = maze_poses
    p = Planner(PlannerConfig(), device="cpu")
    pts = _random_points("random")[:300]
    before = dict(planner.poses)
    made = p._poses(pts)
    assert planner.poses == {"built": before["built"] + 300, "boxed": before["boxed"]}
    _ = made[5], made[-1], made[2:30]
    assert planner.poses["boxed"] == before["boxed"] + 2
    list(made)
    assert planner.poses == {"built": before["built"] + 300, "boxed": before["boxed"] + 302}
    assert planner.poses["built"] >= len(ours)


def test_compute_path_leaves_no_object_per_pose():
    """A long path's poses are three arrays: the objects the collector
    tracks grow by a handful across the call, not by one a pose."""
    p, g = _planner("maze")
    start = p.map_to_world(*map(float, g["starts"][int(np.argmax(g["path_lens"]))]))
    p.compute_path(start, step_size=0.05)   # builds and caches what a first call does
    gc.collect()
    before = len(gc.get_objects())
    poses = p.compute_path(start, step_size=0.05)
    grown = len(gc.get_objects()) - before
    assert len(poses) > 10_000
    assert grown < 50, grown
