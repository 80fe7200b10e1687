"""The seeded inputs: a run's requests repeat for its seed and stay in the
map's largest free component away from the walls, and the compared sample
repeats for its seed and is uniform over the window's requests."""

from __future__ import annotations

import json

import numpy as np
import pytest
from scipy import ndimage

from benchmark import inputs
from benchmark.tests.epicbench_util import REPO


@pytest.fixture(scope="module", params=["maze_demo", "umass_demo"])
def demo(request):
    cfg = json.loads((REPO / "benchmark/configs" / f"{request.param}.json").read_text())
    return cfg, inputs.load_map(cfg, REPO)


def test_stream_repeats_for_its_seed(demo):
    _, m = demo
    a = inputs.Stream(m, 20261018).take(0, 64)
    b = inputs.Stream(m, 20261018)
    b = [np.concatenate(x) for x in zip(b.take(0, 40), b.take(40, 24))]
    c = inputs.Stream(m, 20261019).take(0, 64)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert not np.array_equal(a[0], c[0])


def test_stream_reads_past_its_first_block(demo):
    _, m = demo
    s = inputs.Stream(m, 2**33 + 1)
    late = s.take(inputs.Stream.BLOCK * 2 + 5, 3)
    again = inputs.Stream(m, 2**33 + 1).take(0, inputs.Stream.BLOCK * 3)
    k = inputs.Stream.BLOCK * 2 + 5
    assert all(np.array_equal(x, y[k:k + 3]) for x, y in zip(late, again))


def test_stream_stays_in_the_free_component_away_from_walls(demo):
    cfg, m = demo
    goals, starts = inputs.Stream(m, 3).take(0, 512)
    free = ~m.obstacle
    free[0, :] = free[-1, :] = free[:, 0] = free[:, -1] = False
    labels, _ = ndimage.label(free)
    big = np.bincount(labels.ravel())[1:].argmax() + 1
    dist = ndimage.distance_transform_edt(free)
    for xy in (goals, starts):
        assert (labels[xy[:, 1], xy[:, 0]] == big).all()
        assert (dist[xy[:, 1], xy[:, 0]] * cfg["resolution_m"] >= cfg["clearance_m"]).all()
    assert not (goals == starts).all(axis=1).any()
    # Requests do not repeat a small pool: nearly every goal is new.
    assert len({tuple(g) for g in goals}) > 500


def kept(size: int, n: int, seed: int) -> list[int]:
    r, slots = inputs.Reservoir(size, seed), [None] * size
    for k in range(n):
        slot = r.offer()
        if slot is not None:
            slots[slot] = k
    return sorted(k for k in slots if k is not None)


def test_seeds_and_samples_repeat():
    for seed in (0, 2**31 + 5, -17, 12345678901234567890):
        a, b = inputs.rng(seed), inputs.rng(seed)
        assert np.array_equal(a.permutation(16), b.permutation(16))
    s1 = kept(12, 512, 2147480001)
    assert s1 == kept(12, 512, 2147480001)
    assert len(set(s1)) == 12 and all(0 <= i < 512 for i in s1)
    assert s1 != kept(12, 512, 2147480002)
    assert kept(12, 4, 5) == [0, 1, 2, 3]


def test_reservoir_sample_is_uniform():
    """Every completed request is kept with the same chance, size / n."""
    n, size, runs = 40, 6, 3000
    counts = np.zeros(n)
    for seed in range(runs):
        counts[kept(size, n, seed)] += 1
    share = counts / runs
    assert np.abs(share - size / n).max() < 0.035
    assert share[:10].mean() == pytest.approx(share[-10:].mean(), abs=0.03)


def test_map_checksum_is_checked(tmp_path, demo):
    cfg, _ = demo
    bad = dict(cfg, map=dict(cfg["map"], sha256="0" * 64))
    with pytest.raises(ValueError):
        inputs.load_map(bad, REPO)
