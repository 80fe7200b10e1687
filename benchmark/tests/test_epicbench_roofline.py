"""The roofline's operation and byte counts on grids counted by hand."""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import roofline


def test_class_counts_by_hand():
    # A 5 x 5 grid: the interior is 3 x 3 at rows and columns 1..3; (y + x)
    # even at (1,1), (1,3), (2,2), (3,1), (3,3), odd at the other four.
    locked = np.zeros((5, 5), dtype=bool)
    assert roofline.class_counts(locked) == (5, 4)
    locked[2, 2] = True     # even
    locked[1, 2] = True     # odd
    assert roofline.class_counts(locked) == (4, 3)
    locked[0, :] = True     # the ring is never counted
    assert roofline.class_counts(locked) == (4, 3)


def test_updates_alternate_classes():
    counts = (5, 4)         # even, odd
    # Sweep 0 relaxes the odd class, sweep 1 the even, and so on.
    assert roofline.updates(counts, 1) == 4
    assert roofline.updates(counts, 2) == 4 + 5
    assert roofline.updates(counts, 3) == 4 + 5 + 4
    assert roofline.updates(counts, 101) == 51 * 4 + 50 * 5
    assert roofline.updates(counts, 2, t0=1) == 5 + 4


def test_least_time_is_the_larger_bound():
    # 1e6 updates: 17e6 operations at 67e12 /s = 0.2537 us; 100 cells at 9 B
    # = 900 B at 3.35e12 B/s = 0.2687 ns: operations bound.
    assert roofline.least_seconds(10**6, 100) == pytest.approx(17e6 / 67e12)
    # No updates: 1e6 cells at 9 B bound it.
    assert roofline.least_seconds(0, 10**6) == pytest.approx(9e6 / 3.35e12)


def test_maze_golden_solve_bound():
    # The maze demo's golden solve, 49,301 sweeps on its own goal: PERF.md's
    # K2 row gives 1.261 ms for it, from chip_smoke.py's arithmetic.
    with np.load("tests/goldens/maze.npz") as g:
        img = g["img"]
    locked = (img == 0) | (img == 255)
    locked[0, :] = locked[-1, :] = locked[:, 0] = locked[:, -1] = True
    n = roofline.updates(roofline.class_counts(locked), 49_301)
    assert roofline.least_seconds(n, img.size) * 1e3 == pytest.approx(1.261, abs=5e-4)
