"""epic_tpu_torch.tools.anytime_demo against the JAX package's
tools/anytime_demo.py on a 64^2 recursive maze, on the CPU: the same sweeps
in the anytime loop, the same starts, the same retry rounds (each start's
path after the same sweeps) and the same number of paths, and a PNG
written. The JAX tool's walker is handed the port's native library (no test
calls epic_tpu.native); the two packages' fields differ by an ulp, so each
path's pose count is held within 2%.
"""

import importlib
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

jdemo = importlib.import_module("anytime_demo")

from epic_tpu import native as jnative  # noqa: E402
from epic_tpu_torch import maps, native  # noqa: E402
from epic_tpu_torch.tools import anytime_demo  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: several test processes share the
    host's cores, and torch's OpenMP pool, which spins between the many
    small ops of a CPU relaxation, slows such runs twentyfold when every
    process keeps a thread a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


START = re.compile(r"start \((\d+),(\d+)\): (\d+) poses \(after (\d+) sweeps\)")


@pytest.fixture()
def maze_png(tmp_path, monkeypatch):
    from PIL import Image

    for name in ("available", "compute_path"):
        monkeypatch.setattr(jnative, name, getattr(native, name))
    p = tmp_path / "maze64.png"
    Image.fromarray(maps.recursive_maze(64, 64, seed=3)).save(p)
    return p


@pytest.mark.parametrize("ticks, starts", [(40, 6), (2, 4)])
def test_demo_matches_the_jax_tool(maze_png, tmp_path, monkeypatch, capsys, ticks, starts):
    jpng, tpng = tmp_path / "jax.png", tmp_path / "torch.png"
    flags = ["--map", str(maze_png), "--ticks", str(ticks), "--starts", str(starts)]
    monkeypatch.setattr(sys, "argv", ["anytime_demo.py", *flags, "--out", str(jpng)])
    jdemo.main()
    jout = capsys.readouterr().out
    got = anytime_demo.main([*flags, "--out", str(tpng), "--device", "cpu"])
    tout = capsys.readouterr().out

    jsweeps = int(re.search(r"anytime loop: (\d+) sweeps", jout).group(1))
    assert got["sweeps"] == jsweeps == ticks * 50
    assert re.search(r"anytime loop: (\d+) sweeps", tout).group(1) == str(jsweeps)
    j = START.findall(jout)
    t = START.findall(tout)
    assert [(x, y, s) for x, y, _, s in t] == [(x, y, s) for x, y, _, s in j]
    for (_, _, tn, _), (_, _, jn, _) in zip(t, j):
        assert abs(int(tn) - int(jn)) <= 0.02 * int(jn)
    jpaths = int(re.search(r"rendered (\d+) paths", jout).group(1))
    assert len(got["poses"]) == jpaths == len(t)
    assert got["poses"] == [int(n) for _, _, n, _ in t]
    assert got["pending"] == [] or len(got["pending"]) == starts - jpaths
    assert tpng.exists() and maps.load_png(tpng).shape == (64, 64)


def test_demo_without_a_goal_pixel(tmp_path):
    """A map without a goal pixel takes a free cell mid-map as its goal."""
    from PIL import Image

    img = maps.recursive_maze(48, 48, seed=1)
    img = np.where(img == 255, 128, img).astype(np.uint8)
    p = tmp_path / "nogoal.png"
    Image.fromarray(img).save(p)
    got = anytime_demo.main(["--map", str(p), "--ticks", "20", "--starts", "3",
                             "--out", str(tmp_path / "d.png"), "--device", "cpu"])
    assert got["sweeps"] == 1000 and len(got["poses"]) + len(got["pending"]) == 3
