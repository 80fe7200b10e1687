"""The demo maps under ``benchmark/data`` are the goldens' images byte for
byte, with the checksums their configurations state."""

from __future__ import annotations

import json

import numpy as np
import pytest

from benchmark import inputs
from benchmark.tests.epicbench_util import REPO


@pytest.mark.parametrize("config,golden", [("maze_demo", "maze"), ("umass_demo", "umass")])
def test_map_is_the_golden_image(config, golden):
    cfg = json.loads((REPO / "benchmark/configs" / f"{config}.json").read_text())
    with np.load(REPO / cfg["map"]["file"]) as data:
        img = data[cfg["map"]["key"]]
    with np.load(REPO / "tests/goldens" / f"{golden}.npz") as data:
        ref = data["img"]
    assert img.dtype == ref.dtype and img.shape == ref.shape
    assert img.tobytes() == ref.tobytes()
    assert inputs.image_sha256(img) == cfg["map"]["sha256"]
    assert [cfg["map"]["height"], cfg["map"]["width"]] == list(img.shape)
    assert cfg["reduced"] == []
