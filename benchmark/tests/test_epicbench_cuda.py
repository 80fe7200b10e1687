"""On the card: each cell runs end to end for a short window, and its last
line is correct. ``python -m pytest benchmark/tests -m cuda`` on the chip;
skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import harness
from benchmark.tests.epicbench_util import REPO

CELLS = [w["name"] for w in harness.Catalog(REPO).bench["workloads"]]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, traced):
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", cell,
                           "--seed", "2147483647", "--seconds", "3", "--trace", str(traced)],
                          cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    if traced:
        assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
        assert all(v["value"] <= 105 for k, v in line["metrics"].items() if "roofline" in k)
