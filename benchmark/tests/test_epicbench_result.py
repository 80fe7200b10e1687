"""The shape of a run's last line, the trace arithmetic the per-layer metrics
read, and a run that finds no card."""

from __future__ import annotations

import json
import subprocess
import sys

import pytest

from benchmark import run as run_mod, trace
from benchmark.tests.epicbench_util import REPO, run_cpu, tiny_checkout


@pytest.fixture(scope="module")
def checkout(tmp_path_factory):
    return tiny_checkout(tmp_path_factory.mktemp("bench"))


def test_last_line_shape(checkout):
    out = run_cpu(checkout, "tiny.goal_solve")
    line = run_mod.assemble(out, "NVIDIA H100 80GB HBM3", 1, "700.00 W")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert set(line["metrics"]) == {"setup_s", "plan_ms_p95", "plans_per_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    assert set(line["compared"]) == {"field_gap", "sweeps_gap", "path_gap"}
    for v in line["compared"].values():
        assert set(v) == {"value", "limit"} and v["value"] <= v["limit"]
    json.loads(json.dumps(line, allow_nan=False))


def test_traced_line_has_device_window(checkout):
    out = run_cpu(checkout, "tiny.fleet64", traced=True)
    line = run_mod.assemble(out, "cpu", 1, "not read")
    assert line["device"]["window_s"] > 0 and "busy_s" in line["device"]
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # No device operations on the CPU: the device's metrics find nothing.
    assert "device_idle_pct.fleet64" not in line["metrics"]
    assert "solve_roofline_pct.fleet64" not in line["metrics"]


def test_trace_arithmetic():
    chrome = {"traceEvents": [
        {"ph": "X", "cat": "user_annotation", "name": "bench.window", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "bench.request", "ts": 10, "dur": 50},
        {"ph": "X", "cat": "user_annotation", "name": "bench.walker", "ts": 40, "dur": 20},
        {"ph": "X", "cat": "user_annotation", "name": "other", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": 25, "dur": 10},
        {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "ts": 70, "dur": 5},
        {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": 0, "dur": 100},
    ]}
    t = trace.parse(chrome)
    assert [s[0] for s in t.spans] == ["window", "request", "walker"]
    assert t.busy(0, 100e-6) == pytest.approx(30e-6)
    assert t.busy(10e-6, 60e-6) == pytest.approx(25e-6)
    assert t.device_time(10e-6, 60e-6) == pytest.approx(30e-6)
    gaps = t.idle_gaps()
    assert [round((b - a) * 1e6) for a, b in gaps] == [10, 35, 25]
    b = trace.breakdown(t)
    assert b["device_ops"][0][0] == "k" and b["device_ops"][0][1] == pytest.approx(30e-6)
    assert b["idle_gaps"][0] == ["walker", pytest.approx(35e-6)]


def test_no_card_no_result():
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "maze_demo.goal_solve", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_benchmark_files_alone_fail(tmp_path):
    """A directory that holds only BENCHMARK.json and the files under
    ``paths`` has no program: the run fails and prints no result."""
    import shutil

    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                           "maze_demo.goal_solve", "--seed", "1", "--seconds", "1",
                           "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
