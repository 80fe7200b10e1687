"""The harness finds configurations, traffic mixes and metrics by name, and
takes a new one as a new file, with no edit to a file that is there."""

from __future__ import annotations

import json
import re

import pytest

from benchmark import harness
from benchmark.tests.epicbench_util import REPO, run_cpu, tiny_checkout

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_repo_benchmark_names_its_files():
    cat = harness.Catalog(REPO)
    bench = cat.bench
    assert bench["command"] == ["python3", "-m", "benchmark.run"]
    assert bench["paths"] == ["benchmark"]
    for c in bench["configs"]:
        assert cat.config(c["name"])["name"] == c["name"]
        assert c["file"].startswith("benchmark/configs/")
    for w in bench["workloads"]:
        assert cat.cell(w["name"])["config"] in {c["name"] for c in bench["configs"]}
        traffic = cat.traffic(w["traffic"])
        assert harness.driver(traffic["driver"]).run
        assert w["chips"] == 1
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]), m["name"]
        assert callable(cat.reader(m["name"]))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    cat = harness.Catalog(REPO)
    for w in cat.bench["workloads"]:
        e2e = {m["name"] for m in cat.metrics(w["name"], traced=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = cat.metrics(w["name"], traced=True)
        assert layer and all(m["moves"] in e2e for m in layer)


def test_benchmark_json_keys_and_limits():
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert len((REPO / "BENCHMARK.json").read_bytes()) < 64 * 1024


@pytest.fixture
def checkout(tmp_path):
    return tiny_checkout(tmp_path)


def test_new_traffic_mix_and_metric_are_new_files(checkout):
    mixes = checkout / "benchmark" / "traffic"
    (mixes / "goal_solve_b.json").write_text(
        json.dumps(json.loads((mixes / "goal_solve.json").read_text()) | {"warmup_seed": 7}))
    (checkout / "benchmark" / "metrics" / "max_sweeps.goal_solve_b.py").write_text(
        "def read(run):\n    return max(i['sweeps'] for i in run.items) if run.items else None\n")
    (checkout / "benchmark" / "metrics" / "silent.goal_solve_b.py").write_text(
        "def read(run):\n    return None\n")
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.goal_solve_b", "config": "tiny",
                               "traffic": "goal_solve_b", "chips": 1, "why": "x"})
    for m in bench["end_to_end"]:
        if "plans_per_s" == m["name"]:
            m["workloads"].append("tiny.goal_solve_b")
    bench["end_to_end"].append({"name": "max_sweeps.goal_solve_b", "unit": "sweeps",
                                "better": "lower", "bound": 0.1, "source": "host_clock",
                                "workloads": ["tiny.goal_solve_b"]})
    bench["end_to_end"].append({"name": "silent.goal_solve_b", "unit": "sweeps",
                                "better": "lower", "bound": 0.1, "source": "host_clock",
                                "workloads": ["tiny.goal_solve_b"]})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cpu(checkout, "tiny.goal_solve_b")
    assert set(out["metrics"]) == {"setup_s", "plans_per_s", "max_sweeps.goal_solve_b"}
    assert out["metrics"]["max_sweeps.goal_solve_b"]["value"] > 0
    assert out["correct"]


def test_new_configuration_is_a_new_file(checkout):
    bench = json.loads((checkout / "BENCHMARK.json").read_text())
    cfg = json.loads((checkout / "benchmark/configs/tiny.json").read_text())
    cfg.update(name="tiny_eps", epsilon=0.01)
    (checkout / "benchmark/configs/tiny_eps.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "tiny_eps", "source": "x", "reduced": [], "why": "x",
                             "file": "benchmark/configs/tiny_eps.json"})
    bench["workloads"].append({"name": "tiny_eps.fleet64", "config": "tiny_eps",
                               "traffic": "fleet64", "chips": 1, "why": "x"})
    (checkout / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cpu(checkout, "tiny_eps.fleet64")
    assert set(out["metrics"]) == {"setup_s"}
    assert out["correct"] and out["attempted"] > 0


def test_unknown_cell_is_refused(checkout):
    with pytest.raises(KeyError):
        harness.Catalog(checkout).cell("tiny.nothing")
