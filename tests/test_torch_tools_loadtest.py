"""epic_tpu_torch.tools.server_loadtest end to end against the port's server
on the CPU, the counterpart of tests/test_server_loadtest_tool.py: the one
JSON line has the JAX tool's keys at every level, no protocol error, and
every verb's samples."""

import importlib
import json
import pathlib
import sys

import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

jload = importlib.import_module("server_loadtest")

from epic_tpu_torch.tools import server_loadtest  # noqa: E402


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


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k != "verbs":
            out |= _keys(v, prefix + k + ".")
    return out


@pytest.fixture(scope="module")
def jax_report():
    old = sys.argv
    sys.argv = ["server_loadtest.py", "--clients", "2", "--rounds", "5", "--size", "64",
                "--backend", "xla"]
    try:
        import io
        import contextlib

        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jload.main()
    finally:
        sys.argv = old
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("clients, rounds", [(2, 5), (3, 8)])
def test_loadtest_matches_the_jax_tools_report(jax_report, capsys, clients, rounds):
    rep = server_loadtest.main(["--clients", str(clients), "--rounds", str(rounds),
                                "--size", "64", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == rep
    assert _keys(rep) == _keys(jax_report)
    assert rep["metric"] == jax_report["metric"] == "server_requests_per_s"
    assert rep["unit"] == "req/s" and rep["value"] > 0
    d = rep["detail"]
    assert d["protocol_errors"] == 0
    assert d["backend"] == "cpu" and d["grid"] == "64x64"
    assert d["clients"] == clients and d["rounds"] == rounds
    edits = sum(1 for r in range(rounds) if r % 7 == 3)
    assert set(d["verbs"]) == {"compute_path", "get_cell", "set_cells"}
    assert d["verbs"]["compute_path"]["n"] == d["verbs"]["get_cell"]["n"] == clients * rounds
    assert d["verbs"]["set_cells"]["n"] == clients * edits
    for name, v in d["verbs"].items():
        assert set(v) == set(jax_report["detail"]["verbs"]["get_cell"]), name
        assert 0 < v["p50_ms"] <= v["p95_ms"] <= v["p99_ms"] <= v["max_ms"]


def test_loadtest_against_an_external_server(capsys):
    """--port drives a server that is already running."""
    import threading

    from epic_tpu_torch.planner import PlannerConfig
    from epic_tpu_torch.services.navigation_node import EpicNavigationNodeRviz
    from epic_tpu_torch.services.server import EpicServiceServer

    server = EpicServiceServer(EpicNavigationNodeRviz(PlannerConfig(), device="cpu"), port=0)
    stop = threading.Event()

    def spin():
        while not stop.is_set():
            server.spin_once()

    t = threading.Thread(target=spin, daemon=True)
    t.start()
    try:
        rep = server_loadtest.main(["--clients", "2", "--rounds", "4", "--size", "48",
                                    "--port", str(server.port), "--device", "cpu"])
    finally:
        stop.set()
        t.join(timeout=30)
        server.close()
    assert rep["detail"]["protocol_errors"] == 0
    assert rep["detail"]["verbs"]["compute_path"]["n"] == 8
    assert server.metrics.snapshot()["counters"]["verb.compute_path.calls"] >= 8
