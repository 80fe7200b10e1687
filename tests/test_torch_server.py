"""epic_tpu_torch's JSON/TCP server: verb sessions over a real socket,
following tests/test_server.py, on the CPU (plain torch version): the 2D
verbs, compute_paths, and the *_3d family on a volume session that ticks in
the same loop. Every verb of epic_tpu's server is served; the sampling_*
sessions are tests/test_torch_sampling.py's."""

import json
import os
import pathlib
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from epic_tpu import maps
from epic_tpu.planner import PlannerConfig as JPlannerConfig
from epic_tpu.services import messages as jmsg
from epic_tpu.services.navigation_node import EpicNavigationNodeRviz as JNode
from epic_tpu_torch.planner import PlannerConfig
from epic_tpu_torch.services.navigation_node import EpicNavigationNodeRviz
from epic_tpu_torch.services import server as server_mod
from epic_tpu_torch.services.server import EpicClient, EpicServiceServer, ingest_map

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs several worker processes at once,
    and torch's default of one OpenMP thread per core oversubscribes them
    (spin-waiting threads slowed this file about 30-fold)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture()
def server_client():
    node = EpicNavigationNodeRviz(PlannerConfig(epsilon=1e-2, steps_per_update=25), device="cpu")
    server = EpicServiceServer(node, port=0)  # ephemeral port
    stop = threading.Event()

    def loop():
        while not stop.is_set():
            server.spin_once()

    t = threading.Thread(target=loop, daemon=True)
    t.start()
    client = EpicClient(port=server.port)
    yield server, client
    stop.set()
    t.join(timeout=5)
    assert not t.is_alive()
    client.close()
    server.close()


def _occupancy(img):
    occ = np.zeros(img.shape, dtype=np.int8)
    occ[img == 0] = 100
    return occ.reshape(-1).tolist()


def _wait_iteration(client, n, timeout=30):
    deadline = time.time() + timeout
    while time.time() < deadline and client.call("info")["iteration"] < n:
        time.sleep(0.05)
    assert client.call("info")["iteration"] >= n


def test_full_replanning_session_over_socket(server_client):
    server, client = server_client
    img = maps.open_room(40, 40)
    assert client.call("occupancy_grid", width=40, height=40, data=_occupancy(img))["success"]
    r = client.call("info")
    assert r["initialized"] and r["shape"] == [40, 40]
    assert client.call("add_goals", goals=[[20.0, 20.0]])["success"]
    assert client.call("get_cell", x=20, y=20) == {"success": True, "value": 0.0}
    _wait_iteration(client, 500)

    r = client.call("compute_path", x=5.0, y=5.0, step_size=0.2, precision=0.4)
    assert r["success"]
    path = np.asarray(r["path"])
    assert len(path) > 2 and path.shape[1] == 3
    assert abs(path[-1][0] - 20) < 2 and abs(path[-1][1] - 20) < 2

    # Pause stops iteration growth.
    assert client.call("set_status", paused=True)["success"]
    it0 = client.call("info")["iteration"]
    time.sleep(0.3)
    assert client.call("info")["iteration"] == it0

    # Edits and the cold restart, while paused.
    assert client.call("set_cells", v=[7, 9], types=[1])["success"]
    assert client.call("get_cell", x=7, y=9)["value"] == -1e6
    assert client.call("remove_goals", goals=[[20.0, 20.0]])["success"]
    assert client.call("reset_free_cells")["success"]
    assert client.call("get_cell", x=20, y=20)["value"] == -1e6
    assert client.call("info")["iteration"] == 0
    assert client.call("set_status", paused=False)["success"]


def test_malformed_requests_get_clean_errors(server_client):
    _, client = server_client
    r = client.call("nonexistent_srv")
    assert not r["success"] and "unknown srv" in r["error"]
    r = client.call("get_cell", x=3)  # missing y
    assert not r["success"] and "bad request" in r["error"]
    r = client.call("compute_path", x=1.0, y=1.0)  # planner uninitialized
    assert not r["success"]
    r = client.call("get_field")
    assert not r["success"] and "not initialized" in r["error"]
    client.sock.sendall(b"this is not json\n")
    while b"\n" not in client._buf:
        client._buf += client.sock.recv(1 << 20)
    line, client._buf = client._buf.split(b"\n", 1)
    assert not json.loads(line)["success"]


@pytest.mark.parametrize("verb", ["compute_paths", "occupancy_volume", "get_cell_3d",
                                  "compute_path_3d", "sampling_occupancy",
                                  "sampling_compute_path"])
def test_unported_verbs_answer_a_clean_error(server_client, verb):
    """Every verb is ported: compute_paths, the 3D and the sampling verbs,
    sent without a session or arguments, answer a clean error of their
    own."""
    _, client = server_client
    r = client.call(verb, x=1.0, y=1.0, starts=[[1.0, 1.0]])
    assert not r["success"]
    assert "not ported" not in r["error"] and "unknown srv" not in r["error"]
    if verb == "sampling_compute_path":
        assert r["error"] == "no sampling session (send sampling_occupancy first)"
    assert client.call("info")["success"]  # the loop carries on


def test_only_the_sampling_verbs_are_not_ported():
    """The sampling verbs were the last unported ones; now none is, and the
    server keeps no list of refused verbs."""
    assert not hasattr(server_mod, "NOT_PORTED")
    assert server_mod.VERBS_SAMPLING == {"sampling_add_goals", "sampling_remove_goals",
                                         "sampling_set_cells", "sampling_compute_path"}


def test_compute_paths_over_socket(server_client):
    """Batched multi-start paths (tests/test_server.py's compute_paths
    session): invalid starts give None, the others reach the goal."""
    _, client = server_client
    img = maps.open_room(40, 40)
    assert client.call("occupancy_grid", width=40, height=40, data=_occupancy(img))["success"]
    assert client.call("add_goals", goals=[[20.0, 20.0]])["success"]
    _wait_iteration(client, 300)
    r = client.call("compute_paths", starts=[[5.0, 5.0], [-9.0, 1.0], [30.0, 30.0]],
                    step_size=0.2, precision=0.4)
    assert r["success"] and r["paths"][1] is None
    for idx in (0, 2):
        p = np.asarray(r["paths"][idx])
        assert len(p) > 2 and p.shape[1] == 3
        assert abs(p[-1][0] - 20) < 2.5 and abs(p[-1][1] - 20) < 2.5


def test_volume_session_3d_verbs(server_client):
    """The *_3d verbs drive an independent volume session that relaxes in
    the same anytime loop as the 2D planner (tests/test_server.py's 3D
    session), plus compute_paths_3d."""
    server, client = server_client
    r = client.call("get_cell_3d", x=1, y=1, z=1)
    assert not r["success"] and "occupancy_volume" in r["error"]

    d, h, w = 12, 16, 20
    vol = np.zeros((d, h, w), dtype=np.int8)  # all free (occupancy 0)
    assert client.call("occupancy_volume", depth=d, height=h, width=w,
                       data=vol.reshape(-1).tolist(), resolution=1.0,
                       origin=[0.0, 0.0, 0.0])["success"]
    assert server.volume_planner.device == server.node.planner.device
    assert client.call("add_goals_3d", goals=[[10.0, 8.0, 6.0]])["success"]
    assert client.call("get_cell_3d", x=10, y=8, z=6) == {"success": True, "value": 0.0}
    # Duplicate voxel resolves last-wins (obstacle then goal -> goal).
    assert client.call("set_cells_3d", v=[3, 3, 3, 3, 3, 3], types=[1, 0])["success"]
    assert client.call("get_cell_3d", x=3, y=3, z=3)["value"] == 0.0

    deadline = time.time() + 30
    info = {}
    while time.time() < deadline:
        info = client.call("info")
        if info.get("volume", {}).get("iteration", 0) >= 200:
            break
        time.sleep(0.05)
    assert info["volume"]["shape"] == [d, h, w] and info["volume"]["iteration"] >= 200
    assert info["volume"]["paused"] is False and "delta" in info["volume"]

    r = client.call("compute_path_3d", x=3.0, y=12.0, z=9.0, step_size=0.2, precision=0.4)
    assert r["success"]
    end = r["path"][-1]
    assert len(r["path"][0]) == 5  # x, y, z, yaw, pitch
    assert abs(end[0] - 10) < 2 and abs(end[1] - 8) < 2 and abs(end[2] - 6) < 2
    r = client.call("compute_paths_3d", starts=[[3.0, 12.0, 9.0], [-1.0, 2.0, 2.0],
                                                [16.0, 3.0, 2.0]],
                    step_size=0.2, precision=0.4)
    assert r["success"] and r["paths"][1] is None
    for idx in (0, 2):
        end = r["paths"][idx][-1]
        assert len(end) == 5
        assert abs(end[0] - 10) < 2 and abs(end[1] - 8) < 2 and abs(end[2] - 6) < 2

    # Pause only the 3D session; the 2D planner is untouched.
    assert client.call("set_status_3d", paused=True)["success"]
    it0 = client.call("info")["volume"]["iteration"]
    time.sleep(0.3)
    assert client.call("info")["volume"]["iteration"] == it0
    # While paused: removing the goal frees the voxel, reset clears stale potentials.
    assert client.call("remove_goals_3d", goals=[[10.0, 8.0, 6.0]])["success"]
    assert client.call("reset_free_cells_3d")["success"]
    assert client.call("get_cell_3d", x=10, y=8, z=6)["value"] == pytest.approx(-1e6)
    assert client.call("info")["volume"]["iteration"] == 0
    assert client.call("set_status_3d", paused=False)["success"]
    r = client.call("get_cell_3d", x=99, y=1, z=1)
    assert not r["success"]


def test_partial_line_framing(server_client):
    server, _ = server_client
    raw = socket.create_connection(("127.0.0.1", server.port), timeout=10)
    payload = json.dumps({"srv": "info"}).encode() + b"\n"
    for i in range(0, len(payload), 3):
        raw.sendall(payload[i: i + 3])
        time.sleep(0.01)
    raw.sendall(payload + payload)
    buf = b""
    while buf.count(b"\n") < 3:
        data = raw.recv(1 << 16)
        assert data
        buf += data
    for line in buf.split(b"\n")[:3]:
        assert json.loads(line)["success"]
    raw.close()


def test_multi_client_interleaving(server_client):
    server, client1 = server_client
    img = maps.open_room(32, 32)
    assert client1.call("occupancy_grid", width=32, height=32, data=_occupancy(img))["success"]
    client2 = EpicClient(port=server.port)
    client3 = EpicClient(port=server.port)
    try:
        for _ in range(10):
            assert client2.call("info")["success"]
            assert client1.call("get_cell", x=5, y=5)["success"]
            assert client3.call("info")["shape"] == [32, 32]
    finally:
        client2.close()
        client3.close()


def test_get_field_and_get_map_windows(server_client):
    server, client = server_client
    img = maps.open_room(24, 24)
    assert client.call("occupancy_grid", width=24, height=24, data=_occupancy(img))["success"]
    assert client.call("add_goals", goals=[[12.0, 12.0]])["success"]
    r = client.call("get_field", x0=10, y0=11, x1=14, y1=13)
    assert r["success"] and r["width"] == 4 and r["height"] == 2
    u = np.asarray(r["u"])
    assert u.shape == (2, 4) and u[1, 2] == 0.0  # the goal cell (12, 12)
    m = client.call("get_map")
    assert m["success"] and m["width"] == 24 and m["height"] == 24
    cells = np.asarray(m["cells"])
    assert cells[12, 12] == 255 and cells[0, 0] == 0 and cells[5, 5] == 128
    r = client.call("get_field", x0=-5, y0=20, x1=999, y1=999)
    assert r["success"] and r["x0"] == 0 and r["height"] == 4


def test_slow_reader_does_not_crash_server(server_client):
    """Responses larger than the send buffer are kept and flushed on
    EVENT_WRITE readiness (non-blocking sockets)."""
    server, client = server_client
    img = maps.open_room(48, 48)
    assert client.call("occupancy_grid", width=48, height=48, data=_occupancy(img))["success"]
    assert client.call("add_goals", goals=[[24.0, 24.0]])["success"]
    _wait_iteration(client, 300)
    slow = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    slow.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 4096)
    slow.connect(("127.0.0.1", server.port))
    time.sleep(0.2)
    for sock in list(server._buffers):
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, 8192)
    n_req = 20
    req = (json.dumps({"srv": "compute_path", "x": 5.0, "y": 5.0,
                       "step_size": 0.05, "precision": 0.5}) + "\n").encode()
    slow.sendall(req * n_req)
    time.sleep(1.0)
    assert client.call("info")["success"]
    slow.settimeout(30)
    buf, lines = b"", []
    while len(lines) < n_req:
        data = slow.recv(1 << 16)
        assert data, "server closed before delivering all responses"
        buf += data
        while b"\n" in buf:
            line, buf = buf.split(b"\n", 1)
            lines.append(line)
    for line in lines:
        r = json.loads(line)
        assert r["success"] and len(r["path"]) > 2
    slow.close()


def test_metrics_verb_reports_latency_and_errors(server_client):
    _, client = server_client
    img = maps.open_room(24, 24)
    assert client.call("occupancy_grid", width=24, height=24, data=_occupancy(img))["success"]
    assert client.call("get_cell", x=3, y=3)["success"]
    assert not client.call("compute_paths_3d")["success"]
    m = client.call("metrics")
    assert m["success"]
    assert m["counters"]["verb.occupancy_grid.calls"] == 1
    assert m["counters"]["verb.compute_paths_3d.errors"] == 1
    assert m["latencies"]["verb.get_cell"]["count"] == 1
    assert m["counters"]["ticks"] >= 1


def test_metrics_verb_reports_percentiles(server_client):
    _, client = server_client
    for _ in range(5):
        client.call("get_cell", x=3, y=3)   # timed whether or not it succeeds
    stat = client.call("metrics")["latencies"]["verb.get_cell"]
    assert stat["count"] == 5
    for key in ("p50_s", "p95_s", "p99_s"):
        assert stat["min_s"] <= stat[key] <= stat["max_s"]
    assert stat["p50_s"] <= stat["p95_s"] <= stat["p99_s"]


def test_latency_percentiles_within_one_bucket_of_numpy():
    from epic_tpu_torch import metrics

    x = np.random.default_rng(7).lognormal(np.log(0.01), 1.0, 5000)
    reg = metrics.MetricsRegistry()
    for v in x:
        reg.observe("verb", float(v))
    stat = reg.snapshot()["latencies"]["verb"]
    width = 10 ** (1 / metrics.BUCKETS_PER_DECADE) - 1   # a bucket's width, relative
    for q in (50, 95, 99):
        exact = np.percentile(x, q)
        assert abs(stat[f"p{q}_s"] - exact) <= width * exact
    assert stat["count"] == 5000 and stat["max_s"] == x.max() and stat["min_s"] == x.min()
    assert len(reg.latencies["verb"].buckets) == metrics.N_BUCKETS   # fixed, whatever the count


def test_ingest_map_matches_jax_server_startup():
    """ingest_map loads a map as epic_tpu's server main does (occupancy from
    the 0 pixels, goals from the 255 pixels): the same cells."""
    img = maps.recursive_maze(30, 36, seed=4)
    img[5, 7] = 255
    node = EpicNavigationNodeRviz(PlannerConfig(epsilon=1e-2), device="cpu")
    ingest_map(node, img)
    jnode = JNode(JPlannerConfig(epsilon=1e-2))
    occ = np.zeros(img.shape, dtype=np.int8)
    occ[img == 0] = 100
    jnode.sub_occupancy_grid(jmsg.OccupancyGrid(img.shape[1], img.shape[0], 1.0, 0.0, 0.0, occ))
    ys, xs = np.nonzero(img == 255)
    jnode.srv_add_goals(jmsg.ModifyGoalsRequest(
        [jmsg.PoseStamped(float(x), float(y)) for y, x in zip(ys, xs)]))
    np.testing.assert_array_equal(node.planner.state.u.numpy(), np.asarray(jnode.planner.state.u))
    np.testing.assert_array_equal(node.planner.state.locked.numpy(),
                                  np.asarray(jnode.planner.state.locked))


def test_cli_main_subprocess(tmp_path):
    """`python -m epic_tpu_torch.services.server --device cpu`: a real
    process, map preload from a PNG, a client session over TCP, clean kill."""
    from PIL import Image

    img = maps.recursive_maze(48, 48, seed=9)
    png = tmp_path / "m.png"
    Image.fromarray(img).save(png)
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    proc = subprocess.Popen(
        [sys.executable, "-m", "epic_tpu_torch.services.server", "--port", str(port),
         "--map", str(png), "--epsilon", "1e-2", "--steps-per-update", "25",
         "--device", "cpu", "--config", str(ROOT / "configs" / "maze.yaml")],
        cwd=ROOT, env=dict(os.environ), stdout=subprocess.PIPE, stderr=subprocess.DEVNULL)
    try:
        cli = None
        deadline = time.time() + 120
        while time.time() < deadline:
            try:
                cli = EpicClient(port=port, timeout=60.0)
                break
            except OSError:
                assert proc.poll() is None, "server process died"
                time.sleep(0.2)
        assert cli is not None, "server never accepted connections"
        info = cli.call("info")
        assert info["initialized"] and info["shape"] == [48, 48]
        ys, xs = np.nonzero(img == 128)
        i = len(ys) // 3
        deadline = time.time() + 60
        r = {}
        while time.time() < deadline:
            r = cli.call("compute_path", x=float(xs[i]), y=float(ys[i]),
                         step_size=0.2, precision=0.4)
            if r.get("path"):
                break
            time.sleep(0.2)
        assert r.get("path"), f"no path over the CLI server: {json.dumps(r)[:200]}"
        cli.close()
    finally:
        proc.kill()
        proc.wait(timeout=10)


def test_cli_parses_host_log_json_and_mesh():
    """The flags epic_tpu's server has: --host, --log-json, --mesh; --mesh
    on a host without a card raises (no silent CPU mesh)."""
    from epic_tpu_torch.services.server import main, parse_args

    args = parse_args(["--host", "0.0.0.0", "--log-json", "--mesh", "--port", "7200"])
    assert (args.host, args.log_json, args.mesh, args.port) == ("0.0.0.0", True, True, 7200)
    args = parse_args([])
    assert (args.host, args.log_json, args.mesh, args.device) == (None, False, False, "cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--mesh", "--port", "0"])
