#!/usr/bin/env python3
"""Drive epic_tpu_torch's main path once on one CUDA card, and check it.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the CUDA kernels from ``epic_tpu_torch/csrc/`` with nvcc, then:

  1. build    — the card's name and power limit, the nvcc build time;
  2. maze     — each kernel against its plain torch version on the maze
                demo map (tests/goldens/maze.npz): a 50-sweep tick at an even
                and an odd start iteration, and a full solve. Tolerance: the
                same bits (max abs diff 0.0);
  3. goldens  — the kernels on maze and umass against the reference
                binary's goldens, by tests/test_goldens.py's rules: 300
                sweeps within 1e-3 of the recorded field; the solve's
                iterations equal, or a whole number of stagger cycles apart
                with the deciding delta within 5e-4 of eps. The converged
                free-cell field is held within 1e-2 (FIELD_TOL below);
  4. session  — the main path: the JSON/TCP server on localhost with
                configs/maze.yaml's settings and the maze map, driven over a
                real socket (info, ticks, a cell edit, a blocking solve,
                get_cell, compute_path from the golden starts, whose paths
                must reach the goal). The kernels' launch counts are zeroed
                just before and read just after; each kernel must have run
                and the plain version must not;
  5. size     — a 4096 x 4096 random-obstacle planner: a 100-sweep tick and a
                solve capped at 2000 iterations, kernel against plain, same
                bits, with both times.

Each phase prints one JSON line and raises on failure. Then come the kernels'
JSON line, the nvidia-smi line, and last ``{"ok": true, "device": ...}``.
Times are CUDA-event times on the card the script ran on.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import select
import subprocess
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parent
GOLDENS = ROOT / "tests" / "goldens"
STAGGER = 100
EPS = 1e-3                 # configs/maze.yaml and the goldens' epsilon
# The converged demo fields sit below the reference binary's by up to
# 1.22e-3 (maze) and 8.64e-3 (umass), measured with the plain version on the
# CPU: the binary subtracts a double log(4), the port (like epic_tpu)
# float32(log 4), 3.8e-9 more per update, and the bias accumulates over the
# field's long random-walk paths. 1e-3 holds for the 300-sweep fields, as in
# tests/test_goldens.py; the converged fields are held to FIELD_TOL.
FIELD_TOL = 1e-2
SIZE_SIDE = 4096          # 67 MB of u: beyond the 50 MB L2, all 132 SMs busy
SOURCE = "epic_tpu_torch/csrc/sweep2d.cu"
REPLACES = {
    "epic_sweep2d_chunk": "epic_tpu/solver/pallas_sweep.py:90",
    "epic_sweep2d_solve": "epic_tpu/solver/pallas_sweep.py:130",
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def event_ms(fn, reps: int = 1) -> float:
    """Mean CUDA-event time of ``reps`` calls of ``fn``, in ms."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.double() - b.double()).abs().max())


def compare(k, p, what: str) -> float:
    """Kernel state vs plain state: the same bits in u, delta, iteration."""
    err = max(max_abs(k.u, p.u), max_abs(k.delta, p.delta))
    require(int(k.iteration) == int(p.iteration),
            f"{what}: iteration {int(k.iteration)} (kernel) != {int(p.iteration)} (plain)")
    require(bool(k.converged) == bool(p.converged), f"{what}: converged differs")
    require(bool(torch.isfinite(k.u).all()), f"{what}: non-finite values in u")
    require(err == 0.0, f"{what}: kernel and plain differ by {err}")
    return err


def copy_state(state):
    return dataclasses.replace(state, u=state.u.clone())


def phase_build() -> dict:
    from epic_tpu_torch.solver import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    _build.load()
    load_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_info.get("log", "").splitlines()
             if "registers" in ln or "spill" in ln]
    emit(phase="build", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
         nvcc_s=_build.build_info.get("seconds"), load_s=load_s,
         library=str(_build.library_path().relative_to(ROOT)), ptxas=ptxas)
    return {"smi": smi}


def phase_maze(dev, maze) -> dict:
    import epic_tpu_torch as T
    from epic_tpu_torch.solver import core, hopper_sweep

    locked = T.from_occupancy_image(maze["img"], EPS, device="cpu").locked.numpy()
    errs = []
    for t0 in (300, 301):
        arrays = dict(u=maze["ref_u300"], locked=locked, iteration=np.int32(t0),
                      delta=np.float32(1.0), converged=np.bool_(False),
                      epsilon=np.float32(EPS))
        k = hopper_sweep.update_n(T.state_from_numpy(arrays, device=dev), 50)
        p = core.update_n(T.state_from_numpy(arrays, device=dev), 50)
        errs.append(compare(k, p, f"maze 50-sweep tick from iteration {t0}"))

    state = {"k": k, "p": p}

    def tick(which, fn):
        state[which] = fn(state[which], 50)

    tick_k_ms = event_ms(lambda: tick("k", hopper_sweep.update_n), reps=50)
    tick_p_ms = event_ms(lambda: tick("p", core.update_n), reps=10)

    out = {}
    solve_k_ms = event_ms(lambda: out.__setitem__(
        "k", hopper_sweep.solve(T.from_occupancy_image(maze["img"], EPS, device=dev), STAGGER)))
    solve_p_ms = event_ms(lambda: out.__setitem__(
        "p", core.solve(T.from_occupancy_image(maze["img"], EPS, device=dev), STAGGER)))
    solve_err = compare(out["k"], out["p"], "maze full solve")
    emit(phase="maze", shape=list(maze["img"].shape), tick_sweeps=50,
         tick_max_abs_err=max(errs), tick_kernel_ms=tick_k_ms, tick_plain_ms=tick_p_ms,
         solve_iterations=int(out["k"].iteration), solve_delta=float(out["k"].delta),
         solve_max_abs_err=solve_err, solve_kernel_ms=solve_k_ms, solve_plain_ms=solve_p_ms)
    return {"tick_err": max(errs), "tick_ms": tick_k_ms, "tick_plain_ms": tick_p_ms,
            "solve_err": solve_err, "solve_ms": solve_k_ms, "solve_plain_ms": solve_p_ms,
            "maze_solved": out["k"]}


def check_golden(name: str, g, solved, u300) -> dict:
    """tests/test_goldens.py's rules for a 300-sweep field and a solve
    against the reference binary's recorded run."""
    err300 = float(np.max(np.abs(u300.cpu().numpy() - g["ref_u300"])))
    require(err300 <= 1e-3, f"{name}: 300-sweep field differs from the golden by {err300}")
    ref_iters = int(g["ref_iters"])
    iters = int(solved.iteration)
    checks = dict(zip(g["check_iters"].tolist(), g["check_deltas"].tolist()))
    deciding = None
    if iters != ref_iters:
        require((iters - ref_iters) % STAGGER == 0,
                f"{name}: {iters} iterations vs the reference's {ref_iters}")
        deciding = checks.get(min(iters, ref_iters) - 1, float(solved.delta))
        require(abs(deciding - EPS) <= 5e-4,
                f"{name}: deciding delta {deciding} not within 5e-4 of eps")
    u = solved.u.cpu().numpy()
    free = ~solved.locked.cpu().numpy()
    field_err = float(np.max(np.abs(u[free] - g["ref_u"][free])))
    require(field_err <= FIELD_TOL, f"{name}: field differs from the golden by {field_err}")
    return dict(u300_max_abs_err=err300, iterations=iters, ref_iterations=ref_iters,
                deciding_delta=deciding, field_max_abs_err=field_err,
                converged=bool(solved.converged))


def phase_goldens(dev, maze, maze_solved) -> None:
    import epic_tpu_torch as T
    from epic_tpu_torch.solver import hopper_sweep

    def u300(g):
        return hopper_sweep.update_n(T.from_occupancy_image(g["img"], EPS, device=dev), 300).u

    umass = np.load(GOLDENS / "umass.npz")
    t0 = time.perf_counter()
    umass_solved = hopper_sweep.solve(T.from_occupancy_image(umass["img"], EPS, device=dev), STAGGER)
    torch.cuda.synchronize()
    umass_s = time.perf_counter() - t0
    emit(phase="goldens", field_tol=FIELD_TOL,
         maze=check_golden("maze", maze, maze_solved, u300(maze)),
         umass=dict(check_golden("umass", umass, umass_solved, u300(umass)), solve_s=umass_s))


def golden_goal_starts(g) -> list[tuple[float, float]]:
    """The golden starts whose recorded walk (on the reference's own field)
    ends in a goal cell."""
    from epic_tpu_torch import path

    locked = (g["img"] == 0) | (g["img"] == 255)
    out, off = [], 0
    for (x, y), n in zip(g["starts"], g["path_lens"]):
        walk = g["paths_concat"][off:off + int(n)]
        off += int(n)
        if n > 0 and path.path_reaches_goal(g["ref_u"], locked, walk):
            out.append((float(x), float(y)))
    return out


class LoopbackSession:
    """A client on a real socket, with the server's loop turned by hand:
    each spin services the sockets and then runs one tick, so the number of
    ticks is known."""

    def __init__(self, server, client):
        self.server = server
        self.client = client
        self.ticks = 0

    def spin(self, n: int = 1) -> None:
        for _ in range(n):
            self.server.spin_once()
            self.ticks += 1

    def call(self, srv: str, **args) -> tuple[dict, int]:
        """Send one request; spin until its answer arrives. Returns the
        answer and the number of ticks that ran before it was served."""
        sock = self.client.sock
        sock.sendall(json.dumps({"srv": srv, **args}).encode() + b"\n")
        buf = self.client._buf
        served_after = self.ticks
        while b"\n" not in buf:
            served_after = self.ticks
            self.spin()
            if select.select([sock], [], [], 1.0)[0]:
                data = sock.recv(1 << 20)
                require(bool(data), "server closed the connection")
                buf += data
        line, self.client._buf = buf.split(b"\n", 1)
        return json.loads(line), served_after


def phase_session(dev, maze) -> dict:
    from epic_tpu_torch import grid as G
    from epic_tpu_torch import path
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.services.navigation_node import EpicNavigationNodeRviz
    from epic_tpu_torch.services.server import EpicClient, EpicServiceServer, ingest_map
    from epic_tpu_torch.solver import core, hopper_sweep

    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    steps = cfg.service.steps_per_update
    img = maze["img"]
    t_start = time.perf_counter()
    node = EpicNavigationNodeRviz(cfg, update_rate=cfg.service.update_rate_hz, device=dev)
    ingest_map(node, img)
    server = EpicServiceServer(node, "127.0.0.1", 0)
    client = EpicClient(port=server.port, timeout=60.0)
    s = LoopbackSession(server, client)
    try:
        for d in (hopper_sweep.launches, core.calls):
            for k in d:
                d[k] = 0
        r, at = s.call("info")
        require(r["success"] and r["initialized"] and r["shape"] == list(img.shape),
                f"info: {r}")
        require(r["iteration"] == steps * at, f"info iteration {r['iteration']} after {at} ticks")
        t0 = time.perf_counter()
        s.spin(10)
        torch.cuda.synchronize()
        ten_ticks_s = time.perf_counter() - t0
        r, at = s.call("info")
        require(r["iteration"] == steps * at, f"info iteration {r['iteration']} after {at} ticks")

        # An obstacle edit on a free cell, relaxed around, then reverted.
        ys, xs = np.nonzero((img != 0) & (img != 255))
        ex, ey = int(xs[len(xs) // 2]), int(ys[len(ys) // 2])
        r, _ = s.call("set_cells", v=[ex, ey], types=[1])
        require(r["success"], f"set_cells: {r}")
        r, _ = s.call("get_cell", x=ex, y=ey)
        require(r["success"] and r["value"] == -1e6, f"get_cell on the new obstacle: {r}")
        s.spin(10)
        r, _ = s.call("set_cells", v=[ex, ey], types=[2])
        require(r["success"], f"set_cells: {r}")

        # The nav_core plugin's blocking solve (one launch of the solve kernel).
        t0 = time.perf_counter()
        node.planner.solve(max_iterations=cfg.solver.max_iterations)
        solved = node.planner.state
        require(bool(solved.converged), "session solve did not converge")
        solve_iterations = int(solved.iteration)
        solve_s = time.perf_counter() - t0

        gy, gx = np.argwhere(img == 255)[0]
        r, _ = s.call("get_cell", x=int(gx), y=int(gy))
        require(r["success"] and r["value"] == 0.0, f"get_cell on a goal: {r}")
        r, _ = s.call("get_cell", x=ex, y=ey)
        require(r["success"] and -1e6 < r["value"] < 0.0, f"get_cell on the freed cell: {r}")

        starts = golden_goal_starts(maze)
        require(len(starts) > 0, "no golden start reaches the goal")
        lengths = []
        path_s = []
        for x, y in starts:
            t0 = time.perf_counter()
            r, _ = s.call("compute_path", x=x, y=y, step_size=0.2, precision=0.4)
            path_s.append(time.perf_counter() - t0)
            require(r["success"], f"compute_path from ({x}, {y}): {r}")
            pts = np.asarray(r["path"], dtype=np.float32)[:, :2]
            st = node.planner.state
            require(path.path_reaches_goal(G.host_u(st), G.host_locked(st), pts),
                    f"path from ({x}, {y}) ends at {pts[-1].tolist()}, not in a goal")
            lengths.append(len(pts))
        r, _ = s.call("info")
        require(r["success"] and r["iteration"] >= solve_iterations, f"info: {r}")
        session_s = time.perf_counter() - t_start
    finally:
        client.close()
        server.close()
    launches = dict(hopper_sweep.launches)
    plain = dict(core.calls)
    require(all(v > 0 for v in launches.values()), f"a kernel never ran on the main path: {launches}")
    require(all(v == 0 for v in plain.values()), f"the plain version ran on the main path: {plain}")
    emit(phase="session", config="configs/maze.yaml", ticks=s.ticks, sweeps_per_tick=steps,
         ten_ticks_s=ten_ticks_s, solve_iterations=solve_iterations, solve_s=solve_s,
         paths=len(lengths), path_points=lengths, compute_path_s=path_s,
         session_s=session_s, launches=launches, plain_calls=plain)
    return launches


def phase_size(dev) -> dict:
    import epic_tpu_torch as T
    from epic_tpu_torch import maps
    from epic_tpu_torch.config import EpicConfig
    from epic_tpu_torch.solver import core, hopper_sweep

    side = SIZE_SIDE
    cfg = EpicConfig.load_yaml(ROOT / "configs" / "maze.yaml")
    img = maps.random_obstacles(side, side, seed=0)
    planner = T.Planner(cfg, device=dev)
    planner.state = T.from_occupancy_image(img, cfg.solver.epsilon, device=dev)
    plain = copy_state(planner.state)

    res = {}
    tick_k_ms = event_ms(lambda: planner.update(100))
    tick_p_ms = event_ms(lambda: res.__setitem__("p", core.update_n(plain, 100)))
    tick_err = compare(planner.state, res["p"], f"{side}^2 100-sweep tick")
    plain = res["p"]
    solve_k_ms = event_ms(lambda: planner.solve(max_iterations=2000))
    solve_p_ms = event_ms(lambda: res.__setitem__("p", core.solve(plain, STAGGER, 2000)))
    solve_err = compare(planner.state, res["p"], f"{side}^2 solve capped at 2000")
    solve_iterations = int(planner.state.iteration)

    k_state = {"s": planner.state}
    reps_k_ms = event_ms(lambda: k_state.__setitem__(
        "s", hopper_sweep.update_n(k_state["s"], 100)), reps=10)
    emit(phase="size", shape=[side, side], tick_sweeps=100, tick_max_abs_err=tick_err,
         tick_kernel_ms=tick_k_ms, tick_kernel_ms_mean10=reps_k_ms, tick_plain_ms=tick_p_ms,
         solve_iterations=solve_iterations, solve_max_abs_err=solve_err,
         solve_kernel_ms=solve_k_ms, solve_plain_ms=solve_p_ms,
         cell_updates_per_s_kernel=(side - 2) ** 2 / 2 * 100 / (reps_k_ms / 1e3))
    return {"tick_err": tick_err, "solve_err": solve_err}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    import epic_tpu_torch  # noqa: F401  (fails outside a checkout of the repo)

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    maze = np.load(GOLDENS / "maze.npz")
    built = phase_build()
    m = phase_maze(dev, maze)
    phase_goldens(dev, maze, m["maze_solved"])
    launches = phase_session(dev, maze)
    z = phase_size(dev)
    kernels = [
        dict(name="epic_sweep2d_chunk", route="cuda", source=SOURCE,
             replaces=REPLACES["epic_sweep2d_chunk"], launches=launches["epic_sweep2d_chunk"],
             max_abs_err=max(m["tick_err"], z["tick_err"]),
             ms=m["tick_ms"], plain_ms=m["tick_plain_ms"]),
        dict(name="epic_sweep2d_solve", route="cuda", source=SOURCE,
             replaces=REPLACES["epic_sweep2d_solve"], launches=launches["epic_sweep2d_solve"],
             max_abs_err=max(m["solve_err"], z["solve_err"]),
             ms=m["solve_ms"], plain_ms=m["solve_plain_ms"]),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(built["smi"], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
