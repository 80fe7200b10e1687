"""A transport for the service plane: newline-delimited JSON over TCP.

The counterpart of ``epic_tpu.services.server`` (2D verbs). A
single-threaded event loop services socket requests between anytime update
chunks, so request handling and relaxation interleave exactly like the
reference node's spinOnce()/update(num_steps)
(src/epic_navigation_node_main.cpp:62-81).

Protocol: one JSON object per line.
  request:  {"srv": <name>, ...args}
  response: {"success": bool, ...payload}

Verbs: set_status, add_goals, remove_goals, get_cell, set_cells,
reset_free_cells, compute_path, occupancy_grid, info, metrics, and the
epic_tpu extensions get_field (potential-field window), get_map (cell-type
window), compute_paths (batched multi-start paths) and the 3D family
(occupancy_volume, add_goals_3d, remove_goals_3d, get_cell_3d, set_cells_3d,
reset_free_cells_3d, set_status_3d, compute_path_3d, compute_paths_3d),
which drives an independent volume session
(:class:`epic_tpu_torch.planner3d.VolumePlanner`, on the 2D planner's
device) that relaxes in the same anytime loop, and the sampling_* family
(sampling_occupancy, sampling_add_goals, sampling_remove_goals,
sampling_set_cells, sampling_compute_path) driving the sampling-based node
(the reference's unbuilt OMPL node,
:mod:`epic_tpu_torch.services.sampling_node`, on the host) with a per-tick
anytime budget.

Run:   python -m epic_tpu_torch.services.server --port 7171 --map maze.png
       [--host 0.0.0.0] [--log-json] [--mesh]   (--mesh: the grid sharded
       over every visible card, planner_mesh.MeshPlanner)
Client: EpicClient (below) or any JSON-capable peer.
"""

from __future__ import annotations

import argparse
import json
import logging
import selectors
import socket

import numpy as np

from .. import constants as C
from .. import grid as G
from ..errors import EpicError
from ..maps import MapMeta
from ..metrics import MetricsRegistry
from ..planner3d import VolumePlanner, VolumePlannerConfig
from . import messages as msg
from .navigation_node import EpicNavigationNodeRviz
from .sampling_node import EpicNavigationNodeSampling

logger = logging.getLogger("epic_tpu_torch.server")

VERBS_3D = frozenset({
    "add_goals_3d", "remove_goals_3d", "get_cell_3d", "set_cells_3d",
    "reset_free_cells_3d", "set_status_3d", "compute_path_3d", "compute_paths_3d",
})

VERBS_SAMPLING = frozenset({
    "sampling_add_goals", "sampling_remove_goals", "sampling_set_cells",
    "sampling_compute_path",
})


def _window(req: dict, h: int, w: int) -> tuple[int, int, int, int]:
    """The [y0:y1, x0:x1] window a get_field/get_map request names, clamped
    to the map."""
    x0 = max(0, int(req.get("x0", 0)))
    y0 = max(0, int(req.get("y0", 0)))
    x1 = min(w, int(req.get("x1", w)))
    y1 = min(h, int(req.get("y1", h)))
    return y0, y1, x0, x1


class EpicServiceServer:
    def __init__(
        self,
        node: EpicNavigationNodeRviz,
        host: str = "127.0.0.1",
        port: int = 7171,
    ):
        self.node = node
        # The 3D session, created by the first occupancy_volume ingest on
        # the 2D planner's device; ticks in spin_once beside the 2D planner.
        self.volume_planner: VolumePlanner | None = None
        # The sampling-planner session, created by the first
        # sampling_occupancy ingest (the reference's OMPL node as a service
        # family); its anytime budget a tick mirrors ompl_planner->solve(t).
        self.sampling_node: EpicNavigationNodeSampling | None = None
        self.sampling_budget_s = 0.02
        self.sel = selectors.DefaultSelector()
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.setblocking(False)
        self.sel.register(self.listener, selectors.EVENT_READ, None)
        self.port = self.listener.getsockname()[1]
        self._buffers: dict[socket.socket, bytes] = {}
        # Outgoing bytes per connection, flushed on EVENT_WRITE readiness:
        # sockets are non-blocking, so a large response (multi-MB path JSON)
        # can only be partially accepted by the kernel buffer — the tail must
        # survive until the socket drains, never crash the loop.
        self._out: dict[socket.socket, bytes] = {}
        self.metrics = MetricsRegistry()

    # -- request dispatch --------------------------------------------------

    def _dispatch(self, req: dict) -> dict:
        """Handle one request, recording per-verb call/error counters and
        wall-time latency in :attr:`metrics` (queryable via ``metrics``)."""
        srv = req.get("srv")
        self.metrics.inc(f"verb.{srv}.calls")
        with self.metrics.timed(f"verb.{srv}"):
            resp = self._handle(srv, req)
        if not resp.get("success", False):
            self.metrics.inc(f"verb.{srv}.errors")
        return resp

    def _handle(self, srv, req: dict) -> dict:
        node = self.node
        try:
            if srv == "set_status":
                r = node.srv_set_status(msg.SetStatusRequest(bool(req["paused"])))
                return {"success": r.success}
            if srv in ("add_goals", "remove_goals"):
                goals = [msg.PoseStamped(float(x), float(y)) for x, y in req["goals"]]
                handler = node.srv_add_goals if srv == "add_goals" else node.srv_remove_goals
                return {"success": handler(msg.ModifyGoalsRequest(goals)).success}
            if srv == "get_cell":
                r = node.srv_get_cell(msg.GetCellRequest(int(req["x"]), int(req["y"])))
                return {"success": r.success, "value": r.value}
            if srv == "set_cells":
                r = node.srv_set_cells(
                    msg.SetCellsRequest([int(v) for v in req["v"]],
                                        [int(t) for t in req["types"]])
                )
                return {"success": r.success}
            if srv == "reset_free_cells":
                return {"success": node.srv_reset_free_cells(
                    msg.ResetFreeCellsRequest()).success}
            if srv == "compute_path":
                r = node.srv_compute_path(
                    msg.ComputePathRequest(
                        start=msg.PoseStamped(float(req["x"]), float(req["y"])),
                        step_size=float(req.get("step_size", 0.05)),
                        precision=float(req.get("precision", 0.5)),
                        max_length=int(req.get("max_length", 0)),
                    )
                )
                return {
                    "success": True,
                    "path": [[p.x, p.y, p.yaw] for p in r.path.poses],
                }
            if srv == "occupancy_grid":
                data = np.asarray(req["data"], dtype=np.int8)
                node.sub_occupancy_grid(
                    msg.OccupancyGrid(
                        int(req["width"]), int(req["height"]),
                        float(req.get("resolution", 1.0)),
                        float(req.get("origin_x", 0.0)),
                        float(req.get("origin_y", 0.0)),
                        data,
                    )
                )
                return {"success": True}
            if srv == "compute_paths":
                starts = [(float(x), float(y)) for x, y in req["starts"]]
                results = node.planner.compute_paths_batch(
                    starts,
                    step_size=float(req.get("step_size", 0.05)),
                    cd_precision=float(req.get("precision", 0.5)),
                    max_steps=int(req.get("max_steps", 4096)),
                    # None -> the session's configured interpolation mode.
                    mode=req.get("mode"),
                )
                return {
                    "success": True,
                    "paths": [None if poses is None else [[p.x, p.y, p.yaw] for p in poses]
                              for poses in results],
                }
            if srv == "occupancy_volume":
                d, h, w = int(req["depth"]), int(req["height"]), int(req["width"])
                data = np.asarray(req["data"], dtype=np.int8).reshape(d, h, w)
                if self.volume_planner is None:
                    cfg = node.planner.config
                    self.volume_planner = VolumePlanner(
                        VolumePlannerConfig(epsilon=cfg.epsilon,
                                            steps_per_update=cfg.steps_per_update),
                        device=node.planner.device)
                origin = req.get("origin")
                self.volume_planner.update_occupancy(
                    data,
                    resolution=req.get("resolution"),
                    origin=tuple(map(float, origin)) if origin else None,
                )
                return {"success": True}
            if srv in VERBS_3D:
                return self._handle_3d(srv, req)
            if srv == "sampling_occupancy":
                h, w = int(req["height"]), int(req["width"])
                data = np.asarray(req["data"], dtype=np.int8).reshape(h, w)
                if self.sampling_node is None:
                    self.sampling_node = EpicNavigationNodeSampling(
                        algorithm=int(req.get("algorithm", 0)), seed=req.get("seed"))
                origin = req.get("origin") or (0.0, 0.0)
                self.sampling_node.sub_occupancy_grid(msg.OccupancyGrid(
                    w, h, float(req.get("resolution", 1.0)),
                    float(origin[0]), float(origin[1]), data))
                return {"success": True}
            if srv in VERBS_SAMPLING:
                return self._handle_sampling(srv, req)
            if srv == "get_field":
                # A window of the potential field (the reference only exposes
                # per-cell GetCell; remote UIs need the array).
                st = node.planner.state
                if st is None:
                    return {"success": False, "error": "planner not initialized"}
                y0, y1, x0, x1 = _window(req, *st.u.shape)
                u = G.host_u(st)[y0:y1, x0:x1]
                return {
                    "success": True,
                    "x0": x0, "y0": y0,
                    "width": int(u.shape[1]), "height": int(u.shape[0]),
                    "u": np.round(u.astype(np.float64), 6).tolist(),
                }
            if srv == "get_map":
                # Cell-type view (0 obstacle / 128 free / 255 goal), same
                # window semantics — enough to redraw the occupancy layer.
                st = node.planner.state
                if st is None:
                    return {"success": False, "error": "planner not initialized"}
                y0, y1, x0, x1 = _window(req, *st.u.shape)
                u = G.host_u(st)[y0:y1, x0:x1]
                locked = G.host_locked(st)[y0:y1, x0:x1]
                img = np.full(u.shape, 128, np.int32)
                img[locked & (u == float(C.LOG_SPACE_OBSTACLE))] = 0
                img[locked & (u == float(C.LOG_SPACE_GOAL))] = 255
                return {
                    "success": True,
                    "x0": x0, "y0": y0,
                    "width": int(img.shape[1]), "height": int(img.shape[0]),
                    "cells": img.tolist(),
                }
            if srv == "info":
                st = node.planner.state
                out = {
                    "success": True,
                    "initialized": st is not None,
                    "shape": list(st.u.shape) if st is not None else None,
                    "iteration": int(st.iteration) if st is not None else 0,
                    "delta": float(st.delta) if st is not None else None,
                    "paused": node.planner.paused,
                }
                vol = self.volume_planner
                if vol is not None and vol.state is not None:
                    out["volume"] = {
                        "shape": list(vol.state.u.shape),
                        "iteration": int(vol.state.iteration),
                        "delta": float(vol.state.delta),
                        "paused": vol.paused,
                    }
                sn = self.sampling_node
                if sn is not None:
                    out["sampling"] = {
                        "algorithm": sn.algorithm,
                        "goal": list(sn.goal) if sn.goal else None,
                        "solved": bool(sn.planner.solved) if sn.planner else False,
                        "iterations": sn.planner.iterations if sn.planner else 0,
                    }
                return out
            if srv == "metrics":
                return {"success": True, **self.metrics.snapshot()}
            return {"success": False, "error": f"unknown srv {srv!r}"}
        except EpicError as e:
            return {"success": False, "error": str(e)}
        except (KeyError, ValueError, TypeError) as e:
            return {"success": False, "error": f"bad request: {e}"}

    def _handle_sampling(self, srv: str, req: dict) -> dict:
        """The sampling_* verbs after sampling_occupancy, on its session."""
        sn = self.sampling_node
        if sn is None:
            return {"success": False,
                    "error": "no sampling session (send sampling_occupancy first)"}
        if srv in ("sampling_add_goals", "sampling_remove_goals"):
            goals = [msg.PoseStamped(float(x), float(y)) for x, y in req["goals"]]
            handler = sn.srv_add_goals if srv == "sampling_add_goals" else sn.srv_remove_goals
            return {"success": handler(msg.ModifyGoalsRequest(goals)).success}
        if srv == "sampling_set_cells":
            r = sn.srv_set_cells(msg.SetCellsRequest([int(v) for v in req["v"]],
                                                     [int(t) for t in req["types"]]))
            return {"success": r.success}
        x, y = float(req["start"][0]), float(req["start"][1])
        r = sn.srv_compute_path(msg.ComputePathRequest(start=msg.PoseStamped(x, y)))
        return {
            "success": True,
            "solved": bool(sn.planner.solved) if sn.planner else False,
            "iterations": sn.planner.iterations if sn.planner else 0,
            "path": [[p.x, p.y, p.yaw] for p in r.path.poses],
        }

    def _handle_3d(self, srv: str, req: dict) -> dict:
        """The *_3d verbs on the volume session."""
        vol = self.volume_planner
        if vol is None:
            return {"success": False, "error": "no 3D session (send occupancy_volume first)"}
        if srv in ("add_goals_3d", "remove_goals_3d"):
            pts = [tuple(map(float, g)) for g in req["goals"]]
            handler = vol.add_goals if srv == "add_goals_3d" else vol.remove_goals
            return {"success": handler(pts)}
        if srv == "get_cell_3d":
            return {"success": True,
                    "value": vol.get_cell(int(req["x"]), int(req["y"]), int(req["z"]))}
        if srv == "set_cells_3d":
            v = [int(x) for x in req["v"]]
            xyz = list(zip(v[0::3], v[1::3], v[2::3]))
            return {"success": vol.set_cells(xyz, [int(t) for t in req["types"]])}
        if srv == "reset_free_cells_3d":
            return {"success": vol.reset_free_cells()}
        if srv == "set_status_3d":
            return {"success": vol.set_status(bool(req["paused"]))}
        if srv == "compute_paths_3d":
            results = vol.compute_paths_batch(
                [tuple(map(float, p)) for p in req["starts"]],
                step_size=float(req.get("step_size", 0.05)),
                cd_precision=float(req.get("precision", 0.5)),
                max_steps=int(req.get("max_steps", 4096)),
            )
            return {
                "success": True,
                "paths": [None if poses is None
                          else [[p.x, p.y, p.z, p.yaw, p.pitch] for p in poses]
                          for poses in results],
            }
        poses = vol.compute_path(
            (float(req["x"]), float(req["y"]), float(req["z"])),
            step_size=float(req.get("step_size", 0.05)),
            cd_precision=float(req.get("precision", 0.5)),
            max_length=int(req["max_length"]) if req.get("max_length") else None,
        )
        return {"success": True, "path": [[p.x, p.y, p.z, p.yaw, p.pitch] for p in poses]}

    # -- event loop --------------------------------------------------------

    def _close_conn(self, sock: socket.socket) -> None:
        logger.info("client disconnected")
        self.sel.unregister(sock)
        self._buffers.pop(sock, None)
        self._out.pop(sock, None)
        sock.close()

    def _update_events(self, sock: socket.socket) -> None:
        events = selectors.EVENT_READ
        if self._out.get(sock):
            events |= selectors.EVENT_WRITE
        self.sel.modify(sock, events, None)

    def _flush(self, sock: socket.socket) -> None:
        """Write as much pending output as the kernel accepts; keep the tail."""
        pending = self._out.get(sock, b"")
        while pending:
            try:
                n = sock.send(pending)
            except BlockingIOError:
                break
            except (BrokenPipeError, ConnectionResetError):
                self._close_conn(sock)
                return
            pending = pending[n:]
        self._out[sock] = pending
        self._update_events(sock)

    def _service_sockets(self) -> None:
        for key, mask in self.sel.select(timeout=0):
            sock = key.fileobj
            if sock is self.listener:
                conn, addr = self.listener.accept()
                conn.setblocking(False)
                self.sel.register(conn, selectors.EVENT_READ, None)
                self._buffers[conn] = b""
                self._out[conn] = b""
                logger.info("client connected: %s", addr)
                continue
            if mask & selectors.EVENT_WRITE:
                self._flush(sock)
                if sock not in self._buffers:  # closed during flush
                    continue
            if not (mask & selectors.EVENT_READ):
                continue
            try:
                data = sock.recv(1 << 20)
            except BlockingIOError:
                # Spurious wakeup — the connection is healthy, don't drop it.
                continue
            except ConnectionResetError:
                data = b""
            if not data:
                self._close_conn(sock)
                continue
            self._buffers[sock] += data
            while b"\n" in self._buffers[sock]:
                line, self._buffers[sock] = self._buffers[sock].split(b"\n", 1)
                if not line.strip():
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    resp = {"success": False, "error": f"bad json: {e}"}
                else:
                    resp = self._dispatch(req)
                self._out[sock] = self._out.get(sock, b"") + json.dumps(resp).encode() + b"\n"
            if self._out.get(sock):
                self._flush(sock)

    def spin_once(self, num_steps: int | None = None) -> None:
        """One tick: service pending requests, then one relaxation chunk —
        the spinOnce()/update() interleave. A live 3D session relaxes in the
        same tick, and a live sampling session searches for
        ``sampling_budget_s``."""
        self._service_sockets()
        self.metrics.inc("ticks")
        with self.metrics.timed("tick.update"):
            self.node.update(num_steps)
            if self.volume_planner is not None:
                self.volume_planner.update(num_steps)
            if self.sampling_node is not None:
                # ompl_planner->solve(t) per tick
                # (epic_navigation_node_ompl.cpp:110-119).
                self.sampling_node.update(budget_s=self.sampling_budget_s)

    def run_forever(self) -> None:  # pragma: no cover - long-running
        while True:
            self.spin_once()

    def close(self) -> None:
        for sock in list(self._buffers):
            self.sel.unregister(sock)
            sock.close()
        self._buffers.clear()
        self._out.clear()
        self.sel.unregister(self.listener)
        self.listener.close()


class EpicClient:
    """Minimal blocking client for EpicServiceServer."""

    def __init__(self, host: str = "127.0.0.1", port: int = 7171, timeout: float = 30.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self._buf = b""

    def call(self, srv: str, **args) -> dict:
        self.sock.sendall(json.dumps({"srv": srv, **args}).encode() + b"\n")
        while b"\n" not in self._buf:
            data = self.sock.recv(1 << 20)
            if not data:
                raise ConnectionError("server closed")
            self._buf += data
        line, self._buf = self._buf.split(b"\n", 1)
        return json.loads(line)

    def close(self) -> None:
        self.sock.close()


def ingest_map(node: EpicNavigationNodeRviz, img: np.ndarray, meta: MapMeta | None = None) -> None:
    """Load a map image into the node as the server's startup does: dark
    (0) pixels become occupied, everything else free, then the image's 255
    pixels are added as goals."""
    meta = meta or MapMeta()
    occ = np.zeros(img.shape, dtype=np.int8)
    occ[img == 0] = 100
    node.sub_occupancy_grid(
        msg.OccupancyGrid(img.shape[1], img.shape[0], meta.resolution,
                          meta.origin_x, meta.origin_y, occ)
    )
    ys, xs = np.nonzero(img == 255)
    if len(ys):
        node.srv_add_goals(
            msg.ModifyGoalsRequest(
                [msg.PoseStamped(float(x), float(y)) for y, x in zip(ys, xs)]
            )
        )


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    """The command line of :func:`main`."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default=None,
                    help="YAML session config (configs/*.yaml); explicit CLI "
                         "flags override it")
    ap.add_argument("--host", default=None)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--map", default=None,
                    help="map_server YAML or PNG map to load at startup")
    ap.add_argument("--epsilon", type=float, default=None)
    ap.add_argument("--steps-per-update", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the grid: a CUDA device runs the "
                         "kernels, 'cpu' the plain torch version")
    ap.add_argument("--mesh", action="store_true",
                    help="run the node on planner_mesh.MeshPlanner: the grid "
                         "lives sharded across every visible card (resident "
                         "ticks, edits and solves); --device is then unused")
    ap.add_argument("--log-json", action="store_true",
                    help="emit structured JSON-lines logs")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> None:  # pragma: no cover - CLI
    from .. import maps
    from ..config import EpicConfig
    from ..metrics import configure_logging

    args = parse_args(argv)
    configure_logging(json_lines=args.log_json)

    cfg = EpicConfig.load_yaml(args.config) if args.config else EpicConfig()
    if args.epsilon is not None:
        cfg.solver.epsilon = args.epsilon
    if args.host is not None:
        cfg.service.host = args.host
    if args.port is not None:
        cfg.service.port = args.port
    if args.steps_per_update is not None:
        cfg.service.steps_per_update = args.steps_per_update

    if args.mesh:
        from ..planner_mesh import MeshPlanner

        node = EpicNavigationNodeRviz(cfg, update_rate=cfg.service.update_rate_hz,
                                      planner=MeshPlanner(cfg, mesh=None))
    else:
        node = EpicNavigationNodeRviz(cfg, update_rate=cfg.service.update_rate_hz,
                                      device=args.device)
    map_path = args.map
    if map_path is None and cfg.map is not None:
        map_path = str(cfg.resolve_map_path())
    if map_path:
        meta = MapMeta()
        if map_path.endswith((".yaml", ".yml")):
            img, meta = maps.load_map_server_yaml(map_path)
        else:
            img = maps.load_png(map_path)
        ingest_map(node, img, meta)
    server = EpicServiceServer(node, cfg.service.host, cfg.service.port)
    print(f"epic_tpu_torch service server on {cfg.service.host}:{server.port}",
          flush=True)
    server.run_forever()


if __name__ == "__main__":
    main()
