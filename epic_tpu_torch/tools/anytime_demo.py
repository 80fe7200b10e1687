"""Anytime-navigation demo on the port: the launch-file workflow without ROS.

The twin of the JAX package's ``tools/anytime_demo.py``: it replicates
launch/epic_navigation_node_maze.launch (map_server + node at 50 steps per
100 ms tick) as a script: load a map (the reference's maze where
``$EPIC_REFERENCE_ROOT`` names its tree, else a procedural one), start the
anytime node on the device, script the rviz interactions (set a goal, relax,
request paths from several starts, relaxing more for those that fail), and
render the result to PNG. On a card the ticks run K1
(``epic_sweep2d_chunk``), or the 2D tiles for a grid past their crossover.

Usage: python -m epic_tpu_torch.tools.anytime_demo [--map maps/maze.yaml]
       [--ticks 40] [--out demo.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

from . import add_device_flag, resolve_device


def main(argv: list[str] | None = None) -> dict:
    """Run the demo; returns the sweeps of the first loop, the paths' pose
    counts and the starts left without a path."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", default=None,
                    help="YAML session config (configs/*.yaml); CLI flags override it")
    ap.add_argument("--map", default=None, help="map_server YAML or PNG")
    ap.add_argument("--ticks", type=int, default=40, help="anytime ticks (50 sweeps each)")
    ap.add_argument("--out", default="demo.png")
    ap.add_argument("--starts", type=int, default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    from .. import maps, viz
    from ..config import EpicConfig
    from ..errors import EpicError
    from ..planner import PlannerConfig
    from ..services import messages as msg
    from ..services.navigation_node import EpicNavigationNodeRviz

    cfg = EpicConfig.load_yaml(args.config) if args.config else EpicConfig()
    if args.map is None and cfg.map is not None:
        args.map = str(cfg.resolve_map_path())

    meta = maps.MapMeta()
    if args.map and args.map.endswith((".yaml", ".yml")):
        img, meta = maps.load_map_server_yaml(args.map)
    elif args.map:
        img = maps.load_png(args.map)
    else:
        ref = maps.reference_map_path("maze.png")
        img = maps.load_png(ref) if ref else maps.recursive_maze(482, 482, seed=0)

    h, w = img.shape
    epsilon = cfg.solver.epsilon if args.config else 1e-3
    if args.starts is None:
        args.starts = cfg.viz.starts
    node = EpicNavigationNodeRviz(
        PlannerConfig(epsilon=epsilon, steps_per_update=cfg.service.steps_per_update,
                      resolution=meta.resolution, origin_x=meta.origin_x,
                      origin_y=meta.origin_y, interpolation=cfg.viz.interpolation),
        update_rate=cfg.service.update_rate_hz, device=device)
    occ = np.zeros(img.shape, dtype=np.int8)
    occ[img == 0] = 100
    node.sub_occupancy_grid(msg.OccupancyGrid(w, h, meta.resolution, meta.origin_x,
                                              meta.origin_y, occ))

    # rviz verb: set a goal (the map's 255 pixel if present, else centre-ish).
    free_mask = (img != 0) & (img != 255)
    ys, xs = np.nonzero(img == 255)
    if len(ys):
        gy, gx = int(ys[0]), int(xs[0])
    else:
        free = np.argwhere(free_mask)
        gy, gx = map(int, free[len(free) // 2])
    wx, wy = node.planner.map_to_world(gx, gy)
    if not node.set_goal(msg.PoseStamped(wx, wy)):
        raise RuntimeError("set_goal failed")

    t0 = time.perf_counter()
    node.run(duration_s=0.0)  # no-op warm-up of the loop
    for _ in range(args.ticks):
        node.update()
    it = int(node.planner.state.iteration)  # device-to-host read: the barrier
    dt = time.perf_counter() - t0
    print(f"anytime loop: {it} sweeps over {args.ticks} ticks in {dt:.2f}s")

    # rviz verb: initialpose -> path, from several random free starts. The
    # anytime contract (harmonic_path_cpu.cpp:207-212): a failed path means
    # "not relaxed enough yet": keep relaxing and retry.
    free = np.argwhere(free_mask)
    rng = np.random.default_rng(0)
    pending = [tuple(map(int, free[i]))
               for i in rng.choice(len(free), size=args.starts, replace=False)]
    paths = []
    for _ in range(12):
        still = []
        for y, x in pending:
            swx, swy = node.planner.map_to_world(x, y)
            try:
                resp = node.set_start(msg.PoseStamped(swx, swy))
            except EpicError:
                still.append((y, x))
                continue
            pts = np.array([node.planner.world_to_map(p.x, p.y) for p in resp.path.poses],
                           dtype=np.float32)
            paths.append(pts)
            print(f"  start ({x},{y}): {len(pts)} poses "
                  f"(after {int(node.planner.state.iteration)} sweeps)")
        pending = still
        if not pending:
            break
        # Not relaxed enough for the remaining starts: run more ticks.
        for _ in range(args.ticks):
            node.update()
    for y, x in pending:
        print(f"  start ({x},{y}): no path after {int(node.planner.state.iteration)} sweeps")

    st = node.planner.state
    rgb = viz.render(st.u.cpu().numpy(), st.locked.cpu().numpy(), paths,
                     base_img=None if cfg.viz.show_field else img)
    viz.save_png(args.out, rgb)
    print(f"rendered {len(paths)} paths -> {args.out}")
    return dict(sweeps=it, loop_s=dt, poses=[len(p) for p in paths], pending=pending,
                final_sweeps=int(st.iteration))


if __name__ == "__main__":
    main()
