"""Benchmark battery: the reference's batch harness on the port.

The twin of the JAX package's ``tools/batch_bench.py``, after the
reference's libepic/tests/batch/batch.py:105-164: for each domain, run
legacy SOR (omega 1.5) in float32 and float64 and the log-space solver on
the host, on the plain torch version and on the CUDA kernels, then emit a
CSV with ``Percent Valid, Time per Update, Time to Converge`` per solver at
the requested precision. The rows:

- ``cpu_sor_f32``, ``cpu_sor_f64``: ``solver.legacy.sor`` on the host;
- ``log_native_cpu``: the native C++ solve (``native.solve_2d``) on the host;
- ``log_torch_<device type>``: the plain ``solver.core.solve`` on the tool's
  device (``--backend auto`` or ``xla``);
- ``log_hopper_cuda``, or ``log_hopper_tile2d_cuda`` for a grid past the
  tile crossover (``solver.hopper_tile2d.use_tiles``): ``solver.solve_grid``,
  the kernels K2 ``epic_sweep2d_solve`` or ``epic_tile2d_solve``, timed on a
  second run after a warm-up (``--backend auto`` or ``pallas``, on a card);
- ``log_cascade_<device type>`` (``--cascade``): ``solver.cascade.
  solve_cascade`` with its coarse levels on the native solve, timed on a
  second run.

Domains are procedural stand-ins for the reference's PNG battery (the same
sizes), or the reference's own PNGs where ``$EPIC_REFERENCE_ROOT`` names its
tree (``maps.reference_map_path``). ``--sweep`` runs the reference's
visual-harness battery mode (libepic/tests/maps/maps.py:51-52,81-91):
epsilon in {1e-1, 1e-2, 1e-3} crossed with every solver.

The CSV goes to a temporary file beside ``--out`` and takes its name only
once it holds rows: a run that yields none exits nonzero and leaves no file.

Usage: python -m epic_tpu_torch.tools.batch_bench [--domain large_maze]
       [--epsilon 1e-3] [--sweep] [--backend auto|xla|pallas] [--cascade]
       [--out results.csv] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import csv
import os
import pathlib
import sys
import time

import numpy as np
import torch

from . import add_device_flag, resolve_device, synchronize

DOMAINS = {
    # name: (height, width) — sizes from BASELINE.md's workload table, the
    # reference battery's domain list (libepic/tests/batch/batch.py:41-49).
    "c_space": (274, 348),
    "small_maze": (242, 802),
    "umass": (700, 218),
    "large_maze": (962, 962),
    "small_mine": (954, 1280),
    "large_mine": (1419, 1735),
    "willow_garage": (1213, 1397),
    "maze": (482, 482),
}

HEADER = ["Domain", "Solver", "Epsilon", "Percent Valid", "Time per Update",
          "Time to Converge", "Iterations"]


def load_domain(name: str) -> np.ndarray:
    """The reference's PNG of ``name`` where its tree is named, with a goal
    pixel added mid-free-space where the PNG has none; else a recursive
    maze of the domain's size."""
    from .. import maps

    ref = maps.reference_map_path(f"{name}.png")
    if ref is not None:
        img = maps.load_png(ref)
        if not (img == 255).any():
            free = np.argwhere(img >= 250)
            if len(free) == 0:
                free = np.argwhere(img > 0)
            y, x = free[len(free) // 2]
            img = img.copy()
            img[y, x] = 255
        return img
    h, w = DOMAINS[name]
    return maps.recursive_maze(h, w, seed=0, corridor=max(6, min(h, w) // 40))


def _row(domain, label, epsilon, u, locked, goal, dt, iters):
    from .. import analysis

    pv = analysis.percent_valid(np.asarray(u), np.asarray(locked), goal)
    return [domain, label, epsilon, pv, dt / max(iters, 1), dt, iters]


def _timed_solve(solve, img, epsilon, device):
    """``solve(state)`` on a fresh state of ``img`` on ``device``, closed by
    reading the iteration back; returns ``(out, seconds, iterations)``."""
    from .. import grid

    st = grid.from_occupancy_image(img, epsilon, device=device)
    synchronize(device)
    t0 = time.perf_counter()
    out = solve(st)
    iters = int(out.iteration)  # device-to-host read: the completion barrier
    return out, time.perf_counter() - t0, iters


def _bench_epsilon(domain, img, goal, epsilon, cfg, rows, backend, device):
    from .. import grid, native, solver
    from ..solver import cascade, core, hopper_tile2d, legacy

    stagger, cap = cfg.solver.stagger, cfg.solver.max_iterations

    # --- legacy SOR on the host (float32 and float64) ----------------------
    for dtype, label in ((np.float32, "cpu_sor_f32"), (np.float64, "cpu_sor_f64")):
        u0, locked = legacy.from_image(img, dtype=dtype)
        t0 = time.perf_counter()
        u_out, iters = legacy.sor(u0, locked, epsilon=epsilon, omega=1.5, dtype=dtype)
        dt = time.perf_counter() - t0
        rows.append(_row(domain, label, epsilon, u_out, locked, goal, dt, iters))

    # --- log-space solver, native C++ on the host ---------------------------
    # The reference battery's "CPU log-GS" column (batch.py:137-144),
    # harmonic_complete_cpu; epic_solve2d_f32 is its protocol-exact twin.
    if native.available():
        st = grid.from_occupancy_image(img, epsilon, device="cpu")
        u0, locked0 = st.u.numpy(), st.locked.numpy()
        t0 = time.perf_counter()
        u_out, iters, _, _ = native.solve_2d(u0, locked0, epsilon=epsilon, stagger=stagger,
                                             max_iterations=cap)
        dt = time.perf_counter() - t0
        rows.append(_row(domain, "log_native_cpu", epsilon, u_out, locked0, goal, dt, iters))

    # --- log-space solver, the plain torch version on the device ------------
    if backend in ("auto", "xla"):
        out, dt, iters = _timed_solve(lambda st: core.solve(st, stagger, cap), img, epsilon,
                                      device)
        rows.append(_row(domain, f"log_torch_{device.type}", epsilon, out.u.cpu(),
                         out.locked.cpu(), goal, dt, iters))

    # --- log-space cascade (opt-in), coarse levels on the native solve ------
    if cfg.solver.cascade:
        coarse = cascade.native_solver if native.available() else None

        def casc(st):
            return cascade.solve_cascade(st, stagger=stagger, coarse_solver=coarse)[0]

        _timed_solve(casc, img, epsilon, device)  # warm-up
        out, dt, iters = _timed_solve(casc, img, epsilon, device)
        rows.append(_row(domain, f"log_cascade_{device.type}", epsilon, out.u.cpu(),
                         out.locked.cpu(), goal, dt, iters))

    # --- log-space solver, the CUDA kernels (K2 within the L2, the tile
    # solve past the crossover: the route the planner takes) ---------------
    if backend in ("auto", "pallas") and device.type == "cuda":
        label = ("log_hopper_tile2d" if hopper_tile2d.use_tiles(img.shape, device)
                 else "log_hopper")

        def kernels(st):
            return solver.solve_grid(st, stagger=stagger, max_iterations=cap)

        _timed_solve(kernels, img, epsilon, device)  # build, load, warm-up
        out, dt, iters = _timed_solve(kernels, img, epsilon, device)
        rows.append(_row(domain, f"{label}_{device.type}", epsilon, out.u.cpu(),
                         out.locked.cpu(), goal, dt, iters))


def run(domain: str, cfg, out_path: str | None, epsilons=None, *, backend: str = "auto",
        device: torch.device) -> list[list]:
    """The battery over ``domain`` (or every domain for "all") at
    ``epsilons`` (by default ``cfg.solver.epsilon``); ``backend`` picks the
    device rows as the JAX tool's flag does ("xla" the plain one, "pallas"
    the kernels', "auto" both). Writes the CSV to ``out_path`` (stdout when
    None) and returns its rows; with no row it writes nothing and exits
    nonzero."""
    if backend not in ("auto", "xla", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    domains = sorted(DOMAINS) if domain == "all" else [domain]
    out, tmp, writer = None, None, None
    done: list[list] = []
    try:
        for name in domains:
            img = load_domain(name)
            goal = img == 255
            rows: list[list] = []
            for epsilon in epsilons or [cfg.solver.epsilon]:
                _bench_epsilon(name, img, goal, epsilon, cfg, rows, backend, device)
            if rows and writer is None:
                if out_path:
                    target = pathlib.Path(out_path)
                    tmp = target.with_name(f".{target.name}.{os.getpid()}.tmp")
                    out = open(tmp, "w", newline="")
                else:
                    out = sys.stdout
                writer = csv.writer(out)
                writer.writerow(HEADER)
            for r in rows:
                writer.writerow(r)
            if out is not None:
                out.flush()
            done.extend(rows)
            print(f"# {name} done ({len(rows)} rows)", file=sys.stderr, flush=True)
        if not done:
            raise SystemExit("batch_bench: the battery gave no rows; no CSV written")
        if tmp is not None:
            out.close()
            os.replace(tmp, out_path)
            tmp = None
    finally:
        if tmp is not None:
            out.close()
            os.unlink(tmp)
    return done


def main(argv: list[str] | None = None) -> list[list]:
    from ..config import EpicConfig, SolverConfig

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--domain", default="maze", choices=sorted(DOMAINS) + ["all"])
    ap.add_argument("--epsilon", type=float, default=1e-3)
    ap.add_argument("--sweep", action="store_true",
                    help="epsilon battery {1e-1,1e-2,1e-3} x solvers "
                         "(reference maps.py batch mode)")
    ap.add_argument("--backend", default="auto", choices=["auto", "xla", "pallas"],
                    help="device rows: 'xla' the plain torch row, 'pallas' the kernels' "
                         "row, 'auto' both")
    ap.add_argument("--cascade", action="store_true",
                    help="add a log_cascade row (coarse-to-fine warm start)")
    ap.add_argument("--out", default=None)
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    # The port's SolverConfig takes only backend "auto": the flag stays with
    # the tool, which picks the rows by it.
    cfg = EpicConfig(solver=SolverConfig(epsilon=args.epsilon, cascade=args.cascade))
    return run(args.domain, cfg, args.out,
               epsilons=[1e-1, 1e-2, 1e-3] if args.sweep else None,
               backend=args.backend, device=device)


if __name__ == "__main__":
    main()
