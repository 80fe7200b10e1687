"""Precision-comparison overlay on the port.

The twin of the JAX package's ``tools/compare_precision.py``, after the
reference's libepic/tests/batch/compare_precision.py:192-252: solve one map
with (a) float SOR, (b) double SOR, (c) the log-space solver, compute each
solution's valid region (gradient alive and reachable from the goal), and
overlay them as gray levels in one image:

  level 60  — valid only under log-space
  level 90  — also valid under double SOR
  level 120 — also valid under float SOR (i.e. valid everywhere)

plus obstacles black and goals white. Writes a PNG and prints the shares.
The SOR fields come from ``solver.legacy.sor`` on the host, the log-space
field from ``solver.solve_grid`` on the device: the CUDA kernels on a card.

Usage: python -m epic_tpu_torch.tools.compare_precision [--domain maze]
       [--epsilon 1e-4] [--out overlay.png] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from . import add_device_flag, resolve_device
from .batch_bench import load_domain


def regions(img: np.ndarray, epsilon: float, device: torch.device) -> dict[str, np.ndarray]:
    """Each solver's valid free cells: "sor_f32", "sor_f64" and "log"."""
    from .. import analysis, grid, solver
    from ..solver import legacy

    goal = img == 255
    out = {}
    for dtype, name in ((np.float32, "sor_f32"), (np.float64, "sor_f64")):
        u0, locked = legacy.from_image(img, dtype=dtype)
        u_out, _ = legacy.sor(u0, locked, epsilon=epsilon, omega=1.5, dtype=dtype)
        grad_ok = analysis.valid_gradient_mask(u_out) & ~locked
        out[name] = analysis.reachable_from(goal, grad_ok | goal) & ~locked

    solved = solver.solve_grid(grid.from_occupancy_image(img, epsilon, device=device))
    u_log = solved.u.cpu().numpy()
    locked = solved.locked.cpu().numpy()
    grad_ok = analysis.valid_gradient_mask(u_log) & ~locked
    out["log"] = analysis.reachable_from(goal, grad_ok | goal) & ~locked
    return out


def overlay(img: np.ndarray, reg: dict[str, np.ndarray]) -> np.ndarray:
    """The gray-level overlay of :func:`regions` as an RGB image."""
    goal = img == 255
    gray = np.zeros(img.shape, dtype=np.uint8)
    gray[reg["log"]] = 60
    gray[reg["log"] & reg["sor_f64"]] = 90
    gray[reg["log"] & reg["sor_f64"] & reg["sor_f32"]] = 120
    gray[img == 0] = 0
    gray[goal] = 255
    return np.stack([gray] * 3, axis=-1)


def main(argv: list[str] | None = None) -> dict[str, float]:
    """Write the overlay and print each region's share of the free cells;
    returns the shares."""
    from .. import viz

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--domain", default="maze")
    ap.add_argument("--epsilon", type=float, default=1e-4)
    ap.add_argument("--out", default="precision_overlay.png")
    add_device_flag(ap)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    img = load_domain(args.domain)
    reg = regions(img, args.epsilon, device)
    viz.save_png(args.out, overlay(img, reg))
    n_free = (~((img == 255) | (img == 0))).sum()
    shares = {}
    for name, region in reg.items():
        shares[name] = float(region.sum() / n_free)
        print(f"{name}: {shares[name]:.3%} of free cells valid")
    print(f"overlay written to {args.out}")
    return shares


if __name__ == "__main__":
    main()
