"""Run one cell of the benchmark on the card and print its result.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown`` of the device's time, and last
``compared``, each number the check compared beside its limit. The same
numbers are the last lines of standard error.

Without a CUDA card, or with fewer cards than the cell asks for, the run
prints no result and exits 2. If JAX, Flax or the JAX package is loaded once
the window has closed, it exits 3. The program's build caches live in
``build/`` inside the checkout, at fixed paths.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()   # set-up is timed from here, before torch loads

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# Top-level module names that must not be loaded, compared whole: the port's
# own name begins with the JAX package's.
FORBIDDEN = ("jax", "jaxlib", "flax", "epic_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.partition(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def assemble(out: dict, kind: str, chips: int, limit: str) -> dict:
    """The result line's object from :func:`benchmark.harness.run`'s dict:
    the driver's keys first, ``device`` with the card's name and count,
    ``compared`` last."""
    out = dict(out)
    dev = {"platform": "gpu", "kind": kind, "count": chips,
           "memory_peak_bytes": out.pop("memory_peak_bytes"), "power_limit": limit}
    if "busy_s" in out:
        dev["busy_s"] = out.pop("busy_s")
        dev["window_s"] = out.pop("window_s")
    compared = out.pop("compared")
    result = {k: out.pop(k) for k in ("correct", "attempted", "failed", "metrics")}
    result["device"] = dev
    result.update(out)
    result["compared"] = compared
    return result


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m benchmark.run", description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / "benchmark" / sub)
    import torch

    from .harness import Catalog, run

    catalog = Catalog(ROOT)
    chips = catalog.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace), catalog=catalog,
              device=device, started=STARTED)
    limit = power_limit()   # read after the run, so it counts in no set-up
    found = forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    result = assemble(out, torch.cuda.get_device_name(device), chips, limit)
    print(f"benchmark: {args.workload} seed {args.seed}: {result['checked']} answers "
          f"compared, correct {result['correct']}", file=sys.stderr)
    print("setup " + " ".join(f"{k} {v:.3f}s" for k, v in result["setup_parts"].items()),
          file=sys.stderr)
    for k, v in result["compared"].items():
        print(f"{k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
