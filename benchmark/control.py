"""The control of the check: the reference put in the program's place and
computed one precision below the configurations' float32, in bfloat16.

    python -m benchmark.control --workload <cell> --seeds 1 2 3 [--cap N]

For a cell whose mix names no ``check``, for each seed it takes the first
``check_sample`` requests of that seed's stream
(:class:`benchmark.inputs.Stream`, which the drivers draw their requests
from; a run compares a uniform sample of its requests, drawn alike), solves
their goals in bfloat16 (capped at ``--cap`` sweeps), walks their starts on
those fields, and prints one JSON line of the numbers :mod:`benchmark.check`
reads for them beside its limits.

For a cell whose mix names a comparison of ``benchmark/checks``, whose
inputs follow from the program's run, each seed runs the cell's window
(``run_seconds`` long) as the benchmark does, and the
comparison's ``control`` puts its reference, in bfloat16, in the program's
place for the same answers; the line also gives the program's own numbers.

Each control must fail at least one limit. Runs on the card; the
benchmark's own runs never call it.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import torch

from . import check, harness, inputs, reference
from .harness import Catalog

ROOT = pathlib.Path(__file__).resolve().parents[1]


def control_numbers(catalog: Catalog, cell: str, seed: int, device, cap: int,
                    dtype=torch.bfloat16) -> dict:
    entry = catalog.cell(cell)
    config, traffic = catalog.config(entry["config"]), catalog.traffic(entry["traffic"])
    m = inputs.load_map(config, catalog.root)
    goals, starts = inputs.Stream(m, seed).take(0, traffic["check_sample"])
    goals = [tuple(int(v) for v in g) for g in goals]
    starts = [tuple(float(v) for v in s) for s in starts]
    ref = check.reference_fields(m.obstacle, goals, config, device)
    fields, _, sweeps = check.reference_fields(m.obstacle, goals, config, device, dtype, cap)
    args = check.walk_args(m.obstacle, traffic)
    walks = reference.walk(fields, ref[1], starts, *args)
    answers = [check.Answer(goal=g, start=s, field=fields[i], sweeps=int(sweeps[i]),
                            points=pts if outcome == reference.OK else None)
               for i, (g, s, (outcome, pts)) in enumerate(zip(goals, starts, walks))]
    numbers = check.compare(answers, m.obstacle, config, traffic, device, ref=ref)
    return {"cell": cell, "seed": seed, "dtype": str(dtype), "answers": len(answers),
            "control_sweeps": [int(v) for v in sweeps], "reference_sweeps":
            [int(v) for v in ref[2]],
            "numbers": numbers, "fails": not check.verdict(numbers),
            "limits": check.LIMITS}


def mix_control_numbers(catalog: Catalog, cell: str, seed: int, device, seconds: float,
                        dtype=torch.bfloat16) -> dict:
    """The control of a cell judged by a module of ``benchmark/checks``,
    beside the program's own numbers, from one run of its window."""
    entry = catalog.cell(cell)
    config, traffic = catalog.config(entry["config"]), catalog.traffic(entry["traffic"])
    judge = harness.comparison(traffic)
    record, answers, _ = harness.drive(cell, seed, seconds, False, catalog=catalog,
                                       device=device, started=time.perf_counter())
    obstacle = record.map.obstacle
    program = judge.compare(answers, obstacle, config, traffic, device)
    numbers = judge.control(answers, obstacle, config, traffic, device, dtype)
    return {"cell": cell, "seed": seed, "dtype": str(dtype), "answers": len(answers),
            "attempted": len(record.items), "failed": sum(not i["ok"] for i in record.items),
            "program": program, "program_passes": judge.verdict(program),
            "numbers": numbers, "fails": not judge.verdict(numbers), "limits": judge.LIMITS}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--cap", type=int, default=200_000)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    catalog = Catalog(ROOT)
    mix = catalog.traffic(catalog.cell(args.workload)["traffic"])
    for seed in args.seeds:
        t0 = time.perf_counter()
        if "check" in mix:
            out = mix_control_numbers(catalog, args.workload, seed, device,
                                      catalog.bench["run_seconds"])
        else:
            out = control_numbers(catalog, args.workload, seed, device, args.cap)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out, default=float), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
