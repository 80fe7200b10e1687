"""A small checkout for the benchmark's CPU tests: ``BENCHMARK.json`` with a
48 x 48 cut of the maze demo's map as its own configuration, both traffic
mixes made small, and the repository's metric readers."""

from __future__ import annotations

import json
import pathlib
import shutil
import time

import numpy as np

from benchmark import harness, inputs

REPO = pathlib.Path(__file__).resolve().parents[2]
TINY = {"goal_solve": {}, "fleet64": {"lanes": 4, "check_sample": 4}}


def tiny_checkout(root: pathlib.Path) -> pathlib.Path:
    """Write the small checkout under ``root``; cells ``tiny.goal_solve``
    and ``tiny.fleet64``."""
    (root / "benchmark").mkdir(parents=True)
    for d in ("metrics", "traffic"):
        shutil.copytree(REPO / "benchmark" / d, root / "benchmark" / d)
    for d in ("configs", "data"):
        (root / "benchmark" / d).mkdir()
    with np.load(REPO / "benchmark/data/maze_demo.npz") as data:
        img = data["img"][200:248, 200:248].copy()
    np.savez_compressed(root / "benchmark/data/tiny.npz", img=img)
    cfg = json.loads((REPO / "benchmark/configs/maze_demo.json").read_text())
    cfg.update(name="tiny", map=dict(file="benchmark/data/tiny.npz", key="img", height=48,
                                     width=48, sha256=inputs.image_sha256(img)))
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny", "source": "a cut of maze_demo",
                             "file": "benchmark/configs/tiny.json", "reduced": [],
                             "why": "CPU tests"})
    for mix, change in TINY.items():
        path = root / "benchmark/traffic" / f"{mix}.json"
        path.write_text(json.dumps(json.loads(path.read_text()) | change))
        bench["workloads"].append({"name": f"tiny.{mix}", "config": "tiny", "traffic": mix,
                                   "chips": 1, "why": "CPU tests"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if any(w.endswith("." + mix) for w in m.get("workloads", [])):
                m["workloads"].append(f"tiny.{mix}")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run_cpu(root: pathlib.Path, cell: str, seed: int = 12345678901, seconds: float = 0.5,
            traced: bool = False) -> dict:
    """One run of a cell of the small checkout on the CPU, past the look for
    a card."""
    import torch

    torch.set_num_threads(1)
    return harness.run(cell, seed, seconds, traced, catalog=harness.Catalog(root),
                       device=torch.device("cpu"), started=time.perf_counter())
