"""The port's mesh across processes: two processes of 4 CPU shards each, one
2x4 mesh over torch.distributed (gloo standing in for the network between
hosts), as tests/test_multihost.py runs epic_tpu's; a 48 x 512 grid on the
resident route (``solve_resident``: the halos between the processes are its
copied neighbours, those within a process direct); in the 3D modes a
seeded volume on that plane mesh (``solve3d``) and on an 8 x 1 x 1 z mesh
through the resident route (``solve_resident_z``). Halos between the
processes travel by point-to-point sends, the check's delta by an
all_reduce(MAX), the readback by an all_gather. The result must be the
port's single-process core: the same bits and iterations, converged.

This file imports no JAX, but runs under tests/conftest.py with the rest.
"""

from __future__ import annotations

import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from epic_tpu_torch.parallel._mh_worker import RESIDENT_WIDTH, worker_state, worker_volume
from epic_tpu_torch.solver import core

REPO = pathlib.Path(__file__).resolve().parents[1]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("mode", ["solve", "update", "solve_resident", "solve3d",
                                  "solve_resident_z"])
def test_two_process_mesh_equals_core(tmp_path, mode):
    port = _free_port()
    out = tmp_path / "mh.npz"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "epic_tpu_torch.parallel._mh_worker",
         "--coordinator", f"localhost:{port}", "--num-processes", "2",
         "--process-id", str(pid), "--local-devices", "4", "--out", str(out), "--mode", mode],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for pid in (0, 1)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"

    d = np.load(out)
    assert int(d["process_count"]) == 2
    if mode == "update":
        ref = core.update_n(worker_state(), 137)
    elif mode == "solve_resident":
        ref = core.solve(worker_state(48, RESIDENT_WIDTH))
    else:
        ref = core.solve(worker_state() if mode == "solve" else worker_volume())
    assert int(d["iteration"]) == int(ref.iteration)
    assert bool(d["converged"]) == bool(ref.converged)
    if mode != "update":
        assert bool(d["converged"])
    np.testing.assert_array_equal(d["u"], ref.u.numpy())
    assert np.float32(d["delta"]) == ref.delta.numpy()
    assert torch.equal(torch.from_numpy(d["u"]), ref.u)
