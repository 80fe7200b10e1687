"""epic_tpu_torch.tools.scaling_bench on a virtual CPU mesh against the JAX
package's tools/scaling_bench.py: every row's relaxed field against
epic_tpu.parallel.sharded.update_n's on the same image and mesh shape
(conftest's eight JAX CPU devices) within the cross-backend tolerance of
tests/test_torch_sharded.py, the same bits across the port's shard counts
(the mesh's result does not depend on the cut), and the CSV's columns the
JAX tool's."""

import csv
import importlib
import os
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

jscaling = importlib.import_module("scaling_bench")

import epic_tpu  # noqa: E402
from epic_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from epic_tpu.parallel import sharded as jsharded  # noqa: E402
from epic_tpu_torch import maps  # noqa: E402
from epic_tpu_torch.tools import scaling_bench  # noqa: E402


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """Each test on one torch thread: several test processes share the
    host's cores, and torch's OpenMP pool, which spins between the many
    small ops of a CPU relaxation, slows such runs twentyfold when every
    process keeps a thread a core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FIELD = dict(rtol=2e-6, atol=1e-3)
CPU = torch.device("cpu")


@pytest.mark.parametrize("kernel", ["auto", "xla"])
def test_rows_match_the_jax_sharded_solver(kernel, capsys):
    fields = {}
    rows = scaling_bench.run([64], 20, [1, 2, 4, 8], kernel, 16, CPU, fields=fields)
    out = capsys.readouterr().out
    assert "devices  mesh      sweeps/s" in out and "kernel=" + kernel in out
    assert [r["devices"] for r in rows] == [1, 2, 4, 8]
    assert [r["mesh"] for r in rows] == ["1x1", "1x2", "2x2", "2x4"]
    assert rows[0]["throughput_vs_1dev"] == 1.0 and rows[0]["efficiency_vs_first"] == 1.0
    img = maps.random_obstacles(64, 64, density=0.1, seed=0)
    one = fields[(64, 1)]
    for r in rows:
        n = r["devices"]
        got = fields[(64, n)]
        assert torch.equal(got.u, one.u) and int(got.iteration) == 20
        my, mx = (int(v) for v in r["mesh"].split("x"))
        mesh = jmake_mesh((my, mx), devices=np.asarray(jax.devices()[:n]))
        ref = jsharded.update_n(epic_tpu.from_occupancy_image(img, epsilon=1e-6), 20, mesh,
                                chunk_depth=16, kernel="auto")
        np.testing.assert_allclose(got.u.numpy(), np.asarray(ref.u), **FIELD)
        assert r["caveat"].startswith("virtual-cpu-shards-share-")
        assert r["backend"] == "cpu" and r["kernel"] == kernel and r["sweeps"] == 20


def test_csv_columns_match_the_jax_tool(tmp_path, monkeypatch):
    monkeypatch.setenv("XLA_FLAGS", os.environ.get("XLA_FLAGS", ""))
    jcsv, tcsv = tmp_path / "jax.csv", tmp_path / "torch.csv"
    monkeypatch.setattr(sys, "argv", ["scaling_bench.py", "--sizes", "32", "--sweeps", "4",
                                      "--devices", "8", "--cpu", "--csv", str(jcsv)])
    jscaling.main()
    rows = scaling_bench.main(["--sizes", "32", "--sweeps", "4", "--devices", "1", "2",
                               "--device", "cpu", "--csv", str(tcsv)])
    jhead = next(csv.reader(open(jcsv)))
    thead = next(csv.reader(open(tcsv)))
    assert thead == jhead == list(rows[0])
    assert len(list(csv.DictReader(open(tcsv)))) == 2
    # Appending keeps one header.
    scaling_bench.main(["--sizes", "32", "--sweeps", "4", "--devices", "1", "--device", "cpu",
                        "--csv", str(tcsv)])
    body = list(csv.reader(open(tcsv)))
    assert body[0] == jhead and len(body) == 4


def test_efficiency_assertion_is_skipped_on_a_virtual_mesh(capsys):
    scaling_bench.main(["--sizes", "32", "--sweeps", "4", "--devices", "1", "2",
                        "--assert-efficiency", "0.99", "--device", "cpu"])
    assert "efficiency assertion skipped: virtual mesh" in capsys.readouterr().out
