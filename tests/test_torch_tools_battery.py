"""epic_tpu_torch.tools.batch_bench (the percent-valid battery) against the
JAX package's tools/batch_bench.py on the same tiny domain, on the CPU.

Both tools run on a 48^2 recursive maze patched into their DOMAINS, as
tests/test_batch_bench_tool.py does, at epsilon 1e-2. The host rows (legacy
SOR in float32 and float64, the native log-space solve) must equal the JAX
tool's in percent-valid and iterations: the same protocol, and here the same
library, since no test calls epic_tpu.native (the JAX tool is handed the
port's). The plain row ``log_torch_cpu`` is held to ``log_xla_cpu``:
percent-valid equal, iterations equal or a whole number of stagger cycles
apart (ROADMAP R6: the two CPU backends' fields differ by an ulp, which can
move the deciding check by one cycle).
"""

import csv
import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

jbatch = importlib.import_module("batch_bench")

from epic_tpu import native as jnative  # noqa: E402
from epic_tpu.config import EpicConfig as JEpicConfig  # noqa: E402
from epic_tpu.config import SolverConfig as JSolverConfig  # noqa: E402
from epic_tpu_torch import constants as C  # noqa: E402
from epic_tpu_torch import maps, native  # noqa: E402
from epic_tpu_torch.tools import batch_bench  # noqa: E402


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


HOST_ROWS = ("cpu_sor_f32", "cpu_sor_f64", "log_native_cpu")


@pytest.fixture()
def tiny(monkeypatch):
    img = maps.recursive_maze(48, 48, seed=4)
    for mod in (jbatch, batch_bench):
        monkeypatch.setitem(mod.DOMAINS, "tiny", img.shape)
        monkeypatch.setattr(mod, "load_domain", lambda name: img)
    for name in ("available", "solve_2d", "legacy_sor_2d"):
        monkeypatch.setattr(jnative, name, getattr(native, name))
    assert native.available()
    return img


def _rows(path):
    return {r["Solver"]: r for r in csv.DictReader(open(path))}


def _same_cycle_class(a: int, b: int) -> bool:
    return a == b or abs(a - b) % C.DEFAULT_STAGGER == 0


def test_battery_rows_match_the_jax_tool(tiny, tmp_path):
    jout, tout = tmp_path / "jax.csv", tmp_path / "torch.csv"
    jbatch.run("tiny", JEpicConfig(solver=JSolverConfig(epsilon=1e-2, backend="xla",
                                                        cascade=True)), str(jout))
    got = batch_bench.main(["--domain", "tiny", "--epsilon", "1e-2", "--cascade",
                            "--device", "cpu", "--out", str(tout)])

    assert open(tout).readline() == open(jout).readline()
    assert open(tout).readline().strip().split(",") == batch_bench.HEADER
    j, t = _rows(jout), _rows(tout)
    assert set(j) == {*HOST_ROWS, "log_xla_cpu", "log_cascade_cpu"}
    assert set(t) == {*HOST_ROWS, "log_torch_cpu", "log_cascade_cpu"}
    assert [r[1] for r in got] == [r["Solver"] for r in csv.DictReader(open(tout))]
    for r in t.values():
        assert r["Domain"] == "tiny" and float(r["Epsilon"]) == 1e-2
        assert float(r["Time to Converge"]) > 0 and int(r["Iterations"]) > 0
        assert float(r["Time per Update"]) == pytest.approx(
            float(r["Time to Converge"]) / int(r["Iterations"]))
    for name in HOST_ROWS:
        assert t[name]["Percent Valid"] == j[name]["Percent Valid"], name
        assert t[name]["Iterations"] == j[name]["Iterations"], name
    for mine, theirs in (("log_torch_cpu", "log_xla_cpu"),
                         ("log_cascade_cpu", "log_cascade_cpu")):
        assert float(t[mine]["Percent Valid"]) == float(j[theirs]["Percent Valid"])
        assert _same_cycle_class(int(t[mine]["Iterations"]), int(j[theirs]["Iterations"]))
    # The protocol is the same on every log-space row of one package.
    assert t["log_torch_cpu"]["Iterations"] == t["log_native_cpu"]["Iterations"]
    # The battery's point: log space stays valid where SOR collapses.
    assert float(t["log_torch_cpu"]["Percent Valid"]) >= float(t["cpu_sor_f32"]["Percent Valid"])


def test_sweep_gives_three_epsilons_of_every_row(tiny, tmp_path):
    out = tmp_path / "sweep.csv"
    batch_bench.main(["--domain", "tiny", "--sweep", "--device", "cpu", "--out", str(out)])
    rows = list(csv.DictReader(open(out)))
    assert len(rows) == 3 * 4
    for eps in (1e-1, 1e-2, 1e-3):
        assert sorted(r["Solver"] for r in rows if float(r["Epsilon"]) == eps) == sorted(
            [*HOST_ROWS, "log_torch_cpu"])
    assert not any(r["Solver"].startswith("log_cascade") for r in rows)


@pytest.mark.parametrize("backend, device_rows", [("xla", {"log_torch_cpu"}),
                                                  ("pallas", set()),
                                                  ("auto", {"log_torch_cpu"})])
def test_backend_flag_picks_the_device_rows(tiny, tmp_path, backend, device_rows):
    """The tool reads --backend itself: "xla" the plain row, "pallas" the
    kernels' row, which needs a card (none on the CPU), "auto" both."""
    out = tmp_path / "b.csv"
    batch_bench.main(["--domain", "tiny", "--epsilon", "1e-2", "--backend", backend,
                      "--device", "cpu", "--out", str(out)])
    assert set(_rows(out)) == {*HOST_ROWS, *device_rows}


def test_all_domains_loop(tiny, tmp_path, monkeypatch):
    monkeypatch.setattr(batch_bench, "DOMAINS", {"tiny": tiny.shape})
    out = tmp_path / "all.csv"
    batch_bench.main(["--domain", "all", "--epsilon", "1e-2", "--backend", "xla",
                      "--device", "cpu", "--out", str(out)])
    assert {r["Domain"] for r in csv.DictReader(open(out))} == {"tiny"}


def test_no_rows_writes_no_csv(tmp_path, monkeypatch, capsys):
    """R5 (an empty CSV once committed as a result): a battery without rows
    exits nonzero and leaves no file, nor prints a header."""
    monkeypatch.setattr(batch_bench, "DOMAINS", {})
    out = tmp_path / "empty.csv"
    with pytest.raises(SystemExit) as e:
        batch_bench.main(["--domain", "all", "--device", "cpu", "--out", str(out)])
    assert e.value.code not in (0, None)
    assert list(tmp_path.iterdir()) == []
    with pytest.raises(SystemExit):
        batch_bench.main(["--domain", "all", "--device", "cpu"])
    assert "Domain" not in capsys.readouterr().out


def test_failed_run_leaves_no_file(tiny, tmp_path, monkeypatch):
    """A run cut by an error after its first rows leaves neither the CSV nor
    its temporary file."""
    monkeypatch.setattr(batch_bench, "DOMAINS", {"tiny": tiny.shape, "zz": (8, 8)})

    def load(name):
        if name == "zz":
            raise OSError("map not readable")
        return tiny

    monkeypatch.setattr(batch_bench, "load_domain", load)
    with pytest.raises(OSError):
        batch_bench.main(["--domain", "all", "--epsilon", "1e-2", "--backend", "xla",
                          "--device", "cpu", "--out", str(tmp_path / "cut.csv")])
    assert list(tmp_path.iterdir()) == []


def test_load_domain_reads_the_reference_png(tmp_path, monkeypatch):
    """The reference's PNG where $EPIC_REFERENCE_ROOT names its tree (a goal
    pixel added where it has none), as the JAX tool loads it from the same
    tree (its fixed search root pointed there); unset, the procedural maze
    of the domain's size."""
    from PIL import Image

    from epic_tpu import maps as jmaps

    monkeypatch.setattr(jmaps, "reference_map_path", maps.reference_map_path)

    img = maps.recursive_maze(40, 56, seed=2)
    (tmp_path / "maps").mkdir()
    Image.fromarray(img).save(tmp_path / "maps" / "maze.png")
    nogoal = np.where(img == 255, 128, img).astype(np.uint8)
    Image.fromarray(nogoal).save(tmp_path / "maps" / "umass.png")
    monkeypatch.setenv("EPIC_REFERENCE_ROOT", str(tmp_path))
    for name in ("maze", "umass"):
        got = batch_bench.load_domain(name)
        np.testing.assert_array_equal(got, jbatch.load_domain(name))
        assert (got == 255).sum() >= 1
    np.testing.assert_array_equal(batch_bench.load_domain("maze"), img)
    monkeypatch.delenv("EPIC_REFERENCE_ROOT")
    got = batch_bench.load_domain("c_space")
    assert got.shape == batch_bench.DOMAINS["c_space"]
    np.testing.assert_array_equal(got, jbatch.load_domain("c_space"))
