"""The import guard: nothing a run loads is JAX, Flax or the JAX package,
compared by whole top-level names, and the plain reference loads nothing of
the program."""

from __future__ import annotations

import subprocess
import sys
import textwrap

from benchmark import run as run_mod
from benchmark.tests.epicbench_util import REPO


def _modules(code: str) -> set[str]:
    proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code) +
                           "\nimport sys\nprint(' '.join(sorted({m.partition('.')[0] "
                           "for m in sys.modules})))"],
                          cwd=REPO, capture_output=True, text=True, timeout=600, check=True)
    return set(proc.stdout.split())


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "epic_tpu_torch_fake", object())
    assert "epic_tpu" not in run_mod.forbidden_modules()
    monkeypatch.setitem(sys.modules, "epic_tpu.grid", object())
    assert run_mod.forbidden_modules() == ["epic_tpu"]


def test_a_run_loads_no_jax_and_no_jax_package(tmp_path):
    found = _modules(f"""
        import pathlib
        from benchmark.tests.epicbench_util import run_cpu, tiny_checkout
        root = tiny_checkout(pathlib.Path({str(tmp_path)!r}))
        for cell in ("tiny.goal_solve", "tiny.fleet64"):
            run_cpu(root, cell)
        import benchmark.run, benchmark.control
        """)
    assert "epic_tpu_torch" in found and "benchmark" in found
    assert not found & set(run_mod.FORBIDDEN)


def test_reference_loads_nothing_of_the_program():
    found = _modules("import benchmark.reference, benchmark.check, benchmark.roofline")
    assert "benchmark" in found
    assert not found & ({"epic_tpu_torch"} | set(run_mod.FORBIDDEN))
