"""The port's tools as programs: each runs with ``python -m``, imports
neither JAX nor epic_tpu nor the JAX package's tools/, and refuses to run
without a card unless ``--device cpu`` is given (no CPU fallback)."""

import importlib
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOOLS = ["batch_bench", "compare_precision", "anytime_demo", "server_loadtest",
         "scaling_bench"]


def test_tools_leave_jax_out():
    """No tool module imports jax, epic_tpu, or a module of tools/ (whose
    module names are the tools' bare names)."""
    mods = ", ".join(f"epic_tpu_torch.tools.{t}" for t in TOOLS)
    code = (f"import sys, {mods}; "
            "bad = [m for m in sys.modules if m in ('jax', 'epic_tpu') or "
            "m.startswith(('jax.', 'epic_tpu.')) or m in " + repr(tuple(TOOLS)) + "]; "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120)


@pytest.mark.parametrize("tool", TOOLS)
def test_runs_as_a_module(tool):
    out = subprocess.run([sys.executable, "-m", f"epic_tpu_torch.tools.{tool}", "--help"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout


@pytest.mark.parametrize("tool", TOOLS)
def test_refuses_to_run_without_a_card(tool, monkeypatch, tmp_path):
    """The default device is the card; where none is visible the tool raises
    before any work, and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    mod = importlib.import_module(f"epic_tpu_torch.tools.{tool}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main(["--device", "cuda:0"])
    assert list(tmp_path.iterdir()) == []


def test_resolve_device(monkeypatch):
    from epic_tpu_torch.tools import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        resolve_device("cuda")
