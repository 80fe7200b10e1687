"""epic_tpu_torch.tools.compare_precision (the precision-collapse overlay)
against the JAX package's tools/compare_precision.py on the same tiny
domain, on the CPU: the three region shares as printed, and the overlay
image pixel for pixel. Both tools load the domain through their battery's
``load_domain``, patched to a 48^2 recursive maze; the JAX tool's SOR runs
on the port's native library (no test calls epic_tpu.native). The log-space
fields of the two packages differ by an ulp on the CPU; the valid-gradient
threshold (1e-10) sits far from them, so the regions must be equal.
"""

import importlib
import pathlib
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

jbatch = importlib.import_module("batch_bench")
jprecision = importlib.import_module("compare_precision")

from epic_tpu import native as jnative  # noqa: E402
from epic_tpu_torch import maps, native  # noqa: E402
from epic_tpu_torch.tools import compare_precision  # noqa: E402


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


@pytest.fixture()
def tiny(monkeypatch):
    img = maps.recursive_maze(48, 48, seed=4)
    monkeypatch.setattr(jbatch, "load_domain", lambda name: img)
    monkeypatch.setattr(compare_precision, "load_domain", lambda name: img)
    for name in ("available", "legacy_sor_2d"):
        monkeypatch.setattr(jnative, name, getattr(native, name))
    return img


@pytest.mark.parametrize("epsilon", ["1e-2", "1e-4"])
def test_shares_and_overlay_match_the_jax_tool(tiny, tmp_path, monkeypatch, capsys, epsilon):
    jpng, tpng = tmp_path / "jax.png", tmp_path / "torch.png"
    monkeypatch.setattr(sys, "argv", ["compare_precision.py", "--domain", "tiny",
                                      "--epsilon", epsilon, "--out", str(jpng)])
    jprecision.main()
    jlines = capsys.readouterr().out.splitlines()
    shares = compare_precision.main(["--domain", "tiny", "--epsilon", epsilon,
                                     "--device", "cpu", "--out", str(tpng)])
    tlines = capsys.readouterr().out.splitlines()

    assert tlines[:3] == jlines[:3]
    assert list(shares) == ["sor_f32", "sor_f64", "log"]
    for line, (name, share) in zip(tlines, shares.items()):
        assert line == f"{name}: {share:.3%} of free cells valid"
    assert tlines[3] == f"overlay written to {tpng}"
    np.testing.assert_array_equal(maps.load_png(tpng), maps.load_png(jpng))
    # The paper's claim on this domain: log space is valid wherever SOR is.
    assert shares["log"] >= max(shares["sor_f32"], shares["sor_f64"])


def test_overlay_levels(tiny):
    reg = {"sor_f32": np.zeros(tiny.shape, bool), "sor_f64": np.zeros(tiny.shape, bool),
           "log": (tiny != 0) & (tiny != 255)}
    reg["sor_f64"][:24] = reg["log"][:24]
    reg["sor_f32"][:12] = reg["log"][:12]
    rgb = compare_precision.overlay(tiny, reg)
    assert rgb.shape == tiny.shape + (3,) and rgb.dtype == np.uint8
    gray = rgb[..., 0]
    assert set(np.unique(gray[:12][reg["log"][:12]])) == {120}
    assert set(np.unique(gray[12:24][reg["log"][12:24]])) == {90}
    assert set(np.unique(gray[24:][reg["log"][24:]])) == {60}
    assert (gray[tiny == 0] == 0).all() and (gray[tiny == 255] == 255).all()
