"""The mean self time of the program's ``path3d.walk`` span: the trilinear
streamline's walk on the host (native or NumPy), less the collections
inside it."""

import pathlib

from benchmark import program_spans

TRACE = pathlib.Path(__file__).parents[2] / "build/benchmark/trace.json"


def read(run):
    spans = program_spans.read(run, TRACE)
    if spans is None:
        return None
    return program_spans.mean_ms(spans.self_s("path3d.walk"))
