"""The program's ``grid.host_copy`` spans over the window, a plan: the
field's and the locks' copies to the host (119.5 MB a plan at the published
storey), each ending when the copy has landed."""

import pathlib

from benchmark import program_spans

TRACE = pathlib.Path(__file__).parents[2] / "build/benchmark/trace.json"


def read(run):
    spans = program_spans.read(run, TRACE)
    if spans is None:
        return None
    copies = [b - a for n, a, b, _ in spans.spans if n == "grid.host_copy"]
    if not copies:
        return None
    return program_spans.per_item_ms(sum(copies), len(run.items))
