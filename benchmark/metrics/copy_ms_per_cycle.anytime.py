"""The field's host copies a cycle: the program's ``grid.host_copy`` spans,
summed over the traced window and divided by its cycles. The tick's launch
returns before its kernel has run, so the first copy of a cycle also waits
for the tick: this is the copies and that wait together."""

import pathlib

from benchmark import program_spans

TRACE = pathlib.Path(__file__).parents[2] / "build/benchmark/trace.json"


def read(run):
    spans = program_spans.read(run, TRACE)
    if spans is None:
        return None
    total = sum(b - a for name, a, b, _ in spans.spans if name == "grid.host_copy")
    return program_spans.per_item_ms(total, len(run.items))
