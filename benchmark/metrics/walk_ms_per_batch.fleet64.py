"""The self time of the program's ``path.walk`` spans a batch: the lanes'
walks on the host, less the collections inside them, summed over the
window and divided by its batches."""

import pathlib

from benchmark import program_spans

TRACE = pathlib.Path(__file__).parents[2] / "build/benchmark/trace.json"


def read(run):
    spans = program_spans.read(run, TRACE)
    if spans is None:
        return None
    return program_spans.per_item_ms(sum(spans.self_s("path.walk")), len(run.groups))
