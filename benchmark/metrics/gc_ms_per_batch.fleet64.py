"""The collector's time a batch: every collection in the traced window (the
program's ``gc.gen<N>`` spans), over the window's batches; 0.0 when none
ran."""

import pathlib

from benchmark import program_spans

TRACE = pathlib.Path(__file__).parents[2] / "build/benchmark/trace.json"


def read(run):
    spans = program_spans.read(run, TRACE)
    if spans is None:
        return None
    return program_spans.per_item_ms(spans.collections_s(), len(run.groups))
