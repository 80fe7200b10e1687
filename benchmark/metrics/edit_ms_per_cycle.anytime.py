"""The edit verbs' time a cycle: the program's ``planner.set_cells``,
``planner.add_goals``, ``planner.remove_goals`` and
``planner.reset_free_cells`` spans (the goal verbs' host copy of the field
inside them), summed over the traced window and divided by its cycles."""

import pathlib

from benchmark import program_spans

TRACE = pathlib.Path(__file__).parents[2] / "build/benchmark/trace.json"
VERBS = {"planner.set_cells", "planner.add_goals", "planner.remove_goals",
         "planner.reset_free_cells"}


def read(run):
    spans = program_spans.read(run, TRACE)
    if spans is None:
        return None
    total = sum(b - a for name, a, b, _ in spans.spans if name in VERBS)
    return program_spans.per_item_ms(total, len(run.items))
