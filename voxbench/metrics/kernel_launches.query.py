"""The hand-written kernels' launches a query call: the program's ``launch``
spans under the step's root spans; 0 where a path fell back to plain
torch."""

from voxbench import program_spans

LAYER = "kernel launches"
UNIT = "launches"
SOURCE = "program_counter"
MOVES = "query_mrays_per_s"


def read(run):
    w = program_spans.window(run, "raytrace")
    return None if w is None else w.count("launch")
