"""The host's ms a query call inside the program's ``launch`` spans
(``kernels/build.py::launch``: the device guard, the ctypes call, the
launch's check), read from the program's span ring over the traced
window's steps."""

from voxbench import program_spans

LAYER = "kernel launches"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "query_mrays_per_s"


def read(run):
    w = program_spans.window(run, "raytrace")
    return None if w is None else w.ms("launch")
