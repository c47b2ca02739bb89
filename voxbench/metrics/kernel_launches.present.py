"""The hand-written kernels' launches an app frame: the program's ``launch``
spans under the step's root spans; 0 where a path fell back to plain
torch."""

from voxbench import program_spans

LAYER = "kernel launches"
UNIT = "launches"
SOURCE = "program_counter"
MOVES = "present_frame_ms"


def read(run):
    w = program_spans.window(run, "render_screen_present")
    return None if w is None else w.count("launch")
