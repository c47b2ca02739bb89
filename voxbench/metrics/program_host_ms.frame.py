"""The host's ms a bench frame inside the program (``render/frame.py::render_frame``'s ``frame`` span),
less its kernels' launches and any wait for the card: argument checks,
allocations, eager torch ops."""

from voxbench import program_spans

LAYER = "render loop"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frame_ms"


def read(run):
    w = program_spans.window(run, "render_frame")
    return None if w is None else w.program_ms()
