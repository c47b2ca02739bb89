"""The host's ms an app frame inside the program (``render/graphics.py::Graphics.render_screen``'s ``screen`` span and ``render/frame.py::to_bgra8``'s ``bgra8``),
less its kernels' launches and any wait for the card: argument checks,
allocations, eager torch ops."""

from voxbench import program_spans

LAYER = "render loop"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "present_frame_ms"


def read(run):
    w = program_spans.window(run, "render_screen_present")
    return None if w is None else w.program_ms()
