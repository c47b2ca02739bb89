"""The traced window's share in which the card was idle while the
program's root span of a step was open on the host (``render/frame.py::render_frame``'s ``frame`` span):
the part of ``device_idle_pct.frame`` the program holds; the rest is its
caller's."""

from voxbench import program_spans

LAYER = "device"
UNIT = "%"
SOURCE = "program_span"
MOVES = "frame_ms"


def read(run):
    return program_spans.idle_in_program_pct(run, "render_frame", "idle_in_program_pct.frame")
