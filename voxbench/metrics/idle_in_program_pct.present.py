"""The traced window's share in which the card was idle while the
program's root span of a step was open on the host (``render/graphics.py::Graphics.render_screen``'s ``screen`` span and ``render/frame.py::to_bgra8``'s ``bgra8``):
the part of ``device_idle_pct.present`` the program holds; the rest is its
caller's."""

from voxbench import program_spans

LAYER = "device"
UNIT = "%"
SOURCE = "program_span"
MOVES = "present_frame_ms"


def read(run):
    return program_spans.idle_in_program_pct(run, "render_screen_present", "idle_in_program_pct.present")
