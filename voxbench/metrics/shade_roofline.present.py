"""The shading kernel's composite on an app frame: its bound over its device
time a launch."""

LAYER = "shading kernel"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "present_frame_ms"


def read(run):
    return run.roofline_pct("render_screen_present", "shade")
