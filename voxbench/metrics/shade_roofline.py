"""The shading kernel's composite on a bench frame: its bound (the bytes it
must move over 3.35 TB/s, or its float ops over the issue rate) over its
device time a launch."""

LAYER = "shading kernel"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(run):
    return run.roofline_pct("render_frame", "shade")
