"""The share of the traced window in which no operation ran on the card
(``torch.profiler``), in the bench-frame cells."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(run):
    return run.idle_pct("render_frame")
