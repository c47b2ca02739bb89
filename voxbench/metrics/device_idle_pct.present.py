"""The share of the traced window in which no operation ran on the card
(``torch.profiler``), in the app-frame cell."""

LAYER = "device"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "present_frame_ms"


def read(run):
    return run.idle_pct("render_screen_present")
