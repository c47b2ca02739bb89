"""The host's time to dispatch an app frame: the mean of a span around each
``Graphics.render_screen`` call, before the present, over the traced
window."""

LAYER = "render loop"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "present_frame_ms"


def read(run):
    return run.span_ms("render_screen_present", "enqueue")
