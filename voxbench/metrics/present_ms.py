"""The app's present a frame: the mean of a span from ``to_bgra8``'s call
until the copy into the display's host buffer returns, the wait for the
frame's kernels included."""

LAYER = "present"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "present_frame_ms"


def read(run):
    return run.span_ms("render_screen_present", "present")
