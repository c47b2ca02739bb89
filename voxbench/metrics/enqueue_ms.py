"""The host's time to dispatch a bench frame: the mean of a span the benchmark
records around each ``render_frame`` call, before any wait, over the traced
window."""

LAYER = "render loop"
UNIT = "ms"
SOURCE = "host_clock"
MOVES = "frame_ms"


def read(run):
    return run.span_ms("render_frame", "enqueue")
