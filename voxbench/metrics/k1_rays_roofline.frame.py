"""K1's rays entry on a bench frame's primary rays: its roofline bound (the
bytes of the rays and the hits' table words over 3.35 TB/s, or its DDA
steps over the issue rate) over its device time a launch."""

LAYER = "K1 traversal"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(run):
    return run.roofline_pct("render_frame", "k1_rays")
