"""K4's rays entry on a bench frame's primary rays, over a world without a
line table: its roofline bound (the bytes of the rays and the hits' table
words, on a compact world also each hit chunk's ``brick_idx`` word, over
3.35 TB/s, or its DDA steps over the card's lane-op rate) over its device
time a launch."""

LAYER = "K4 traversal"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(run):
    return run.roofline_pct("render_frame", "k4_rays")
