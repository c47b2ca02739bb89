"""K4's secondary entries on a shaded bench frame without a line table:
the shadow, reflection and AO launches' bounds summed over their device
time summed, a frame."""

LAYER = "secondary rays"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "frame_ms"


def read(run):
    return run.roofline_pct("render_frame", "k4_secondary", per_frame=True)
