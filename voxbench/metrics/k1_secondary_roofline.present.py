"""K1's secondary entries on a shaded app frame: the three kinds' bounds
summed over their device time summed, a frame."""

LAYER = "secondary rays"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "present_frame_ms"


def read(run):
    return run.roofline_pct("render_screen_present", "k1_secondary", per_frame=True)
