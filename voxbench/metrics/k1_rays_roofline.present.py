"""K1's rays entry on an app frame's primary rays (macro levels on): its
roofline bound over its device time a launch."""

LAYER = "K1 traversal"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "present_frame_ms"


def read(run):
    return run.roofline_pct("render_screen_present", "k1_rays")
