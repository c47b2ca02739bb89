"""K1's rays entry on a query batch (``engine/raytracer.py::_batch_trace``,
macro levels off): its roofline bound over its device time a launch."""

LAYER = "K1 traversal"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "query_mrays_per_s"


def read(run):
    return run.roofline_pct("raytrace", "k1_rays")
