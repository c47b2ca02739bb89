"""The host's ms a query call inside the program (``engine/raytracer.py::VoxelRaytracer3D.raytrace``'s ``raytrace`` span),
less its kernels' launches and any wait for the card: argument checks,
allocations, eager torch ops."""

from voxbench import program_spans

LAYER = "ray API"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "query_mrays_per_s"


def read(run):
    w = program_spans.window(run, "raytrace")
    return None if w is None else w.program_ms()
