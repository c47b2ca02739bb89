"""The traced window's share in which the card was idle while the
program's root span of a step was open on the host (``engine/raytracer.py::VoxelRaytracer3D.raytrace``'s ``raytrace`` span):
the part of ``device_idle_pct.query`` the program holds; the rest is its
caller's."""

from voxbench import program_spans

LAYER = "device"
UNIT = "%"
SOURCE = "program_span"
MOVES = "query_mrays_per_s"


def read(run):
    return program_spans.idle_in_program_pct(run, "raytrace", "idle_in_program_pct.query")
