"""Wrapper of the record instantiation of K1's loop (``csrc/crossings.cu``).

It replaces, as a diagnostic, the TPU package's crossing dump
(``voxelengine_tpu/ops/crossing_trace.py::trace_ray_crossings``, which scans
``pallas_bigtrace.py::_trace_inner``).  Its plain version, which
:func:`voxelengine_tpu_torch.ops.crossing_trace.record_crossings` runs for
rays on the CPU, steps ``ops/bigtrace.py::_lt_step`` and records the same
fields.  ``launches`` counts the kernel launches made through
:func:`crossings`.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build
from voxelengine_tpu_torch.kernels.bigtrace import check_line_table

launches = 0
FIELDS = 29  # csrc/crossings.cuh::C_FIELDS


def crossings(start, d, active, pad, region_lines, brick_lines, macro, macro2, *, grid_dims, region_dims,
              factor: int, wpb: int, max_steps: int, brick_layout: Layout, use_macro: bool, max_rows: int):
    """Record each ray's walk on the card, one thread a ray.  The ray and
    table arguments are :func:`~voxelengine_tpu_torch.kernels.bigtrace.
    bigtrace`'s.  Returns ``(rows i32[N, max_rows, FIELDS], nrows i32[N],
    flags, position, normal, steps)``, the last four as K1's; row ``k`` of
    ray ``i`` is valid for ``k < nrows[i]`` (``csrc/crossings.cuh``).
    Launches on the current stream without synchronising."""
    global launches
    dev = build.check_rays("crossings", start, d, active, pad)
    mptrs = check_line_table("crossings", dev, region_lines, brick_lines, macro, macro2, region_dims, factor,
                             use_macro)
    n = start.shape[0]
    if n * max_rows * FIELDS >= 2**31:
        raise ValueError(f"crossings: {n} rays x {max_rows} rows overflow the kernel's row index")
    rows = torch.empty((n, max_rows, FIELDS), dtype=torch.int32, device=dev)
    nrows = torch.empty((n,), dtype=torch.int32, device=dev)
    outs = build.ray_outputs(n, dev)
    if n == 0:
        return (rows, nrows) + outs
    gx, gy, gz = grid_dims
    build.launch(
        "crossings", build.load_kernel("crossings").vx_trace_crossings,
        start.data_ptr(), d.data_ptr(), active.data_ptr(), pad.data_ptr(),
        region_lines.data_ptr(), brick_lines.data_ptr(), *mptrs,
        n, gx, gy, gz, *region_dims, factor, wpb, max_steps, brick_layout.value,
        3 * max_steps + 64,  # K1's iteration cap
        int(use_macro), max_rows, rows.data_ptr(), nrows.data_ptr(), *(o.data_ptr() for o in outs), dev=dev,
    )
    launches += 1
    return (rows, nrows) + outs
