"""Wrapper of K5, the Hopper persistent-threads line-table traversal
(``csrc/rrtrace.cu``).

It replaces ``voxelengine_tpu/ops/pallas_bigtrace.py::_rr_kernel``; its
plain version is :func:`voxelengine_tpu_torch.ops.bigtrace.trace_brickmap_lt`
(with the macro levels off, :func:`voxelengine_tpu_torch.ops.trace.
trace_brickmap`), which :func:`voxelengine_tpu_torch.ops.bigtrace.
trace_brickmap_hbm_rr` runs for rays on the CPU.  :func:`rrtrace_rays`, its
one entry, takes origins and raw directions and runs the ray setup and the
``hit_imm`` fix-up in the launch: ``trace_brickmap_hbm_rr``'s card path.
The refill schedule on prepared rays, with the share of lane-slots doing
work counted, is the g++ twin's (``csrc/dda_host.cpp::vx_rrtrace_host``).
``rays_launches`` counts the launches.
"""

from __future__ import annotations

from typing import Optional

import torch

from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build
from voxelengine_tpu_torch.kernels.bigtrace import check_line_table

rays_launches = 0
# idle lanes at which a warp takes new rays (1-32; 32 waits for all of its
# lanes, as batches of 32 rays did): of 32, 16, 8, 4 and 1, the best on the
# sparse world's batch and the demo frame together (PERF.md)
REFILL = 8


def rrtrace_rays(
    origins: torch.Tensor,
    rays: torch.Tensor,
    region_lines: torch.Tensor,
    brick_lines: torch.Tensor,
    macro: Optional[torch.Tensor] = None,
    macro2: Optional[torch.Tensor] = None,
    *,
    grid_dims,
    region_dims,
    factor: int,
    wpb: int,
    max_steps: int,
    brick_layout: Layout,
    use_macro: bool = False,
    refill: int = REFILL,
):
    """Trace N rays through the line table on the card with a grid sized to
    the card: each lane of a warp walks one ray at a time, and once
    ``refill`` (1-32) of a warp's lanes are idle, they take the next rays
    from a work counter, until the queue is empty.

    ``origins`` (voxels) and raw directions ``rays`` are ``f32[N, 3]``, rows
    of 3 contiguous floats or one broadcast row; a lane's refill sets its
    ray up and the store of a hit at the ray's start does the ``hit_imm``
    fix-up, in the launch.  Tables as for :func:`voxelengine_tpu_torch.
    kernels.bigtrace.bigtrace_rays`.  Returns ``(hit bool[N], position,
    normal, steps)``, the ``TraceOut`` fields.  Launches on the current
    stream without synchronising and raises if the launch is refused."""
    global rays_launches
    if not 1 <= refill <= 32:
        raise ValueError(f"rrtrace_rays: refill {refill} is not in 1-32")
    dev = origins.device
    build.require_cuda("rrtrace_rays", dev)
    n = origins.shape[0]
    ray_args = (*build.ray_rows("rrtrace_rays", "origins", origins, n, dev),
                *build.ray_rows("rrtrace_rays", "rays", rays, n, dev))
    mptrs = check_line_table("rrtrace_rays", dev, region_lines, brick_lines, macro, macro2, region_dims, factor,
                             use_macro)
    outs = build.ray_outputs(n, dev, torch.bool)
    if n == 0:
        return outs
    counter = torch.empty((1,), dtype=torch.int32, device=dev)  # zeroed by the launcher on the stream
    gx, gy, gz = grid_dims
    build.launch(
        "rrtrace_rays", build.load_kernel("rrtrace").vx_rrtrace_rays, *build.pointers(ray_args),
        region_lines.data_ptr(), brick_lines.data_ptr(), *mptrs,
        n, gx, gy, gz, *region_dims, factor, wpb, max_steps, brick_layout.value,
        3 * max_steps + 64,  # iteration cap (pallas_bigtrace.py:1919-1921)
        int(use_macro), refill, counter.data_ptr(), *(o.data_ptr() for o in outs), dev=dev,
    )
    rays_launches += 1
    return outs
