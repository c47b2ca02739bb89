"""Wrapper of K5, the Hopper persistent-threads line-table traversal
(``csrc/rrtrace.cu``).

It replaces ``voxelengine_tpu/ops/pallas_bigtrace.py::_rr_kernel``; its
plain version is :func:`voxelengine_tpu_torch.ops.bigtrace.trace_brickmap_lt`
(with the macro levels off, :func:`voxelengine_tpu_torch.ops.trace.
trace_brickmap`), which :func:`voxelengine_tpu_torch.ops.bigtrace.
trace_brickmap_hbm_rr` runs for rays on the CPU.  ``launches`` counts the
launches made through :func:`rrtrace`, the counting instantiation's too.
"""

from __future__ import annotations

from typing import Optional

import torch

from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build
from voxelengine_tpu_torch.kernels.bigtrace import check_line_table

launches = 0
# idle lanes at which a warp takes new rays (1-32; 32 waits for all of its
# lanes, as batches of 32 rays did): of 32, 16, 8, 4 and 1, the best on the
# sparse world's batch and the demo frame together (PERF.md)
REFILL = 8


def rrtrace(
    start: torch.Tensor,
    d: torch.Tensor,
    active: torch.Tensor,
    pad: torch.Tensor,
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
    stats: Optional[torch.Tensor] = None,
):
    """Trace N rays through the line table on the card with a grid sized to
    the card: each lane of a warp walks one ray at a time, and once
    ``refill`` (1-32) of a warp's lanes are idle, they take the next rays
    from a work counter, until the queue is empty.

    Arguments and outputs as :func:`voxelengine_tpu_torch.kernels.bigtrace.
    bigtrace` without ``diag``.  With ``stats`` (``int64[2]``, zeroed by the
    caller) the counting instantiation runs and adds the lanes that iterate
    and the warp-iterations, so ``stats[0] / (32 * stats[1])`` is the share
    of lane-slots that do work.  Launches on the current stream without
    synchronising and raises if the launch is refused.
    """
    global launches
    if not 1 <= refill <= 32:
        raise ValueError(f"rrtrace: refill {refill} is not in 1-32")
    dev = build.check_rays("rrtrace", start, d, active, pad)
    mptrs = check_line_table("rrtrace", dev, region_lines, brick_lines, macro, macro2, region_dims, factor,
                             use_macro)
    n = start.shape[0]
    outs = build.ray_outputs(n, dev)
    if n == 0:
        return outs
    if stats is not None:
        build.check("rrtrace", "stats", stats, torch.int64, (2,), dev)
    counter = torch.empty((1,), dtype=torch.int32, device=dev)  # zeroed by the launcher on the stream
    gx, gy, gz = grid_dims
    build.launch(
        "rrtrace", build.load_kernel("rrtrace").vx_rrtrace,
        start.data_ptr(), d.data_ptr(), active.data_ptr(), pad.data_ptr(),
        region_lines.data_ptr(), brick_lines.data_ptr(), *mptrs,
        n, gx, gy, gz, *region_dims, factor, wpb, max_steps, brick_layout.value,
        3 * max_steps + 64,  # iteration cap (pallas_bigtrace.py:1919-1921)
        int(use_macro), refill, counter.data_ptr(), None if stats is None else stats.data_ptr(),
        *(o.data_ptr() for o in outs), dev=dev,
    )
    launches += 1
    return outs
