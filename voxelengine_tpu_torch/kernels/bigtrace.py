"""Wrapper of K1, the Hopper line-table traversal kernel (``csrc/bigtrace.cu``).

It replaces ``voxelengine_tpu/ops/pallas_bigtrace.py::_bigtrace_kernel``;
its plain version is :func:`voxelengine_tpu_torch.ops.trace.trace_brickmap`,
which :func:`voxelengine_tpu_torch.ops.bigtrace.trace_brickmap_hbm` runs
for rays on the CPU.  ``launches`` counts the kernel launches made through
:func:`bigtrace`, so a run can show that its main path reached the kernel.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build

launches = 0


def bigtrace(
    start: torch.Tensor,
    d: torch.Tensor,
    active: torch.Tensor,
    pad: torch.Tensor,
    region_lines: torch.Tensor,
    brick_lines: torch.Tensor,
    *,
    grid_dims,
    region_dims,
    factor: int,
    wpb: int,
    max_steps: int,
    brick_layout: Layout,
):
    """Trace N rays through the line table on the card, one thread a ray.

    ``start`` (world-clipped start, chunk units) and ``d`` (normalized
    direction) are ``f32[N, 3]``; ``active`` is ``i32[N]``, ``pad`` the
    coarse edge pad ``i32[N, 3]`` (see ``ops/bigtrace.py``).  Returns
    ``(flags i32[N], position f32[N, 3], normal f32[N, 3], steps i32[N])``
    with ``flags = hit | hit_imm << 1``; the caller applies the
    ``hit_imm`` fix-up.  Launches on the current stream without
    synchronising and raises if the launch is refused.
    """
    global launches
    dev = build.check_rays("bigtrace", start, d, active, pad)
    rx, ry, rz = region_dims
    build.check("bigtrace", "region_lines", region_lines, torch.int32, (rx * ry * rz * 8, 128), dev)
    build.check("bigtrace", "brick_lines", brick_lines, torch.int32, (None, 128), dev)
    if not 1 <= factor <= 32:
        raise ValueError(f"bigtrace: factor {factor} outside 1..32")
    n = start.shape[0]
    outs = build.ray_outputs(n, dev)
    if n == 0:
        return outs
    gx, gy, gz = grid_dims
    build.launch(
        "bigtrace", build.load_kernel("bigtrace").vx_bigtrace,
        start.data_ptr(), d.data_ptr(), active.data_ptr(), pad.data_ptr(),
        region_lines.data_ptr(), brick_lines.data_ptr(),
        n, gx, gy, gz, rx, ry, factor, wpb, max_steps, brick_layout.value,
        3 * max_steps + 64,  # iteration cap (pallas_bigtrace.py:1488)
        *(o.data_ptr() for o in outs), dev=dev,
    )
    launches += 1
    return outs
