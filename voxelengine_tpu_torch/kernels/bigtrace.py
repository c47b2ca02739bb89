"""Wrapper of K1, the Hopper line-table traversal kernel (``csrc/bigtrace.cu``).

It replaces ``voxelengine_tpu/ops/pallas_bigtrace.py::_bigtrace_kernel``.
Its plain versions, which
:func:`voxelengine_tpu_torch.ops.bigtrace.trace_brickmap_hbm` runs for rays
on the CPU, are :func:`voxelengine_tpu_torch.ops.bigtrace.trace_brickmap_lt`
(the macro walk, and the diag counters) and, with the macro levels off,
:func:`voxelengine_tpu_torch.ops.trace.trace_brickmap`.  ``launches``
counts the kernel launches made through :func:`bigtrace`, so a run can show
that its main path reached the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build

launches = 0
DIAG_ROWS = 11  # 10 phase counters (ops/bigtrace.py::PHASES), then iterations


def check_line_table(kernel: str, dev, region_lines, brick_lines, macro, macro2, region_dims, factor, use_macro):
    """Raise unless the line-table tensors fit ``region_dims`` (shared with
    K5); the macro levels are needed only with ``use_macro``.  Returns the
    pointers of ``macro`` and ``macro2`` (``None`` when not given)."""
    rx, ry, rz = region_dims
    nr = rx * ry * rz
    if nr * 1024 >= 2**31:
        raise ValueError(f"{kernel}: {nr} regions overflow the kernel's int32 region-line index")
    build.check(kernel, "region_lines", region_lines, torch.int32, (nr * 8, 128), dev)
    build.check(kernel, "brick_lines", brick_lines, torch.int32, (None, 128), dev)
    if brick_lines.numel() >= 2**31:
        raise ValueError(f"{kernel}: {brick_lines.numel()} brick-line words overflow the kernel's int32 index")
    if use_macro and (macro is None or macro2 is None):
        raise ValueError(f"{kernel}: use_macro needs the line table's macro and macro2")
    if macro is not None:
        build.check(kernel, "macro", macro, torch.int32, (8 * -(-nr // 32768), 128), dev)
    if macro2 is not None:
        build.check(kernel, "macro2", macro2, torch.int32, (36,), dev)
    if not 1 <= factor <= 32:
        raise ValueError(f"{kernel}: factor {factor} outside 1..32")
    return tuple(None if t is None else t.data_ptr() for t in (macro, macro2))


def bigtrace(
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
    diag: bool = False,
):
    """Trace N rays through the line table on the card, one thread a ray.

    ``start`` (world-clipped start, chunk units) and ``d`` (normalized
    direction) are ``f32[N, 3]``; ``active`` is ``i32[N]``, ``pad`` the
    coarse edge pad ``i32[N, 3]`` (see ``ops/bigtrace.py``); ``macro`` and
    ``macro2`` are the line table's occupancy levels, read when
    ``use_macro``.  Returns ``(flags i32[N], position f32[N, 3], normal
    f32[N, 3], steps i32[N])`` with ``flags = hit | hit_imm << 1`` (the
    caller applies the ``hit_imm`` fix-up), and with ``diag`` a fifth
    ``i32[11, N]``: the 10 phase counters, then the iteration count of each
    ray's warp.  Launches on the current stream without synchronising and
    raises if the launch is refused.
    """
    global launches
    dev = build.check_rays("bigtrace", start, d, active, pad)
    mptrs = check_line_table("bigtrace", dev, region_lines, brick_lines, macro, macro2, region_dims, factor,
                             use_macro)
    n = start.shape[0]
    outs = build.ray_outputs(n, dev)
    if diag:
        outs += (torch.empty((DIAG_ROWS, n), dtype=torch.int32, device=dev),)
    if n == 0:
        return outs
    gx, gy, gz = grid_dims
    build.launch(
        "bigtrace", build.load_kernel("bigtrace").vx_bigtrace,
        start.data_ptr(), d.data_ptr(), active.data_ptr(), pad.data_ptr(),
        region_lines.data_ptr(), brick_lines.data_ptr(), *mptrs,
        n, gx, gy, gz, *region_dims, factor, wpb, max_steps, brick_layout.value,
        3 * max_steps + 64,  # iteration cap (pallas_bigtrace.py:1488)
        int(use_macro), *(o.data_ptr() for o in outs[:4]), outs[4].data_ptr() if diag else None,
        dev=dev,
    )
    launches += 1
    return outs
