"""Wrapper of K1, the Hopper line-table traversal kernel (``csrc/bigtrace.cu``).

It replaces ``voxelengine_tpu/ops/pallas_bigtrace.py::_bigtrace_kernel``.
:func:`bigtrace_rays` is the frame path's entry: origins and raw
directions in, the ray setup and the ``hit_imm`` fix-up inside the launch
(``trace_brickmap_hbm``'s card branch whole); :func:`bigtrace` takes the
prepared rays of that setup and leaves the fix-up to its caller (the walk
alone); :func:`bigtrace_record` is :func:`bigtrace_rays` storing the ray
API's result record in the launch (``VoxelRaytracer3D.raytrace``'s card
path); :func:`bigtrace_secondary` builds, walks and reduces a kind of
the shading's secondary rays from the primary trace's results.  Its plain
versions, which
:func:`voxelengine_tpu_torch.ops.bigtrace.trace_brickmap_hbm` runs for rays
on the CPU, are :func:`voxelengine_tpu_torch.ops.bigtrace.trace_brickmap_lt`
(the macro walk, and the diag counters) and, with the macro levels off,
:func:`voxelengine_tpu_torch.ops.trace.trace_brickmap` (the secondary
entry's: :func:`voxelengine_tpu_torch.ops.secondary.secondary_plain` over
them).  ``launches`` counts the kernel launches made through every entry,
so a run can show that its main path reached the kernel;
``record_launches`` those of the record entry, ``secondary_launches``
those of the secondary entry by kind.  The record entry's plain version
is :func:`voxelengine_tpu_torch.engine.raytracer.results_from_trace` over
``trace_brickmap``.
"""

from __future__ import annotations

from typing import Optional

import torch

from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build

launches = 0
# launches of the record entry (each counted in ``launches`` too)
record_launches = 0
# launches of the secondary entry by kind (each counted in ``launches`` too)
secondary_launches = dict.fromkeys(build.SECONDARY_KINDS, 0)
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


def bigtrace_rays(
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
    diag: bool = False,
):
    """``trace_brickmap_hbm`` for N rays on the card in one launch: the ray
    setup, :func:`bigtrace`'s walk and the ``hit_imm`` fix-up.

    ``origins`` (voxels) and ``rays`` (directions, not necessarily
    normalized) are ``f32[N, 3]`` whose rows are 3 contiguous floats, or one
    row broadcast (row stride 0, as ``primary_rays`` gives the origin, or an
    orthographic frame's direction); anything else is copied first.  Tables
    as for :func:`bigtrace`.  Returns ``(hit bool[N], position f32[N, 3],
    normal f32[N, 3], steps i32[N])``, the fields of the
    :class:`~voxelengine_tpu_torch.ops.trace.TraceOut`, and with ``diag`` a
    fifth ``i32[11, N]`` as :func:`bigtrace`'s.  Launches on the current
    stream without synchronising and raises if the launch is refused.
    """
    global launches
    dev = origins.device
    build.require_cuda("bigtrace_rays", dev)
    n = origins.shape[0]
    rows = (*build.ray_rows("bigtrace_rays", "origins", origins, n, dev),
            *build.ray_rows("bigtrace_rays", "rays", rays, n, dev))
    mptrs = check_line_table("bigtrace_rays", dev, region_lines, brick_lines, macro, macro2, region_dims, factor,
                             use_macro)
    outs = build.ray_outputs(n, dev, torch.bool)
    if diag:
        outs += (torch.empty((DIAG_ROWS, n), dtype=torch.int32, device=dev),)
    if n == 0:
        return outs
    gx, gy, gz = grid_dims
    build.launch(
        "bigtrace_rays", build.load_kernel("bigtrace").vx_bigtrace_rays,
        rows[0].data_ptr(), rows[1], rows[2].data_ptr(), rows[3],
        region_lines.data_ptr(), brick_lines.data_ptr(), *mptrs,
        n, gx, gy, gz, *region_dims, factor, wpb, max_steps, brick_layout.value,
        3 * max_steps + 64,  # iteration cap (pallas_bigtrace.py:1488)
        int(use_macro), *(o.data_ptr() for o in outs[:4]), outs[4].data_ptr() if diag else None,
        dev=dev,
    )
    launches += 1
    return outs


def bigtrace_record(
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
):
    """The ray API's result record of N rays on the card in one launch:
    :func:`bigtrace_rays`'s setup, walk (macro levels off) and fix-up, then
    ``engine/raytracer.py::results_from_trace`` in the thread that walked
    the ray (``csrc/ray_setup.cuh::OriginRaysRecord``).

    Rays and tables as for :func:`bigtrace_rays` (``macro`` and ``macro2``
    are not read).  Returns ``(valid bool[N], hit_point f32[N, 3], normal
    f32[N, 3], distance f32[N], voxel_index i32[N], steps i32[N])``, the
    fields of ``RayTraceResults``.  Launches on the current stream without
    synchronising and raises if the launch is refused.
    """
    global launches, record_launches
    dev = origins.device
    build.require_cuda("bigtrace_record", dev)
    n = origins.shape[0]
    rows = (*build.ray_rows("bigtrace_record", "origins", origins, n, dev),
            *build.ray_rows("bigtrace_record", "rays", rays, n, dev))
    mptrs = check_line_table("bigtrace_record", dev, region_lines, brick_lines, macro, macro2, region_dims, factor,
                             False)
    outs = build.record_outputs(n, dev)
    if n == 0:
        return outs
    gx, gy, gz = grid_dims
    build.launch(
        "bigtrace_record", build.load_kernel("bigtrace").vx_bigtrace_record,
        *build.pointers(rows), region_lines.data_ptr(), brick_lines.data_ptr(), *mptrs,
        n, gx, gy, gz, *region_dims, factor, wpb, max_steps, brick_layout.value,
        3 * max_steps + 64,  # iteration cap (pallas_bigtrace.py:1488)
        *build.pointers(outs), dev=dev,
    )
    launches += 1
    record_launches += 1
    return outs


def bigtrace_secondary(
    kind: str,
    position: torch.Tensor,
    normal: torch.Tensor,
    region_lines: torch.Tensor,
    brick_lines: torch.Tensor,
    macro: Optional[torch.Tensor] = None,
    macro2: Optional[torch.Tensor] = None,
    *,
    light=None,
    dirs=None,
    px=None,
    py=None,
    width: int = 0,
    frame_number: int = 0,
    ao_samples: int = 0,
    grid_dims,
    region_dims,
    factor: int,
    wpb: int,
    max_steps: int,
    brick_layout: Layout,
    use_macro: bool = False,
):
    """One kind of the shading's secondary rays for N primary rays on the
    card in one launch (``csrc/secondary.cuh``): each thread builds its
    ray's shadow, reflection or AO rays from the primary trace's
    ``position`` and ``normal``, walks them as :func:`bigtrace_rays` does
    and keeps what shading reads.  Inputs and results as
    ``build.secondary_args``; ``max_steps`` is the kind's walk budget (8
    for AO).  Tables as for :func:`bigtrace`.  Launches on the current
    stream without synchronising and raises if the launch is refused."""
    global launches
    dev, n, head, outs, res = build.secondary_args(
        "bigtrace_secondary", kind, position, normal, light=light, dirs=dirs, px=px, py=py, width=width,
        frame_number=frame_number, ao_samples=ao_samples)
    mptrs = check_line_table("bigtrace_secondary", dev, region_lines, brick_lines, macro, macro2, region_dims,
                             factor, use_macro)
    if n == 0:
        return res
    gx, gy, gz = grid_dims
    build.launch(
        "bigtrace_secondary", build.load_kernel("bigtrace").vx_bigtrace_secondary,
        *build.pointers(head), region_lines.data_ptr(), brick_lines.data_ptr(), *mptrs,
        n, gx, gy, gz, *region_dims, factor, wpb, max_steps, brick_layout.value,
        3 * max_steps + 64,  # iteration cap (pallas_bigtrace.py:1488)
        int(use_macro), *build.pointers(outs), dev=dev,
    )
    launches += 1
    secondary_launches[kind] += 1
    return res
