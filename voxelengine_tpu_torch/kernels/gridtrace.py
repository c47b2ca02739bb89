"""Wrappers of K2 and K3, the Hopper dense-grid traversal kernels
(``csrc/gridtrace.cu`` over ``csrc/grid_dda.cuh``).

:func:`gridtrace` (K2) replaces ``voxelengine_tpu/ops/pallas_trace.py::
_grid_kernel_vpu`` and reads the int32 words; :func:`gridtrace_limbs` (K3)
replaces ``pallas_trace.py::_grid_kernel`` and rebuilds each word from four
uint8 limb planes.  Their plain version is
:func:`voxelengine_tpu_torch.ops.trace.trace_grid`, which
:mod:`voxelengine_tpu_torch.ops.gridtrace` runs for rays on the CPU.
``launches`` and ``limb_launches`` count the launches of K2 and K3.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.core.bitgrid import words_for_bits
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build

launches = 0
limb_launches = 0


def _grid_args(kernel: str, start, d, active, pad, dims, layout: Layout):
    """Check the grid dims and the ray inputs; returns (device, N, X, Y, Z,
    number of words the grid needs)."""
    X, Y, Z = dims
    if X * Y * Z >= 2**31:
        raise ValueError(f"{kernel}: {X}x{Y}x{Z} voxels overflow the kernel's int32 bit index")
    if layout is not Layout.LINEAR and any(v % 8 for v in dims):
        raise ValueError(f"{kernel}: layout {layout.name} needs dims divisible by 8, got {dims}")
    dev = build.check_rays(kernel, start, d, active, pad)
    return dev, start.shape[0], X, Y, Z, words_for_bits(X * Y * Z)


def gridtrace(start, d, active, pad, words: torch.Tensor, *, dims, layout: Layout, max_steps: int):
    """K2: trace N rays through a dense grid's words on the card, one thread
    a ray.

    ``start`` (world-clipped start, voxel units) and ``d`` (normalized
    direction) are ``f32[N, 3]``; ``active`` is ``i32[N]``, ``pad`` the edge
    pad ``i32[N, 3]``; ``words`` the grid's flat ``int32`` words (at least
    ``ceil(X*Y*Z/32)`` of them), in ``layout`` order.  Returns
    ``(hit i32[N], position f32[N, 3], normal f32[N, 3], steps i32[N])``,
    position and normal of the last step; the caller fixes up hits at the
    start cell.  Launches on the current stream without synchronising and
    raises if the launch is refused.
    """
    global launches
    dev, n, X, Y, Z, nw = _grid_args("gridtrace", start, d, active, pad, dims, layout)
    build.check("gridtrace", "words", words, torch.int32, (None,), dev)
    if words.numel() < nw:
        raise ValueError(f"gridtrace: {words.numel()} words, the {X}x{Y}x{Z} grid needs {nw}")
    outs = build.ray_outputs(n, dev)
    if n == 0:
        return outs
    build.launch(
        "gridtrace", build.load_kernel("gridtrace").vx_trace_grid,
        start.data_ptr(), d.data_ptr(), active.data_ptr(), pad.data_ptr(), words.data_ptr(),
        n, X, Y, Z, layout.value, max_steps, *(o.data_ptr() for o in outs), dev=dev,
    )
    launches += 1
    return outs


def gridtrace_limbs(start, d, active, pad, limbs: torch.Tensor, *, dims, layout: Layout, max_steps: int):
    """K3: :func:`gridtrace` with the words given as ``uint8[4, R, 128]``
    limb planes (``ops/gridtrace.py::words_to_limb_rows``)."""
    global limb_launches
    dev, n, X, Y, Z, nw = _grid_args("gridtrace_limbs", start, d, active, pad, dims, layout)
    build.check("gridtrace_limbs", "limbs", limbs, torch.uint8, (4, None, 128), dev)
    plane = limbs.shape[1] * 128
    if plane < nw:
        raise ValueError(f"gridtrace_limbs: {plane} words per limb plane, the {X}x{Y}x{Z} grid needs {nw}")
    outs = build.ray_outputs(n, dev)
    if n == 0:
        return outs
    build.launch(
        "gridtrace_limbs", build.load_kernel("gridtrace").vx_trace_grid_limbs,
        start.data_ptr(), d.data_ptr(), active.data_ptr(), pad.data_ptr(), limbs.data_ptr(), plane,
        n, X, Y, Z, layout.value, max_steps, *(o.data_ptr() for o in outs), dev=dev,
    )
    limb_launches += 1
    return outs
