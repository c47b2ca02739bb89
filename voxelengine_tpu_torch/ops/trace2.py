"""On-chip two-level traversal: counterpart of ``voxelengine_tpu/ops/pallas_trace2.py``.

:func:`trace_brickmap_mxu` keeps the JAX name (on the TPU both tables sit
in VMEM and every lookup is a one-hot MXU matmul); here rays on a CUDA
device run in K4, a Hopper kernel that reads a dense-slot brickmap's
``meta`` and ``bricks`` by chunk index
(:mod:`voxelengine_tpu_torch.kernels.bmtrace`), and rays on the CPU run the
plain :func:`~voxelengine_tpu_torch.ops.trace.trace_brickmap`.  Both give
the same hits, steps, positions and normals.

:func:`trace_brickmap_no_table` is the trace the frame path and the engine
facade take where a world has no line table.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.config import MAX_STEPS
from voxelengine_tpu_torch.core.brickmap import BrickMap
from voxelengine_tpu_torch.ops.trace import TraceOut, _dims, _edge_pad, _ray_setup, kernel_result, trace_brickmap

I32 = torch.int32


def trace_brickmap_mxu(bm: BrickMap, origins: torch.Tensor, rays: torch.Tensor, max_steps: int = MAX_STEPS) -> TraceOut:
    """Two-level brickmap trace of a dense-slot brickmap (``trace_brickmap``
    semantics): K4 for CUDA tensors, the plain trace for CPU tensors."""
    if not bm.dense_slots:
        raise ValueError("trace_brickmap_mxu requires a dense-slot brickmap")
    if not origins.is_cuda:
        return trace_brickmap(bm, origins, rays, max_steps)
    return _trace_brickmap_kernel(bm, origins, rays, max_steps)


def _is_cuda(t: torch.Tensor) -> bool:
    """Whether rays on ``t``'s device go to a kernel (one place, so a test
    can route a CPU call as a card call)."""
    return t.is_cuda


def trace_brickmap_no_table(bm: BrickMap, origins: torch.Tensor, rays: torch.Tensor,
                            max_steps: int = MAX_STEPS) -> TraceOut:
    """``trace_brickmap``'s function without a line table: K4 for CUDA
    rays over a dense-slot world, the plain walk for CPU rays.  A compact
    world has no kernel without a line table, so CUDA rays over one are
    refused rather than traced by the plain walk on the card."""
    if not _is_cuda(origins):
        return trace_brickmap(bm, origins, rays, max_steps)
    if not bm.dense_slots:
        raise ValueError(
            "a compact (dense_slots=False) world traces on the card only through a line table: "
            "pass lt=make_line_table(bm)"
        )
    return _trace_brickmap_kernel(bm, origins, rays, max_steps)


def _trace_brickmap_kernel(bm: BrickMap, origins, rays, max_steps: int) -> TraceOut:
    """Ray setup, K4 and the ``hit_imm`` fix-up (``pallas_trace2.py:344-405``)."""
    from voxelengine_tpu_torch.kernels import bmtrace as k4

    f = bm.factor
    d, start_c, start_normal, active = _ray_setup(bm.grid_dims, f, origins, rays)
    pad = _edge_pad(start_c.to(I32), _dims(bm.grid_dims, I32, origins.device), d)
    flags, pos, nrm, steps = k4.bmtrace(
        start_c, d, active.to(I32), pad, bm.meta, bm.bricks,
        grid_dims=bm.grid_dims, factor=f, max_steps=max_steps,
        coarse_layout=bm.coarse_layout, brick_layout=bm.brick_layout,
    )
    return kernel_result(flags, pos, nrm, steps, start_c, start_normal, f)
