"""On-chip two-level traversal: counterpart of ``voxelengine_tpu/ops/pallas_trace2.py``.

:func:`trace_brickmap_mxu` keeps the JAX name (on the TPU both tables sit
in VMEM and every lookup is a one-hot MXU matmul); here rays on a CUDA
device run in K4, a Hopper kernel that reads a dense-slot brickmap's
``meta`` and ``bricks`` by chunk index
(:mod:`voxelengine_tpu_torch.kernels.bmtrace`), and rays on the CPU run the
plain :func:`~voxelengine_tpu_torch.ops.trace.trace_brickmap`.  Both give
the same hits, steps, positions and normals.

:func:`trace_brickmap_no_table` is the trace the frame path and the engine
facade take where a world has no line table: K4 for CUDA rays, in its
dense-slot or its compact instantiation by the world's form (the compact
one is the counterpart of the JAX package's XLA walk of a compact world,
``voxelengine_tpu/ops/trace.py:411,435``).
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.config import MAX_STEPS
from voxelengine_tpu_torch.core.brickmap import BrickMap
from voxelengine_tpu_torch.ops.trace import TraceOut, trace_brickmap

F32 = torch.float32


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
    rays (dense-slot or compact world), the plain walk for CPU rays."""
    if bm.bricks is None:
        raise ValueError("brick words are host-resident (load_world_host_bricks): trace through a line table "
                         "(lt=make_line_table(bm) with brick lines from ops/bigtrace.py::host_brick_lines), or "
                         "attach device bricks with dataclasses.replace")
    if not _is_cuda(origins):
        return trace_brickmap(bm, origins, rays, max_steps)
    return _trace_brickmap_kernel(bm, origins, rays, max_steps)


def _trace_brickmap_kernel(bm: BrickMap, origins, rays, max_steps: int) -> TraceOut:
    """One K4 launch in the instantiation of ``bm``'s form (dense slots, or
    compact through ``brick_idx``), its rays entry: the ray setup and the
    ``hit_imm`` fix-up in the launch (``pallas_trace2.py:344-405``)."""
    from voxelengine_tpu_torch.kernels import bmtrace as k4

    kw = dict(grid_dims=bm.grid_dims, factor=bm.factor, max_steps=max_steps, coarse_layout=bm.coarse_layout,
              brick_layout=bm.brick_layout)
    o, d = origins.to(F32), rays.to(F32)
    if bm.dense_slots:
        return TraceOut(*k4.bmtrace_rays(o, d, bm.meta, bm.bricks, **kw))
    return TraceOut(*k4.bmtrace_compact_rays(o, d, bm.meta, bm.brick_idx, bm.bricks, **kw))
