"""Dense-grid traversal: counterpart of ``voxelengine_tpu/ops/pallas_trace.py``.

:func:`trace_grid_vpu` and :func:`trace_grid_mxu` keep the JAX names so a
reader finds their counterparts; the TPU units in the names (the VPU's
pair-gather fetch, the MXU's one-hot matmul fetch) are not used here.
Both compute :func:`voxelengine_tpu_torch.ops.trace.trace_grid`.  Rays on
a CUDA device run in a Hopper kernel, K2 (int32 word fetch) or K3 (the
word rebuilt from four uint8 limb planes, the cross-check), one launch
each that also does the ray setup and the zero-step fix-up which the JAX
wrappers run in XLA around their Pallas kernels
(:mod:`voxelengine_tpu_torch.kernels.gridtrace`); rays on the CPU run the
plain ``trace_grid``.  Both give the same hits, steps, positions and
normals.  The kernels read TILED_MORTON grids directly, so unlike the TPU
wrappers nothing converts a grid to LINEAR first.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.config import MAX_STEPS
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.ops.trace import TraceOut, trace_grid

F32 = torch.float32


def words_to_rows_i32(words: torch.Tensor) -> torch.Tensor:
    """int32 words ``[W]`` -> ``int32[R, 128]``, W padded with zeros to a
    multiple of 1024 (``pallas_trace.py:282-293``).  A view when no padding
    is needed.  The TPU kernel's input layout; K2 reads the flat words."""
    padn = (-words.shape[0]) % 1024
    if padn:
        words = torch.cat([words, words.new_zeros((padn,))])
    return words.reshape(-1, 128)


def words_to_limb_rows(words: torch.Tensor) -> torch.Tensor:
    """int32 words ``[W]`` -> ``uint8[4, R, 128]`` 8-bit limb planes, limb
    ``k`` holding bits ``8k .. 8k+7``, W padded with zeros to a multiple of
    128 (``pallas_trace.py:56-68``; there the limbs are bf16 for the MXU).

    Limb ``k`` of a word is its little-endian byte ``k`` (torch's CPU and
    CUDA tensors are little-endian), so the planes are the words' bytes
    transposed: one copy, plus one pad where W is not a multiple of 128."""
    padn = (-words.shape[0]) % 128
    if padn:
        words = torch.nn.functional.pad(words, (0, padn))
    return words.contiguous().view(torch.uint8).view(-1, 4).t().contiguous().view(4, -1, 128)


def _trace_grid_kernel(grid: BitGrid, origins, rays, max_steps: int, limbs: bool) -> TraceOut:
    """K2 or K3: ray setup, walk and zero-step fix-up in one launch
    (``pallas_trace.py:477-545``)."""
    from voxelengine_tpu_torch.kernels import gridtrace as k

    kw = dict(dims=grid.dims, layout=grid.layout, max_steps=max_steps)
    o, r = origins.to(F32), rays.to(F32)
    if limbs:
        return TraceOut(*k.gridtrace_limbs(o, r, words_to_limb_rows(grid.words), **kw))
    return TraceOut(*k.gridtrace(o, r, grid.words, **kw))


def trace_grid_vpu(grid: BitGrid, origins: torch.Tensor, rays: torch.Tensor, max_steps: int = MAX_STEPS) -> TraceOut:
    """Single-level dense-grid trace (``trace_grid`` semantics): K2 for CUDA
    tensors, the plain ``trace_grid`` for CPU tensors."""
    if not origins.is_cuda:
        return trace_grid(grid, origins, rays, max_steps)
    return _trace_grid_kernel(grid, origins, rays, max_steps, limbs=False)


def trace_grid_mxu(grid: BitGrid, origins: torch.Tensor, rays: torch.Tensor, max_steps: int = MAX_STEPS) -> TraceOut:
    """:func:`trace_grid_vpu` with the limb-plane fetch: K3 for CUDA tensors,
    the plain ``trace_grid`` for CPU tensors."""
    if not origins.is_cuda:
        return trace_grid(grid, origins, rays, max_steps)
    return _trace_grid_kernel(grid, origins, rays, max_steps, limbs=True)
