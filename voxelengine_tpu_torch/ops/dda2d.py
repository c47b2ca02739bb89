"""2D DDA traversal: counterpart of ``voxelengine_tpu/ops/dda2d.py``.

The ``DDATestCpp`` prototype's capability (``DDATestCpp.cpp:26-260``) as a
planar embedding of the 3D engine: a grid one cell (or one chunk) deep in z
and rays with ``dz = 0`` never step in z, so the 3D traversal is the 2D one.

Where the rays go: rays on a CUDA device run in the Hopper kernels, the
single-level trace in K2 (:func:`~voxelengine_tpu_torch.ops.gridtrace.
trace_grid_vpu`'s kernel) and the two-level trace in K1 through the world's
line table with the macro levels off (the chunk-by-chunk walk, bit-equal to
``trace_brickmap``); the world is compact, which K4 cannot take.  Rays on
the CPU run the plain ``trace_grid`` and ``trace_brickmap``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from voxelengine_tpu_torch.config import MAX_STEPS
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import BrickMap, build_brickmap
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.ops.bigtrace import LineTable, make_line_table, trace_brickmap_k1
from voxelengine_tpu_torch.ops.gridtrace import _trace_grid_kernel
from voxelengine_tpu_torch.ops.trace import TraceOut, trace_brickmap, trace_grid

F32 = torch.float32


def _is_cuda(t: torch.Tensor) -> bool:
    """Whether rays on ``t``'s device go to a kernel (one place, so a test
    can route a CPU call as a card call)."""
    return t.is_cuda


def grid2d_from_dense(dense2d) -> BitGrid:
    """Pack a ``[H(y), W(x)]`` bool array or tensor as a depth-1 3D grid on
    its device."""
    d = torch.as_tensor(dense2d)
    return BitGrid.from_dense(d[None, :, :], layout=Layout.LINEAR)


def brickmap2d_from_dense(dense2d, factor: int) -> BrickMap:
    """Two-level 2D brickmap, ``factor`` deep so z holds one chunk layer (the
    analog of ``createBuffersFromVoxels(factor)``, ``DDATestCpp.cpp:324-325``):
    a LINEAR grid (a factor-deep plane is not tileable by 8 for every
    factor), compact slots, no shared uniform bricks, as in JAX."""
    d = torch.as_tensor(dense2d)
    vol = torch.zeros((factor,) + tuple(d.shape), dtype=torch.bool, device=d.device)
    vol[0] = d
    return build_brickmap(BitGrid.from_dense(vol, layout=Layout.LINEAR), factor,
                          dense_slots=False, dedupe_uniform=False)


def _lift(origins2, rays2, device):
    """``[N, 2]`` origins and directions -> ``[N, 3]`` at z = 0.5, dz = 0."""
    o2 = torch.as_tensor(origins2, dtype=F32, device=device)
    r2 = torch.as_tensor(rays2, dtype=F32, device=device)
    o3 = torch.cat([o2, torch.full(o2.shape[:-1] + (1,), 0.5, dtype=F32, device=device)], dim=-1)
    r3 = torch.cat([r2, torch.zeros(r2.shape[:-1] + (1,), dtype=F32, device=device)], dim=-1)
    return o3, r3


def trace_grid_2d(grid: BitGrid, origins2, rays2, max_steps: int = MAX_STEPS) -> TraceOut:
    """Single-level 2D DDA (``DDATestCpp.cpp:26-134``).  ``origins2`` and
    ``rays2`` are ``[N, 2]`` (moved to the grid's device); results carry z
    components that are identically 0.5 and 0."""
    o3, r3 = _lift(origins2, rays2, grid.words.device)
    if not _is_cuda(o3):
        return trace_grid(grid, o3, r3, max_steps)
    return _trace_grid_kernel(grid, o3, r3, max_steps, limbs=False)


def trace_brickmap_2d(bm: BrickMap, origins2, rays2, max_steps: int = MAX_STEPS,
                      lt: Optional[LineTable] = None) -> TraceOut:
    """Two-level 2D trace (``DDATestCpp.cpp:136-260``).  On the card K1 runs
    through ``lt``, the world's line table (built here when not given)."""
    o3, r3 = _lift(origins2, rays2, bm.meta.device)
    if not _is_cuda(o3):
        return trace_brickmap(bm, o3, r3, max_steps)
    return trace_brickmap_k1(bm, make_line_table(bm) if lt is None else lt, o3, r3, max_steps, use_macro=False)


def radial_rays(center, count: int) -> Tuple[np.ndarray, np.ndarray]:
    """The prototype's radial ray fan (``DDATestCpp.cpp:443-452``): ``count``
    rays from ``center`` spanning 2*pi, as float32 numpy arrays."""
    ang = np.arange(count, dtype=np.float64) * (2.0 * np.pi / count)
    rays = np.stack([np.cos(ang), np.sin(ang)], -1).astype(np.float32)
    origins = np.tile(np.asarray(center, np.float32)[None], (count, 1))
    return origins, rays
