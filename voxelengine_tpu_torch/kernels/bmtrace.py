"""Wrapper of K4, the Hopper dense-slot brickmap traversal kernel
(``csrc/bmtrace.cu``).

It replaces ``voxelengine_tpu/ops/pallas_trace2.py::_bm_kernel``; its plain
version is :func:`voxelengine_tpu_torch.ops.trace.trace_brickmap`, which
:func:`voxelengine_tpu_torch.ops.trace2.trace_brickmap_mxu` runs for rays
on the CPU.  ``launches`` counts the launches made through :func:`bmtrace`
(both instantiations; ``shared_launches`` those with ``meta`` in shared
memory).
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build

launches = shared_launches = 0
# Largest meta table, in bytes, that K4 keeps in a block's shared memory
# (csrc/bmtrace.cu, VX_SMEM_META_LIMIT): the 227 KB a block can have.
SMEM_META_LIMIT = 227 * 1024


def meta_in_shared(num_chunks: int) -> bool:
    """Whether K4 runs its shared-memory-meta instantiation for a world of
    ``num_chunks`` chunks: by the table's size alone."""
    return 4 * num_chunks <= SMEM_META_LIMIT


def bmtrace(
    start, d, active, pad, meta: torch.Tensor, bricks: torch.Tensor, *,
    grid_dims, factor: int, max_steps: int, coarse_layout: Layout, brick_layout: Layout,
):
    """Trace N rays through a dense-slot brickmap on the card, one thread a
    ray, with ``meta`` copied into each block's shared memory when
    :func:`meta_in_shared` says so, else read from global memory.

    Ray inputs as for :func:`voxelengine_tpu_torch.kernels.bigtrace.
    bigtrace` (chunk units); ``meta`` is ``int32[num_chunks]`` and
    ``bricks`` ``int32[num_chunks, wpb]``, both indexed by chunk index in
    ``coarse_layout``.  Returns ``(flags i32[N], position f32[N, 3],
    normal f32[N, 3], steps i32[N])`` with ``flags = hit | hit_imm << 1``;
    the caller applies the ``hit_imm`` fix-up.  Launches on the current
    stream without synchronising and raises if the launch is refused.
    """
    global launches, shared_launches
    gx, gy, gz = grid_dims
    nc = gx * gy * gz
    wpb = (factor**3 + 31) // 32
    if nc * wpb >= 2**31 or not 1 <= factor <= 32:
        raise ValueError(f"bmtrace: grid {grid_dims} at factor {factor} is outside the kernel's int32 indices")
    if coarse_layout is not Layout.LINEAR and any(g % 8 for g in grid_dims):
        raise ValueError(f"bmtrace: coarse layout {coarse_layout.name} needs a chunk grid divisible by 8")
    dev = build.check_rays("bmtrace", start, d, active, pad)
    build.check("bmtrace", "meta", meta, torch.int32, (nc,), dev)
    build.check("bmtrace", "bricks", bricks, torch.int32, (nc, wpb), dev)
    n = start.shape[0]
    outs = build.ray_outputs(n, dev)
    if n == 0:
        return outs
    counter = torch.empty((1,), dtype=torch.int32, device=dev)  # zeroed by the launcher on the stream
    build.launch(
        "bmtrace", build.load_kernel("bmtrace").vx_trace_brickmap_dense,
        start.data_ptr(), d.data_ptr(), active.data_ptr(), pad.data_ptr(), meta.data_ptr(), bricks.data_ptr(),
        n, gx, gy, gz, factor, wpb, max_steps, coarse_layout.value, brick_layout.value,
        3 * max_steps + 64,  # iteration cap, as K1's: never reached (ops/trace.py)
        int(meta_in_shared(nc)), counter.data_ptr(), *(o.data_ptr() for o in outs), dev=dev,
    )
    launches += 1
    shared_launches += meta_in_shared(nc)
    return outs
