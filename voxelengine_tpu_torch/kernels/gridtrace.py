"""Wrappers of K2 and K3, the Hopper dense-grid traversal kernels
(``csrc/gridtrace.cu`` over ``csrc/grid_dda.cuh`` and ``csrc/ray_setup.cuh``).

:func:`gridtrace` (K2) replaces ``voxelengine_tpu/ops/pallas_trace.py::
_grid_kernel_vpu`` and reads the int32 words; :func:`gridtrace_limbs` (K3)
replaces ``pallas_trace.py::_grid_kernel`` and takes the words as four
uint8 limb planes.  Each computes its wrapper's whole function in one
launch: the ray setup, the walk and the zero-step fix-up.  K3 has two
instantiations (:func:`words_in_shared`): grids of up to
:data:`SMEM_WORDS_LIMIT` bytes of words are rebuilt once into each
persistent block's shared memory, larger grids are read from the planes at
every step.  Their plain version is
:func:`voxelengine_tpu_torch.ops.trace.trace_grid`, which
:mod:`voxelengine_tpu_torch.ops.gridtrace` runs for rays on the CPU.
``launches`` and ``limb_launches`` count the launches of K2 and K3 (both
instantiations), ``staged_launches`` those of K3's shared-memory one.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.core.bitgrid import words_for_bits
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build

launches = 0
limb_launches = staged_launches = 0
# Largest word table, in bytes, that K3 rebuilds into a block's shared
# memory (csrc/gridtrace.cu, VX_SMEM_WORDS_LIMIT): 51,200 words, 1.6M voxels.
SMEM_WORDS_LIMIT = 200 * 1024


def words_in_shared(num_words: int) -> bool:
    """Whether K3 runs its shared-memory instantiation for a grid of
    ``num_words`` words (staged in groups of 16)."""
    return 64 * -(-num_words // 16) <= SMEM_WORDS_LIMIT


def _grid_args(kernel: str, origins, rays, dims, layout: Layout):
    """Check the grid dims and the rays; returns (device, (origins, its row
    stride, rays, its row stride), N, X, Y, Z, number of words the grid
    needs)."""
    X, Y, Z = dims
    if X * Y * Z >= 2**31:
        raise ValueError(f"{kernel}: {X}x{Y}x{Z} voxels overflow the kernel's int32 bit index")
    if layout is not Layout.LINEAR and any(v % 8 for v in dims):
        raise ValueError(f"{kernel}: layout {layout.name} needs dims divisible by 8, got {dims}")
    dev = origins.device
    build.require_cuda(kernel, dev)
    n = origins.shape[0]
    rows = (*build.ray_rows(kernel, "origins", origins, n, dev), *build.ray_rows(kernel, "rays", rays, n, dev))
    return dev, rows, n, X, Y, Z, words_for_bits(X * Y * Z)


def gridtrace(origins, rays, words: torch.Tensor, *, dims, layout: Layout, max_steps: int):
    """K2: ``trace_grid_vpu`` for N rays through a dense grid's words on the
    card, one thread a ray, one launch.

    ``origins`` and ``rays`` (directions, not necessarily normalized) are
    ``f32[N, 3]`` in voxel units whose rows are 3 contiguous floats (or
    ``origins`` one row broadcast, row stride 0; anything else is copied
    first); ``words`` the grid's flat ``int32`` words
    (at least ``ceil(X*Y*Z/32)`` of them), in ``layout`` order.  Returns
    ``(hit bool[N], position f32[N, 3], normal f32[N, 3], steps i32[N])``:
    the fields of ``trace_grid``'s ``TraceOut``.  Launches on the current
    stream without synchronising and raises if the launch is refused.
    """
    global launches
    dev, rows, n, X, Y, Z, nw = _grid_args("gridtrace", origins, rays, dims, layout)
    build.check("gridtrace", "words", words, torch.int32, (None,), dev)
    if words.numel() < nw:
        raise ValueError(f"gridtrace: {words.numel()} words, the {X}x{Y}x{Z} grid needs {nw}")
    outs = build.ray_outputs(n, dev, torch.bool)
    if n == 0:
        return outs
    build.launch(
        "gridtrace", build.load_kernel("gridtrace").vx_trace_grid,
        rows[0].data_ptr(), rows[1], rows[2].data_ptr(), rows[3], words.data_ptr(),
        n, X, Y, Z, layout.value, max_steps, *(o.data_ptr() for o in outs), dev=dev,
    )
    launches += 1
    return outs


def gridtrace_limbs(origins, rays, limbs: torch.Tensor, *, dims, layout: Layout, max_steps: int):
    """K3: :func:`gridtrace` with the words given as ``uint8[4, R, 128]``
    limb planes (``ops/gridtrace.py::words_to_limb_rows``), 16-byte
    aligned; the instantiation by :func:`words_in_shared`."""
    global limb_launches, staged_launches
    dev, rows, n, X, Y, Z, nw = _grid_args("gridtrace_limbs", origins, rays, dims, layout)
    build.check("gridtrace_limbs", "limbs", limbs, torch.uint8, (4, None, 128), dev)
    if limbs.data_ptr() % 16:
        raise ValueError("gridtrace_limbs: the limb planes must be 16-byte aligned")
    plane = limbs.shape[1] * 128
    if plane < nw:
        raise ValueError(f"gridtrace_limbs: {plane} words per limb plane, the {X}x{Y}x{Z} grid needs {nw}")
    outs = build.ray_outputs(n, dev, torch.bool)
    if n == 0:
        return outs
    staged = words_in_shared(nw)
    counter = torch.empty((1,), dtype=torch.int32, device=dev)  # zeroed by the launcher on the stream
    build.launch(
        "gridtrace_limbs", build.load_kernel("gridtrace").vx_trace_grid_limbs,
        rows[0].data_ptr(), rows[1], rows[2].data_ptr(), rows[3], limbs.data_ptr(), plane,
        n, X, Y, Z, layout.value, max_steps, int(staged), -(-nw // 16), counter.data_ptr(),
        *(o.data_ptr() for o in outs), dev=dev,
    )
    limb_launches += 1
    staged_launches += staged
    return outs
