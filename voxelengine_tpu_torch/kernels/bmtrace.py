"""Wrapper of K4, the Hopper brickmap traversal kernel without a line
table (``csrc/bmtrace.cu``).

:func:`bmtrace` (dense slots) replaces
``voxelengine_tpu/ops/pallas_trace2.py::_bm_kernel``; :func:`bmtrace_rays`
is the same kernel from origins and raw directions, the ray setup and the
``hit_imm`` fix-up inside the launch (the entry of every path of the
package; :func:`bmtrace` and :func:`bmtrace_compact`, the prepared-ray
entries, time the walk alone in ``kernel_ab.py`` and are the other side
of ``chip_smoke.py``'s rays-entry gates).  Its plain
version is
:func:`voxelengine_tpu_torch.ops.trace.trace_brickmap`, which
:func:`voxelengine_tpu_torch.ops.trace2.trace_brickmap_mxu` runs for rays
on the CPU.  ``launches`` counts the launches made through both
(both instantiations; ``shared_launches`` those with ``meta`` in shared
memory).

:func:`bmtrace_compact` is K4's compact instantiation, for compact worlds
without a line table, with the same plain version; it has no TPU kernel
(the JAX package walks such a world in XLA, ``voxelengine_tpu/ops/
trace.py:411,435``).  :func:`bmtrace_compact_rays` is its rays form.

:func:`bmtrace_record` and :func:`bmtrace_compact_record` are the rays
forms storing the ray API's result record in the launch
(``VoxelRaytracer3D.raytrace``'s card path without a line table; plain
version ``engine/raytracer.py::results_from_trace`` over
``trace_brickmap``), counted in ``launches`` (``compact_launches``) and
in ``record_launches`` (``compact_record_launches``).

:func:`bmtrace_secondary` and :func:`bmtrace_compact_secondary` build,
walk and reduce a kind of the shading's secondary rays from the primary
trace's results in one launch (the plain version:
:func:`voxelengine_tpu_torch.ops.secondary.secondary_plain` over
``trace_brickmap``); ``secondary_launches`` and
``compact_secondary_launches`` count them by kind.
``compact_launches`` counts the launches of both
(``compact_shared_launches`` those with ``meta`` in shared memory).

:func:`bmtrace_slab` wraps K4-slab (``csrc/zslab.cu``), K4's loop over one
z-slab of a larger world for the z-sharded migration
(:mod:`voxelengine_tpu_torch.parallel.distributed`), on prepared rays;
:func:`bmtrace_slab_rays` is its batch form, which the migration runs on
the card: the whole batch's origins and directions in round 0 (the ray
setup, the ownership and the ``hit_imm`` fix-up in the launch), results at
their batch index.  ``slab_launches`` counts the prepared form's
launches, ``slab_rays_launches`` the batch form's.
"""

from __future__ import annotations

import math

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


def _k4(entry: str, rays, tables, *, grid_dims, factor: int, max_steps: int, coarse_layout: Layout,
        brick_layout: Layout, outs=None, n=None):
    """Launch one of K4's entries: ``entry`` is its launcher, ``rays`` its
    arguments before the tables (tensors, ints and None: the prepared rays,
    origins and directions with their row strides, or a secondary entry's
    inputs; an ``*_rays`` entry writes ``hit`` as bool), ``tables`` its
    table tensors (all checked by the caller), ``outs`` its outputs (a
    secondary or record entry's, with their ray count ``n``; by default the
    trace's, made here).  Returns the outputs and whether ``meta`` went to shared
    memory, or None where no ray means no launch."""
    gx, gy, gz = grid_dims
    nc = gx * gy * gz
    dev = tables[0].device
    if outs is None:
        n = rays[0].shape[0]
        outs = build.ray_outputs(n, dev, torch.bool if entry.endswith("_rays") else torch.int32)
    if n == 0:
        return outs, None
    shared = meta_in_shared(nc)
    counter = torch.empty((1,), dtype=torch.int32, device=dev)  # zeroed by the launcher on the stream
    build.launch(
        "bmtrace", getattr(build.load_kernel("bmtrace"), entry),
        *build.pointers(rays), *(t.data_ptr() for t in tables),
        n, gx, gy, gz, factor, (factor**3 + 31) // 32, max_steps, coarse_layout.value, brick_layout.value,
        3 * max_steps + 64,  # iteration cap, as K1's: never reached (ops/trace.py)
        int(shared), counter.data_ptr(), *build.pointers(outs), dev=dev,
    )
    return outs, shared


def _origin_rays(kernel: str, origins, rays) -> tuple:
    """``(device, (origins, its row stride, rays, its row stride))`` of a
    rays entry's inputs (``build.ray_rows``)."""
    dev = origins.device
    build.require_cuda(kernel, dev)
    n = origins.shape[0]
    return dev, (*build.ray_rows(kernel, "origins", origins, n, dev), *build.ray_rows(kernel, "rays", rays, n, dev))


def _check_grid(kernel: str, grid_dims, factor: int, coarse_layout: Layout, brick_words: int) -> None:
    """Raise unless K4's int32 indices hold ``brick_words`` brick words and
    the chunk grid suits ``coarse_layout``."""
    if brick_words >= 2**31 or math.prod(grid_dims) >= 2**31 or not 1 <= factor <= 32:
        raise ValueError(f"{kernel}: grid {grid_dims} at factor {factor} is outside the kernel's int32 indices")
    if coarse_layout is not Layout.LINEAR and any(g % 8 for g in grid_dims):
        raise ValueError(f"{kernel}: coarse layout {coarse_layout.name} needs a chunk grid divisible by 8")


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
    nc = math.prod(grid_dims)
    wpb = (factor**3 + 31) // 32
    _check_grid("bmtrace", grid_dims, factor, coarse_layout, nc * wpb)
    dev = build.check_rays("bmtrace", start, d, active, pad)
    build.check("bmtrace", "meta", meta, torch.int32, (nc,), dev)
    build.check("bmtrace", "bricks", bricks, torch.int32, (nc, wpb), dev)
    outs, shared = _k4("vx_trace_brickmap_dense", (start, d, active, pad), (meta, bricks), grid_dims=grid_dims,
                       factor=factor, max_steps=max_steps, coarse_layout=coarse_layout, brick_layout=brick_layout)
    if shared is not None:
        launches += 1
        shared_launches += shared
    return outs


def bmtrace_rays(
    origins, rays, meta: torch.Tensor, bricks: torch.Tensor, *,
    grid_dims, factor: int, max_steps: int, coarse_layout: Layout, brick_layout: Layout,
):
    """:func:`bmtrace` from ``origins`` (voxels) and raw directions ``rays``
    (``f32[N, 3]``, rows of 3 contiguous floats or one broadcast row; see
    :func:`voxelengine_tpu_torch.kernels.bigtrace.bigtrace_rays`): the ray
    setup and the ``hit_imm`` fix-up run in the launch.  Returns ``(hit
    bool[N], position, normal, steps)``, the ``TraceOut`` fields."""
    global launches, shared_launches
    nc = math.prod(grid_dims)
    wpb = (factor**3 + 31) // 32
    _check_grid("bmtrace_rays", grid_dims, factor, coarse_layout, nc * wpb)
    dev, rows = _origin_rays("bmtrace_rays", origins, rays)
    build.check("bmtrace_rays", "meta", meta, torch.int32, (nc,), dev)
    build.check("bmtrace_rays", "bricks", bricks, torch.int32, (nc, wpb), dev)
    outs, shared = _k4("vx_trace_brickmap_dense_rays", rows, (meta, bricks), grid_dims=grid_dims, factor=factor,
                       max_steps=max_steps, coarse_layout=coarse_layout, brick_layout=brick_layout)
    if shared is not None:
        launches += 1
        shared_launches += shared
    return outs


record_launches = compact_record_launches = 0


def bmtrace_record(
    origins, rays, meta: torch.Tensor, bricks: torch.Tensor, *,
    grid_dims, factor: int, max_steps: int, coarse_layout: Layout, brick_layout: Layout,
):
    """:func:`bmtrace_rays` storing the ray API's result record in the
    launch, as :func:`voxelengine_tpu_torch.kernels.bigtrace.
    bigtrace_record`: returns ``(valid bool[N], hit_point f32[N, 3], normal
    f32[N, 3], distance f32[N], voxel_index i32[N], steps i32[N])``."""
    global launches, shared_launches, record_launches
    nc = math.prod(grid_dims)
    wpb = (factor**3 + 31) // 32
    _check_grid("bmtrace_record", grid_dims, factor, coarse_layout, nc * wpb)
    dev, rows = _origin_rays("bmtrace_record", origins, rays)
    build.check("bmtrace_record", "meta", meta, torch.int32, (nc,), dev)
    build.check("bmtrace_record", "bricks", bricks, torch.int32, (nc, wpb), dev)
    outs, shared = _k4("vx_trace_brickmap_dense_record", rows, (meta, bricks), grid_dims=grid_dims, factor=factor,
                       max_steps=max_steps, coarse_layout=coarse_layout, brick_layout=brick_layout,
                       outs=build.record_outputs(origins.shape[0], dev), n=origins.shape[0])
    if shared is not None:
        launches += 1
        shared_launches += shared
        record_launches += 1
    return outs


compact_launches = compact_shared_launches = 0


def bmtrace_compact(
    start, d, active, pad, meta: torch.Tensor, brick_idx: torch.Tensor, bricks: torch.Tensor, *,
    grid_dims, factor: int, max_steps: int, coarse_layout: Layout, brick_layout: Layout,
):
    """:func:`bmtrace` over a compact brickmap (K4's compact instantiation):
    ``brick_idx`` (``int32[num_chunks]``, by chunk index; -1 for an empty
    chunk) gives each chunk's row of ``bricks`` (``int32[num_bricks,
    wpb]``).  Same rays, outputs and instantiation choice."""
    global compact_launches, compact_shared_launches
    nc = math.prod(grid_dims)
    wpb = (factor**3 + 31) // 32
    _check_grid("bmtrace_compact", grid_dims, factor, coarse_layout, bricks.shape[0] * wpb)
    dev = build.check_rays("bmtrace_compact", start, d, active, pad)
    build.check("bmtrace_compact", "meta", meta, torch.int32, (nc,), dev)
    build.check("bmtrace_compact", "brick_idx", brick_idx, torch.int32, (nc,), dev)
    build.check("bmtrace_compact", "bricks", bricks, torch.int32, (None, wpb), dev)
    outs, shared = _k4("vx_trace_brickmap_compact", (start, d, active, pad), (meta, brick_idx, bricks),
                       grid_dims=grid_dims, factor=factor, max_steps=max_steps, coarse_layout=coarse_layout,
                       brick_layout=brick_layout)
    if shared is not None:
        compact_launches += 1
        compact_shared_launches += shared
    return outs


def bmtrace_compact_rays(
    origins, rays, meta: torch.Tensor, brick_idx: torch.Tensor, bricks: torch.Tensor, *,
    grid_dims, factor: int, max_steps: int, coarse_layout: Layout, brick_layout: Layout,
):
    """:func:`bmtrace_compact` from origins and raw directions, as
    :func:`bmtrace_rays`."""
    global compact_launches, compact_shared_launches
    nc = math.prod(grid_dims)
    wpb = (factor**3 + 31) // 32
    _check_grid("bmtrace_compact_rays", grid_dims, factor, coarse_layout, bricks.shape[0] * wpb)
    dev, rows = _origin_rays("bmtrace_compact_rays", origins, rays)
    build.check("bmtrace_compact_rays", "meta", meta, torch.int32, (nc,), dev)
    build.check("bmtrace_compact_rays", "brick_idx", brick_idx, torch.int32, (nc,), dev)
    build.check("bmtrace_compact_rays", "bricks", bricks, torch.int32, (None, wpb), dev)
    outs, shared = _k4("vx_trace_brickmap_compact_rays", rows, (meta, brick_idx, bricks), grid_dims=grid_dims,
                       factor=factor, max_steps=max_steps, coarse_layout=coarse_layout, brick_layout=brick_layout)
    if shared is not None:
        compact_launches += 1
        compact_shared_launches += shared
    return outs


def bmtrace_compact_record(
    origins, rays, meta: torch.Tensor, brick_idx: torch.Tensor, bricks: torch.Tensor, *,
    grid_dims, factor: int, max_steps: int, coarse_layout: Layout, brick_layout: Layout,
):
    """:func:`bmtrace_record` over a compact brickmap (tables as for
    :func:`bmtrace_compact`)."""
    global compact_launches, compact_shared_launches, compact_record_launches
    nc = math.prod(grid_dims)
    wpb = (factor**3 + 31) // 32
    _check_grid("bmtrace_compact_record", grid_dims, factor, coarse_layout, bricks.shape[0] * wpb)
    dev, rows = _origin_rays("bmtrace_compact_record", origins, rays)
    build.check("bmtrace_compact_record", "meta", meta, torch.int32, (nc,), dev)
    build.check("bmtrace_compact_record", "brick_idx", brick_idx, torch.int32, (nc,), dev)
    build.check("bmtrace_compact_record", "bricks", bricks, torch.int32, (None, wpb), dev)
    outs, shared = _k4("vx_trace_brickmap_compact_record", rows, (meta, brick_idx, bricks), grid_dims=grid_dims,
                       factor=factor, max_steps=max_steps, coarse_layout=coarse_layout, brick_layout=brick_layout,
                       outs=build.record_outputs(origins.shape[0], dev), n=origins.shape[0])
    if shared is not None:
        compact_launches += 1
        compact_shared_launches += shared
        compact_record_launches += 1
    return outs


# launches of the secondary entries by kind (each counted in ``launches`` or
# ``compact_launches`` too)
secondary_launches = dict.fromkeys(build.SECONDARY_KINDS, 0)
compact_secondary_launches = dict.fromkeys(build.SECONDARY_KINDS, 0)


def _secondary(kernel: str, entry: str, kind: str, position, normal, tables, inputs: dict, *, grid_dims,
               factor: int, max_steps: int, coarse_layout: Layout, brick_layout: Layout):
    """Check and launch one of K4's secondary entries; returns the kind's
    results and whether ``meta`` went to shared memory (None: no launch)."""
    dev, n, head, outs, res = build.secondary_args(kernel, kind, position, normal, **inputs)
    for t in tables:
        if t.device != dev:
            raise ValueError(f"{kernel}: the tables must be on {dev}, got {t.device}")
    _, shared = _k4(entry, head, tables, grid_dims=grid_dims, factor=factor, max_steps=max_steps,
                    coarse_layout=coarse_layout, brick_layout=brick_layout, outs=outs, n=n)
    return res, shared


def bmtrace_secondary(
    kind: str, position, normal, meta: torch.Tensor, bricks: torch.Tensor, *, grid_dims, factor: int,
    max_steps: int, coarse_layout: Layout, brick_layout: Layout, **inputs,
):
    """One kind of the shading's secondary rays for N primary rays through
    a dense-slot brickmap on the card in one launch (``csrc/secondary.cuh``,
    as :func:`voxelengine_tpu_torch.kernels.bigtrace.bigtrace_secondary`):
    ``inputs`` are the kind's (``light``; ``dirs``; ``px``, ``py``,
    ``width``, ``frame_number``, ``ao_samples``: ``build.secondary_args``),
    ``max_steps`` its walk budget (8 for AO); tables as for
    :func:`bmtrace`."""
    global launches, shared_launches
    nc = math.prod(grid_dims)
    wpb = (factor**3 + 31) // 32
    _check_grid("bmtrace_secondary", grid_dims, factor, coarse_layout, nc * wpb)
    build.check("bmtrace_secondary", "meta", meta, torch.int32, (nc,), meta.device)
    build.check("bmtrace_secondary", "bricks", bricks, torch.int32, (nc, wpb), meta.device)
    res, shared = _secondary("bmtrace_secondary", "vx_trace_brickmap_dense_secondary", kind, position, normal,
                             (meta, bricks), inputs, grid_dims=grid_dims, factor=factor, max_steps=max_steps,
                             coarse_layout=coarse_layout, brick_layout=brick_layout)
    if shared is not None:
        launches += 1
        shared_launches += shared
        secondary_launches[kind] += 1
    return res


def bmtrace_compact_secondary(
    kind: str, position, normal, meta: torch.Tensor, brick_idx: torch.Tensor, bricks: torch.Tensor, *, grid_dims,
    factor: int, max_steps: int, coarse_layout: Layout, brick_layout: Layout, **inputs,
):
    """:func:`bmtrace_secondary` over a compact brickmap (tables as for
    :func:`bmtrace_compact`)."""
    global compact_launches, compact_shared_launches
    nc = math.prod(grid_dims)
    wpb = (factor**3 + 31) // 32
    _check_grid("bmtrace_compact_secondary", grid_dims, factor, coarse_layout, bricks.shape[0] * wpb)
    build.check("bmtrace_compact_secondary", "meta", meta, torch.int32, (nc,), meta.device)
    build.check("bmtrace_compact_secondary", "brick_idx", brick_idx, torch.int32, (nc,), meta.device)
    build.check("bmtrace_compact_secondary", "bricks", bricks, torch.int32, (None, wpb), meta.device)
    res, shared = _secondary("bmtrace_compact_secondary", "vx_trace_brickmap_compact_secondary", kind, position,
                             normal, (meta, brick_idx, bricks), inputs, grid_dims=grid_dims, factor=factor,
                             max_steps=max_steps, coarse_layout=coarse_layout, brick_layout=brick_layout)
    if shared is not None:
        compact_launches += 1
        compact_shared_launches += shared
        compact_secondary_launches[kind] += 1
    return res


slab_launches = 0
# a ray's state row (csrc/zslab.cuh::pack_state): its length, and the
# fields that say where a paused ray stopped
STATE_WORDS = 35
STATE_CELL = slice(13, 16)  # the coarse cell (x, y, z)
STATE_TMAX = slice(16, 19)  # its tMax, float bits
STATE_TLAST = 19  # the last coarse step's crossing time, float bits
STATE_STEPS = 27


def bmtrace_slab(
    meta: torch.Tensor, bricks: torch.Tensor, *, grid_dims, z0: int, slab_gz: int, factor: int, max_steps: int,
    brick_layout: Layout, rays=None, rows=None,
):
    """One round of the z-sharded walk on the card (K4-slab,
    ``csrc/zslab.cu``).  Its plain version is
    :func:`voxelengine_tpu_torch.ops.trace.run_slab`; it has no TPU
    kernel (the JAX package runs the round as XLA,
    ``voxelengine_tpu/ops/trace.py:221``).

    ``meta`` (``int32[gx * gy * slab_gz]``) and ``bricks`` (``int32[gx *
    gy * slab_gz, wpb]``) are chunk rows ``z0 .. z0 + slab_gz - 1`` of a
    LINEAR dense-slot world whose chunk grid is ``grid_dims``.  Round 0
    passes ``rays = (start, d, active, pad)`` from K4's ray setup over the
    whole grid; later rounds pass ``rows``, the ``int32[m, STATE_WORDS]``
    states of rays paused elsewhere.  Returns ``(rows, status, flags,
    position, normal, steps)``: each ray's status (0 done, 1 paused at the
    slab's boundary), a paused ray's state after the round (the rows of
    rays that are done are left unwritten) and, for a ray that is done, its
    result with ``flags = hit | hit_imm << 1``.  Launches on the current
    stream without synchronising and raises if the launch is refused."""
    global slab_launches
    gx, gy, gz = grid_dims
    per = gx * gy * slab_gz
    wpb = (factor**3 + 31) // 32
    if gx * gy * gz * wpb >= 2**31 or not 1 <= factor <= 32 or not 0 <= z0 <= gz - slab_gz:
        raise ValueError(f"bmtrace_slab: slab z0={z0} +{slab_gz} of grid {grid_dims} at factor {factor} is outside "
                         "the kernel's int32 indices or the grid")
    if (rays is None) == (rows is None):
        raise ValueError("bmtrace_slab: pass the ray setup (round 0) or the handed-on state rows, not both")
    if rays is not None:
        dev = build.check_rays("bmtrace_slab", *rays)
        m = rays[0].shape[0]
        ptrs = [t.data_ptr() for t in rays] + [None]
    else:
        dev = rows.device
        build.require_cuda("bmtrace_slab", dev)
        m = rows.shape[0]
        build.check("bmtrace_slab", "rows", rows, torch.int32, (m, STATE_WORDS), dev)
        ptrs = [None] * 4 + [rows.data_ptr()]
    build.check("bmtrace_slab", "meta", meta, torch.int32, (per,), dev)
    build.check("bmtrace_slab", "bricks", bricks, torch.int32, (per, wpb), dev)
    rows_out = torch.empty((m, STATE_WORDS), dtype=torch.int32, device=dev)
    status = torch.empty((m,), dtype=torch.int32, device=dev)
    outs = build.ray_outputs(m, dev)
    if m == 0:
        return (rows_out, status) + outs
    counter = torch.empty((1,), dtype=torch.int32, device=dev)  # zeroed by the launcher on the stream
    build.launch(
        "bmtrace_slab", build.load_kernel("zslab").vx_zslab, *ptrs, meta.data_ptr(), bricks.data_ptr(),
        m, gx, gy, gz, z0, slab_gz, factor, wpb, max_steps, brick_layout.value,
        3 * max_steps + 64,  # iteration cap, as K4's: never reached
        counter.data_ptr(), rows_out.data_ptr(), status.data_ptr(), *(o.data_ptr() for o in outs), dev=dev,
    )
    slab_launches += 1
    return (rows_out, status) + outs


slab_rays_launches = 0


def bmtrace_slab_rays(
    meta: torch.Tensor, bricks: torch.Tensor, origins, rays, outs, *, grid_dims, z0: int, slab_gz: int, factor: int,
    max_steps: int, brick_layout: Layout, rows=None, idx=None,
):
    """One round of the z-sharded walk on the card in K4-slab's batch form
    (``csrc/zslab.cu::vx_zslab_rays``).  Its plain version is the
    migration's CPU round: ``ops/trace.py::_init_state`` over the whole
    grid, the ownership of the entry cell, :func:`voxelengine_tpu_torch.
    ops.trace.run_slab` and ``kernel_result``.

    ``meta`` and ``bricks`` as for :func:`bmtrace_slab`; ``origins`` and
    ``rays`` are the whole batch (``f32[N, 3]``, voxels and raw
    directions; rows of 3 floats or one broadcast row); ``outs`` the
    batch-wide ``(hit i32[N], position f32[N, 3], normal f32[N, 3], steps
    i32[N])``, contiguous, which the launch writes at the index of each ray
    that is done (its hit 0 or 1, the ``hit_imm`` fix-up applied) and leaves
    as they are elsewhere.  Round 0: ``rows`` and ``idx`` None; every ray is
    set up over the whole grid and the rays whose entry cell lies in the
    slab are walked.  Later rounds: ``rows`` (``int32[m, STATE_WORDS]``),
    the handed-on states, and ``idx`` (``int32[m]``) their batch indices.
    Returns ``(rows, idx, counts)``: room for every ray of the round, of
    which the first ``counts[1]`` hold the paused rays' states and batch
    indices (in no set order), and ``counts`` (``int32[3]`` on the card;
    ``[2]`` the rays round 0 walked), which the caller reads.  Launches on
    the current stream without synchronising and raises if the launch is
    refused."""
    global slab_rays_launches
    gx, gy, gz = grid_dims
    per = gx * gy * slab_gz
    wpb = (factor**3 + 31) // 32
    if gx * gy * gz * wpb >= 2**31 or not 1 <= factor <= 32 or not 0 <= z0 <= gz - slab_gz or gz % slab_gz:
        raise ValueError(f"bmtrace_slab_rays: slab z0={z0} +{slab_gz} of grid {grid_dims} at factor {factor} is "
                         "outside the kernel's int32 indices or the grid")
    if (rows is None) != (idx is None):
        raise ValueError("bmtrace_slab_rays: a later round passes both the state rows and their batch indices")
    dev, ray_args = _origin_rays("bmtrace_slab_rays", origins, rays)
    n = origins.shape[0]
    for name, t, shape in zip(("hit", "position", "normal", "steps"), outs, ((n,), (n, 3), (n, 3), (n,))):
        build.check("bmtrace_slab_rays", name, t, torch.float32 if len(shape) == 2 else torch.int32, shape, dev)
    m = n
    if rows is not None:
        m = rows.shape[0]
        build.check("bmtrace_slab_rays", "rows", rows, torch.int32, (m, STATE_WORDS), dev)
        build.check("bmtrace_slab_rays", "idx", idx, torch.int32, (m,), dev)
    build.check("bmtrace_slab_rays", "meta", meta, torch.int32, (per,), dev)
    build.check("bmtrace_slab_rays", "bricks", bricks, torch.int32, (per, wpb), dev)
    rows_out = torch.empty((m, STATE_WORDS), dtype=torch.int32, device=dev)
    idx_out = torch.empty((m,), dtype=torch.int32, device=dev)
    counts = torch.zeros((3,), dtype=torch.int32, device=dev)  # zeroed again by the launcher on the stream
    if m == 0:
        return rows_out, idx_out, counts
    build.launch(
        "bmtrace_slab_rays", build.load_kernel("zslab").vx_zslab_rays, *build.pointers(ray_args),
        *build.pointers((rows, idx)), meta.data_ptr(), bricks.data_ptr(), m, gx, gy, gz, z0, slab_gz, factor, wpb,
        max_steps, brick_layout.value, 3 * max_steps + 64,  # iteration cap, as K4's: never reached
        counts.data_ptr(), rows_out.data_ptr(), idx_out.data_ptr(), *build.pointers(outs), dev=dev,
    )
    slab_rays_launches += 1
    return rows_out, idx_out, counts
