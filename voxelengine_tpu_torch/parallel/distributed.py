"""A world partitioned into coarse-z slabs, one a rank, and the two ways to
trace it.

Counterpart of ``voxelengine_tpu/parallel/distributed.py``.  The brickmap
is cut into coarse-z slabs (:func:`shard_world_z`), so a world larger than
one card can be traced.  Each function is called by every rank with the
same arguments (SPMD).

**Ray migration** (:func:`trace_brickmap_zsharded`, dense-slot worlds):

1. a ray belongs to the rank whose slab holds its coarse cell, from its
   entry cell on;
2. each round, a rank advances the rays it owns against its slab until
   each hits, leaves the grid, spends its budget or pauses at the slab's
   boundary with its state intact (K4-slab for CUDA tensors,
   :mod:`voxelengine_tpu_torch.kernels.bmtrace`; the plain
   :func:`~voxelengine_tpu_torch.ops.trace.run_slab` for CPU tensors);
3. the paused rays go to rank +-1 with their state: a count, then their
   indices and state rows, point to point
   (:func:`~voxelengine_tpu_torch.parallel.mesh.ppermute_neighbours`);
   the JAX package ppermutes every ray's whole state each round instead,
   which gives the same results;
4. after N rounds (a ray's z moves one way, so it enters each slab at
   most once), a masked ``psum`` assembles each result from the ray's
   last owner.

The results are the single-device walk's, steps included.  Unlike the JAX
package, a ray whose coarse cell is the grid's edge pad cell (``z ==
gz``, or x or y at the grid's size, reached by entering on that far face
heading back) is traced as the whole grid traces it: JAX pauses it and
never hands it on, which reports it a miss (:func:`~voxelengine_tpu_torch.
ops.trace.slab_resident`).

**Replicated walk** (:func:`trace_brickmap_hbm_zsharded`, through K1): every
rank walks the whole grid over a line table in which the other slabs read
empty (:func:`make_zsharded_hbm`), so it finds exactly the hits in its own
slab; one min-t reduction picks each ray's first hit.  Hits, positions and
normals equal the single-device kernel's; ``steps`` is the hit slab's
charge (fine steps spent grazing another slab's chunk are charged there as
one coarse step), and each slab's walk has its own budget.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from voxelengine_tpu_torch.config import MAX_STEPS
from voxelengine_tpu_torch.core.brickmap import META_OCC_BIT, BrickMap
from voxelengine_tpu_torch.core.exact import dot3
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.ops.bigtrace import (
    LineTable,
    brick_lines_view,
    make_line_table,
    trace_brickmap_k1,
    trace_brickmap_lt,
)
from voxelengine_tpu_torch.ops.trace import SLAB_CELL_Z, TraceOut, _init_state, kernel_result, run_slab
from voxelengine_tpu_torch.parallel.mesh import Mesh, pmax, pmin, ppermute_neighbours, psum

F32 = torch.float32
I32 = torch.int32


def shard_world_z(bm: BrickMap, n: int):
    """Split a dense-slot LINEAR brickmap into ``n`` coarse-z slabs:
    ``(meta_stack [n, cpslab], bricks_stack [n, cpslab, wpb], slab_gz)``,
    views of ``bm``'s tables.  Needs ``grid_dims[2] % n == 0``."""
    if not bm.dense_slots:
        raise ValueError("z-sharding requires a dense-slot brickmap")
    if bm.coarse_layout is not Layout.LINEAR:
        raise ValueError("z-sharding requires the LINEAR coarse layout")
    gx, gy, gz = bm.grid_dims
    if gz % n:
        raise ValueError(f"gz={gz} must divide across {n} ranks")
    slab_gz = gz // n
    per = gx * gy * slab_gz
    return bm.meta.reshape(n, per), bm.bricks.reshape(n, per, bm.words_per_brick), slab_gz


def _slab_bm(spec, meta, bricks, slab_gz: int) -> BrickMap:
    """A slab's tables as a dense-slot brickmap ``slab_gz`` chunks deep."""
    gx, gy, gz, factor, coarse_layout, brick_layout = spec
    return BrickMap(
        meta=meta, brick_idx=torch.arange(gx * gy * slab_gz, dtype=I32, device=meta.device), bricks=bricks,
        grid_dims=(gx, gy, slab_gz), factor=factor, coarse_layout=coarse_layout, brick_layout=brick_layout,
        dense_slots=True,
    )


def _hand_off(mesh: Mesh, idx: torch.Tensor, rows: torch.Tensor, up: torch.Tensor, down: torch.Tensor):
    """Send the ``up`` rays to rank + 1 and the ``down`` rays to rank - 1:
    a count each way, then ``[count, 1 + words]`` int32 payloads (the ray
    index, then its state row).  Returns the rays received, as ``(idx,
    rows)``, and the counts sent ``(up, down)``."""
    counts = [torch.tensor([int(m.sum())], dtype=I32, device=rows.device) for m in (up, down)]
    below, above = ppermute_neighbours(*counts, mesh)
    payload = [torch.cat([idx[m].to(I32)[:, None], rows[m]], dim=1) for m in (up, down)]
    w = rows.shape[1] + 1
    got = ppermute_neighbours(*payload, mesh, recv_shapes=((int(below[0]), w), (int(above[0]), w)))
    new = torch.cat(got)
    return new[:, 0].long(), new[:, 1:].contiguous(), (int(counts[0][0]), int(counts[1][0]))


def _trace_zsharded(spec, meta, bricks, origins, rays, mesh: Mesh, max_steps: int, stats: Optional[list]):
    """The migration loop over this rank's slab tables ``meta``, ``bricks``
    (module doc).  Rays on a CUDA device run K4-slab, rays on the CPU its
    plain version; both hand on the same ``(rows, status, ...)``."""
    from voxelengine_tpu_torch.kernels import bmtrace

    gx, gy, gz, factor, _, brick_layout = spec
    n, my = mesh.size, mesh.rank
    slab_gz = gz // n
    z0 = my * slab_gz
    dev = origins.device
    n_rays = origins.shape[0]
    bm_local = _slab_bm(spec, meta, bricks, slab_gz)
    # round 0: K4's ray setup over the whole grid (ops/trace2.py)
    st0 = _init_state(bm_local, origins, rays, full_gz=gz)
    # exclusive, total ownership from the slab of the entry cell
    idx = torch.nonzero(st0["active"] & (torch.clamp(st0["ccell"][:, 2] // slab_gz, 0, n - 1) == my)).squeeze(1)
    kernel = origins.is_cuda
    if kernel:
        setup = (st0["start_c"], st0["d"], st0["active"].to(I32), st0["cpad"])
        kw = dict(grid_dims=(gx, gy, gz), z0=z0, slab_gz=slab_gz, factor=factor, max_steps=max_steps,
                  brick_layout=brick_layout)
    cz_col = bmtrace.STATE_CELL.start + 2 if kernel else SLAB_CELL_Z
    flags = torch.zeros((n_rays,), dtype=I32, device=dev)
    steps = torch.zeros((n_rays,), dtype=I32, device=dev)
    pos = torch.zeros((n_rays, 3), dtype=F32, device=dev)
    nrm = torch.zeros((n_rays, 3), dtype=F32, device=dev)
    rows = None
    for rnd in range(n):
        if kernel:
            src = dict(rays=tuple(t[idx].contiguous() for t in setup)) if rnd == 0 else dict(rows=rows)
            out = bmtrace.bmtrace_slab(meta, bricks, **src, **kw)
        else:
            out = run_slab(bm_local, {k: v[idx] for k, v in st0.items()} if rnd == 0 else rows, max_steps, z0, gz)
        rows, status, r_flags, r_pos, r_nrm, r_steps = out
        paused = status == 1
        done = ~paused
        flags[idx[done]] = r_flags[done]
        pos[idx[done]] = r_pos[done]
        nrm[idx[done]] = r_nrm[done]
        steps[idx[done]] = r_steps[done]
        if rnd == n - 1:
            if bool(paused.any()):
                raise RuntimeError(f"rank {my}: {int(paused.sum())} rays still paused after {n} rounds")
            break
        cz = rows[:, cz_col]
        up, down = paused & (cz >= z0 + slab_gz), paused & (cz < z0)
        idx, rows, sent = _hand_off(mesh, idx, rows, up, down)
        if stats is not None:
            stats.append({"round": rnd, "traced": int(paused.numel()), "sent_up": sent[0], "sent_down": sent[1],
                          "received": int(idx.numel()), "row_bytes": 4 * (rows.shape[1] + 1)})
    # final assembly: each result from the ray's last owner
    flags, steps, pos, nrm = (psum(t, mesh) for t in (flags, steps, pos, nrm))
    return kernel_result(flags, pos, nrm, steps, st0["start_c"], st0["start_normal"], factor)


def trace_brickmap_zsharded(bm: BrickMap, origins: torch.Tensor, rays: torch.Tensor, mesh: Mesh,
                            max_steps: int = MAX_STEPS, stats: Optional[list] = None) -> TraceOut:
    """Trace rays through a z-slab-sharded world by ray migration (module
    doc): ``trace_brickmap`` semantics, results the same on every rank.
    ``bm`` is the dense-slot LINEAR world, of which each rank reads only
    its slab's rows (views of ``meta`` and ``bricks``); ``origins`` and
    ``rays`` are the whole batch on every rank.  ``stats``, when given, receives a
    record a round: the rays this rank traced, sent up and down, received,
    and the bytes a sent ray takes."""
    meta_stack, bricks_stack, _ = shard_world_z(bm, mesh.size)
    spec = bm.grid_dims + (bm.factor, bm.coarse_layout, bm.brick_layout)
    return _trace_zsharded(spec, meta_stack[mesh.rank], bricks_stack[mesh.rank], origins, rays, mesh, max_steps,
                           stats)


def render_frame_zsharded(
    bm: Optional[BrickMap],
    framebuffer: torch.Tensor,
    origin: torch.Tensor,
    euler: torch.Tensor,
    env,
    frame_number: int,
    cfg,
    mesh: Mesh,
    zw: Optional["ZShardedHBM"] = None,
) -> torch.Tensor:
    """``render_frame`` over a z-slab-sharded world, shadow, AO and
    reflection rays included (each is one more sharded trace), into the
    whole ``framebuffer`` on every rank, in place.  Rays trace by
    migration (:func:`trace_brickmap_zsharded`, ``bm``), or with ``zw``
    through K1's replicated walk (:func:`trace_brickmap_hbm_zsharded`;
    ``bm`` is then not read).  The replicated walk matches the
    single-device frame up to its documented steps delta, which only the
    STEPS view shows, and the per-slab budget of budget-cut secondary
    rays."""
    from voxelengine_tpu_torch.render.frame import composite_frame, primary_rays, shade_traced

    if zw is not None:
        def trace(o, d, ms):
            return trace_brickmap_hbm_zsharded(zw, o, d, mesh, ms, use_macro=cfg.trace_use_macro)
    else:
        def trace(o, d, ms):
            return trace_brickmap_zsharded(bm, o, d, mesh, ms)

    origins, dirs, px, py, py_r = primary_rays(cfg, origin, euler, frame_number)
    out = trace(origins, dirs, cfg.max_steps)
    needs_secondary = cfg.shadow_rays or cfg.ao_samples > 0 or cfg.reflections
    color, write = shade_traced(None, out, origins, dirs, px, py, py_r, origin, env, frame_number, cfg,
                                secondary=trace if needs_secondary else None)
    return composite_frame(framebuffer, color, write, cfg, frame_number)


# ---------------------------------------------------------------------------
# K1's replicated walk over masked slabs (module doc).  The coarse cell
# sequence of the walk does not depend on occupancy (a descend and its
# ascend leave the coarse walk where it was; macro skips land on the same
# state), so a rank that walks the whole grid over a world whose other
# slabs read empty visits the coarse cells the single-device walk visits,
# descends only into its own slab's chunks, and finds exactly the hits that
# lie there.


@dataclasses.dataclass(frozen=True)
class ZShardedHBM:
    """Per-rank slab worlds for the replicated walk, one row a rank in
    ``ranks``: the slab's bricks, re-compacted to local slots and held as
    brick lines (the O(world) part, really partitioned), and a line table
    of the whole grid in which the other slabs read empty.  The tensors
    have a leading axis over ``ranks``: all N rows (the stacked form, JAX's
    ``P("shards")`` layout, for tests) or the one row a rank builds for
    itself."""

    brick_lines_stack: torch.Tensor  # int32[len(ranks), NBL * 8, 128]
    region_lines_stack: torch.Tensor  # int32[len(ranks), NR * 8, 128]
    macro_stack: torch.Tensor  # int32[len(ranks), nv * 8, 128]
    macro2_stack: torch.Tensor  # int32[len(ranks), 36]
    grid_dims: Tuple[int, int, int]
    factor: int
    brick_layout: Layout
    num_regions: int
    region_dims: Tuple[int, int, int]
    ranks: Tuple[int, ...]

    def line_table(self, rank: int) -> LineTable:
        """Rank ``rank``'s line table, its brick lines attached."""
        if rank not in self.ranks:
            raise ValueError(f"this ZShardedHBM holds the rows of ranks {self.ranks}, not {rank}")
        i = self.ranks.index(rank)
        return LineTable(
            region_lines=self.region_lines_stack[i], macro=self.macro_stack[i], macro2=self.macro2_stack[i],
            num_regions=self.num_regions, region_dims=self.region_dims, brick_lines=self.brick_lines_stack[i],
        )


def make_zsharded_hbm(bm: BrickMap, n: int, k: Optional[int] = None) -> ZShardedHBM:
    """The replicated walk's per-rank worlds, on ``bm``'s device: all ``n``
    rows (``k=None``, the stacked form) or rank ``k``'s alone.  Each slab's
    bricks are re-compacted to local slots (its occupied chunks' slots,
    sorted, as ``np.unique``) and padded with zero bricks to the largest
    slab's count, so a row is the same either way.  Needs the LINEAR coarse
    layout and ``grid_dims[2] % n == 0``; dense-slot and compact worlds
    alike."""
    if bm.coarse_layout is not Layout.LINEAR:
        raise ValueError("z-sharding requires the LINEAR coarse layout")
    gx, gy, gz = bm.grid_dims
    if gz % n:
        raise ValueError(f"gz={gz} must divide across {n} ranks")
    per = gx * gy * (gz // n)
    occ = ((bm.meta >> META_OCC_BIT) & 1) == 1
    slots = []
    for s in range(n):
        u = bm.brick_idx[s * per:(s + 1) * per]
        slots.append(torch.unique(u[occ[s * per:(s + 1) * per] & (u >= 0)]))
    bmax = max(1, max(u.numel() for u in slots))
    ks = tuple(range(n)) if k is None else (k,)
    rows: List[Tuple[torch.Tensor, LineTable]] = []
    for s in ks:
        sl = slice(s * per, (s + 1) * per)
        u = bm.brick_idx[sl]
        sel = occ[sl] & (u >= 0)
        meta_k = torch.zeros_like(bm.meta)
        meta_k[sl] = bm.meta[sl]
        idx_k = torch.full_like(bm.brick_idx, -1)
        local = torch.full_like(u, -1)
        local[sel] = torch.searchsorted(slots[s], u[sel]).to(I32)
        idx_k[sl] = local
        lb = torch.zeros((bmax, bm.words_per_brick), dtype=I32, device=bm.meta.device)
        lb[:slots[s].numel()] = bm.bricks[slots[s].long()]
        slab = dataclasses.replace(bm, meta=meta_k, brick_idx=idx_k, bricks=lb, dense_slots=False)
        rows.append((brick_lines_view(slab).contiguous(), make_line_table(slab)))
    lt0 = rows[0][1]
    return ZShardedHBM(
        brick_lines_stack=torch.stack([b for b, _ in rows]),
        region_lines_stack=torch.stack([t.region_lines for _, t in rows]),
        macro_stack=torch.stack([t.macro for _, t in rows]),
        macro2_stack=torch.stack([t.macro2 for _, t in rows]),
        grid_dims=bm.grid_dims, factor=bm.factor, brick_layout=bm.brick_layout,
        num_regions=lt0.num_regions, region_dims=lt0.region_dims, ranks=ks,
    )


def trace_brickmap_hbm_zsharded(zw: ZShardedHBM, origins: torch.Tensor, rays: torch.Tensor, mesh: Mesh,
                                max_steps: int = MAX_STEPS, use_macro: bool = True) -> TraceOut:
    """Trace rays through a z-sharded world by K1's replicated walk (module
    doc): each rank traces every ray over its row of ``zw`` (K1 for CUDA
    tensors, the plain :func:`~voxelengine_tpu_torch.ops.bigtrace.
    trace_brickmap_lt` on the CPU), then the first hit along each ray is
    picked: the least ``t`` (``pmin``), float-equal ties broken in walk
    order (the slab the ray's z reaches first), the owner's fields by a
    masked ``psum``; a miss reports the largest slab charge (``pmax``).
    Results are the same on every rank."""
    n, my = mesh.size, mesh.rank
    wpb = (zw.factor**3 + 31) // 32
    dev = origins.device
    # the tables are the line table's; the brickmap carries the grid only
    bm = BrickMap(
        meta=torch.zeros((1,), dtype=I32, device=dev), brick_idx=torch.zeros((1,), dtype=I32, device=dev),
        bricks=torch.zeros((1, wpb), dtype=I32, device=dev), grid_dims=zw.grid_dims, factor=zw.factor,
        coarse_layout=Layout.LINEAR, brick_layout=zw.brick_layout, dense_slots=False,
    )
    lt = zw.line_table(my)
    o, d = origins.to(F32), rays.to(F32)  # unnormalized: the trace normalizes, t's order is scale-free
    if o.is_cuda:
        out = trace_brickmap_k1(bm, lt, o, d, max_steps, use_macro)
    else:
        out = trace_brickmap_lt(bm, lt, o, d, max_steps, use_macro)
    t = torch.where(out.hit, dot3(out.position - o, d), 3.4e38)
    winner = out.hit & (t == pmin(t, mesh))
    rank = torch.where(d[:, 2] < 0.0, n - 1 - my, my)
    owner = winner & (pmin(torch.where(winner, rank, n), mesh) == rank)

    def pick(x):
        m = owner.reshape((-1,) + (1,) * (x.ndim - 1))
        return psum(torch.where(m, x, torch.zeros_like(x)), mesh)

    hit = pick(out.hit)
    steps = torch.where(hit, pick(out.steps), pmax(out.steps, mesh))
    return TraceOut(hit=hit, position=pick(out.position), normal=pick(out.normal), steps=steps)
