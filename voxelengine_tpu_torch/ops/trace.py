"""Brickmap and dense-grid ray traversal in plain torch.

Counterpart of ``voxelengine_tpu/ops/trace.py::trace_brickmap``: the same
flattened state machine (coarse DDA over chunks; descend into a chunk's
tight AABB; fine DDA over brick bits; resume the coarse walk on ascend),
one DDA event per ray per iteration, with the reference's tie-breaks and
max-edge padding (``VolumeRaytracer.cu:176-525``).  The ``lax.while_loop``
becomes a Python loop; every few iterations the still-active rays are
compacted, which changes no result (a finished ray's state is frozen).

This is the plain version of the Hopper kernels in
:mod:`voxelengine_tpu_torch.kernels.bigtrace` and
:mod:`voxelengine_tpu_torch.kernels.bmtrace` and the reference of their
exactness gates; :func:`run_slab`, one round of the walk over one z-slab
of a larger world, is K4-slab's.  :func:`trace_grid`, the single-level DDA over a dense
:class:`~voxelengine_tpu_torch.core.bitgrid.BitGrid`, is the plain version
of :mod:`voxelengine_tpu_torch.kernels.gridtrace`.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Sequence

import torch

from voxelengine_tpu_torch.config import FLT_EPS_DDA, MAX_STEPS
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import BrickMap, unpack_meta
from voxelengine_tpu_torch.core.exact import dot3, fdiv, sqrt_rn
from voxelengine_tpu_torch.core.layout import sample_index
from voxelengine_tpu_torch.ops.aabb import ray_aabb

F32 = torch.float32
I32 = torch.int32
INF = float("inf")
_COMPACT_EVERY = 16  # iterations between active-ray compactions


class TraceOut(NamedTuple):
    """Per-ray trace results (``DDARayResults``, ``VolumeRaytracer.cuh:179-275``)."""

    hit: torch.Tensor  # bool[N]
    position: torch.Tensor  # f32[N,3], world voxel coords
    normal: torch.Tensor  # f32[N,3], step-sign convention (renderer negates)
    steps: torch.Tensor  # i32[N]


def _dims(dims, dtype, device) -> torch.Tensor:
    """A small constant vector on ``device``, copied without the stream
    synchronisation that ``torch.tensor(..., device=cuda)`` performs."""
    return torch.tensor(dims, dtype=dtype).to(device, non_blocking=True)


def _normalize(v: torch.Tensor) -> torch.Tensor:
    """``v / |v|`` with the squared norm summed as ``x*x + y*y + z*z``."""
    return v / sqrt_rn(dot3(v, v))[..., None]


def _axis_pick3(tx, ty, tz):
    """Advance-axis choice with the reference's tie-breaking
    (``VolumeRaytracer.cu:293-313``): x if strictly smallest, else y if
    ``ty <= tx && ty < tz``, else z."""
    ax = (tx < ty) & (tx < tz)
    ay = ~ax & (ty <= tx) & (ty < tz)
    az = ~(ax | ay)
    return ax, ay, az


def _advance(cell, tmax, tdelta, step_sign, start, d):
    """One Amanatides-Woo step.  Returns (axis_onehot, t_cross, isect,
    new_cell, new_tmax, step_normal)."""
    axis = torch.stack(_axis_pick3(tmax[:, 0], tmax[:, 1], tmax[:, 2]), dim=-1)
    t_cross = torch.where(axis, tmax, 0.0).sum(dim=-1)  # one nonzero term: exact
    boundary = (cell + (step_sign > 0)).to(F32)
    linear = start + t_cross[:, None] * d
    isect = torch.where(axis, boundary, linear)
    new_cell = cell + torch.where(axis, step_sign, 0)
    new_tmax = tmax + torch.where(axis, tdelta, 0.0)
    step_normal = torch.where(axis, step_sign.to(F32), 0.0)
    return axis, t_cross, isect, new_cell, new_tmax, step_normal


def _init_tmax(cell, start, d, step_sign):
    """tMax initialization (``VolumeRaytracer.cu:203-205``)."""
    return torch.where(d != 0.0, ((cell + (step_sign > 0)).to(F32) - start) / d, INF)


def _edge_pad(cell, dims, d):
    """Max-edge padding: when a coordinate sits exactly on a maximal face,
    widen the in-range test by one on every axis with a negative direction
    (``VolumeRaytracer.cu:216-232``)."""
    on_edge = (cell == dims).any(dim=-1, keepdim=True)
    return (on_edge & (d < 0.0)).to(I32)


def _ray_setup(grid_dims, factor: int, origins: torch.Tensor, rays: torch.Tensor):
    """Normalize, move to chunk units and clip to the world AABB
    (``VolumeRaytracer.cu:354-381``).  Returns ``(d, start_c,
    start_normal, active0)``; shared by the plain trace and the line-table
    kernel's wrapper."""
    gdims_f = _dims(grid_dims, F32, origins.device)
    d = _normalize(rays.to(F32))
    start_c = fdiv(origins.to(F32), float(factor))
    inside = ((start_c >= 0.0) & (start_c < gdims_f)).all(dim=-1)
    eps = torch.full((3,), FLT_EPS_DDA, dtype=F32, device=origins.device)
    whit, _, wpt, wnrm = ray_aabb(start_c, d, eps, gdims_f - eps)
    start_c = torch.where(inside[:, None], start_c, torch.where(whit[:, None], wpt, start_c))
    start_normal = torch.where(inside[:, None], 0.0, wnrm)
    return d, start_c, start_normal, inside | whit


def kernel_result(flags, pos, nrm, steps, start_c, start_normal, factor: int) -> TraceOut:
    """A brickmap kernel's outputs, ``flags = hit | hit_imm << 1``, as a
    :class:`TraceOut`: a hit at the ray start reports the clipped start and
    the world-entry normal (``VolumeRaytracer.cu:518-522``)."""
    hit_imm = ((flags & 2) == 2)[:, None]
    return TraceOut(
        hit=(flags & 1) == 1,
        position=torch.where(hit_imm, start_c * float(factor), pos),
        normal=torch.where(hit_imm, start_normal, nrm),
        steps=steps,
    )


def _init_state(bm: BrickMap, origins, rays, full_gz=None) -> Dict[str, torch.Tensor]:
    """Ray setup plus the DDA init (``VolumeRaytracer.cu:195-232``).
    ``full_gz`` overrides the grid's z extent when ``bm`` is a z-slab of a
    larger world: the entry clip and the edge pad are the full grid's."""
    dev = origins.device
    dims = bm.grid_dims if full_gz is None else bm.grid_dims[:2] + (full_gz,)
    gdims = _dims(dims, I32, dev)
    d, start_c, start_normal, active = _ray_setup(dims, bm.factor, origins, rays)
    n = origins.shape[0]
    step_sign = torch.where(d > 0.0, 1, -1).to(I32)
    tdelta = torch.where(d != 0.0, torch.abs(fdiv(1.0, d)), INF)
    ccell = start_c.to(I32)  # trunc toward zero, like (int)x
    zeros3 = torch.zeros((n, 3), dtype=F32, device=dev)
    zeros3i = torch.zeros((n, 3), dtype=I32, device=dev)
    zb = torch.zeros((n,), dtype=torch.bool, device=dev)
    return dict(
        active=active,
        in_fine=zb,
        hit=zb,
        imm=zb,
        hit_imm=zb,
        steps=torch.zeros((n,), dtype=I32, device=dev),
        ccell=ccell,
        ctmax=_init_tmax(ccell, start_c, d, step_sign),
        centry_t=torch.zeros((n,), dtype=F32, device=dev),
        fcell=zeros3i,
        ftmax=zeros3,
        fstart=zeros3,
        fpos=zeros3,
        fpad=zeros3i,
        fsteps=torch.zeros((n,), dtype=I32, device=dev),
        cnorm=zeros3,
        fnorm=zeros3,
        pos_out=zeros3,
        norm_out=zeros3,
        start_c=start_c,
        d=d,
        tdelta=tdelta,
        step_sign=step_sign,
        cpad=_edge_pad(ccell, gdims, d),
        start_normal=start_normal,
    )


def slab_resident(cz: torch.Tensor, z0: int, slab_gz: int, full_gz: int) -> torch.Tensor:
    """Whether coarse cells at z ``cz`` lie in the slab ``[z0, z0 +
    slab_gz)`` of a ``full_gz``-deep grid.  The edge pad cell ``cz ==
    full_gz`` (a ray that entered on the grid's far z face, heading down)
    belongs to the last slab, which reads it clamped, as the whole grid
    does; the JAX package pauses it on every slab, so its migration reports
    such a ray a miss."""
    resident = (cz >= z0) & (cz < z0 + slab_gz)
    if z0 + slab_gz == full_gz:
        resident = resident | (cz == full_gz)
    return resident


def _step(bm: BrickMap, st: Dict[str, torch.Tensor], max_steps: int, slab=None) -> Dict[str, torch.Tensor]:
    """Advance every active ray by one DDA event (coarse step, descend,
    fine step, ascend or hit).

    ``slab=(z0, full_gz)``: ``bm`` holds only the coarse-z slab ``[z0, z0 +
    bm.grid_dims[2])`` of a grid ``full_gz`` deep (``voxelengine_tpu/ops/
    trace.py:221-262``).  Range tests are the full grid's, tables are read
    at ``z - z0``, and a coarse-phase ray whose cell is not in the slab
    (:func:`slab_resident`) is paused, deactivated with its state intact,
    before any table read, so that the slab holding its cell can resume it.
    ``st["paused"]`` records the pauses at a cell of the whole grid (edge
    pads included); a ray paused outside it is a miss, as K4-slab ends it.
    """
    dev = st["active"].device
    f = bm.factor
    gx, gy, gz = bm.grid_dims
    full_gz = gz if slab is None else slab[1]
    gdims = _dims((gx, gy, full_gz), I32, dev)
    wpb = bm.words_per_brick
    active, in_fine = st["active"], st["in_fine"]
    ccell, fcell, d, start_c = st["ccell"], st["fcell"], st["d"], st["start_c"]
    coarse_phase = active & ~in_fine
    fine_phase = active & in_fine
    if slab is not None:
        resident = slab_resident(ccell[:, 2], slab[0], gz, full_gz)
        pause = coarse_phase & ~resident
        coarse_phase = coarse_phase & resident

    # ---------------- coarse level ----------------
    in_range_c = ((ccell >= 0) & (ccell < gdims + st["cpad"])).all(dim=-1)
    cl = torch.clamp(ccell, min=torch.zeros_like(gdims), max=gdims - 1)
    zl = cl[:, 2] if slab is None else torch.clamp(cl[:, 2] - slab[0], 0, gz - 1)
    ci = sample_index(cl[:, 0], cl[:, 1], zl, gx, gy, bm.coarse_layout)
    ci_safe = torch.where(active, ci, 0)
    cl_f = torch.clamp(fcell, 0, f - 1)
    bit = sample_index(cl_f[:, 0], cl_f[:, 1], cl_f[:, 2], f, f, bm.brick_layout)
    slot = ci_safe if bm.dense_slots else torch.clamp_min(bm.brick_idx[ci_safe], 0)
    occ_c, bmn, bmx = unpack_meta(bm.meta[ci_safe])
    clf = cl.to(F32)
    box_min = clf + fdiv(bmn.to(F32), float(f))
    box_max = clf + fdiv(bmx.to(F32) + 1.0, float(f))
    bhit, btmin, bpos, bnrm = ray_aabb(start_c, d, box_min, box_max)

    occupied = in_range_c & occ_c & bhit
    descend = coarse_phase & occupied
    coarse_miss = coarse_phase & ~in_range_c
    coarse_adv = coarse_phase & in_range_c & ~occupied

    # descend: fine DDA starts at the tight-box entry, or at the current
    # position when already inside the box; a descend at the ray start is
    # the reference's degenerate case (VolumeRaytracer.cu:518-522)
    imm_new = (st["steps"] == 0) & (btmin <= 0.0)
    entry_c = torch.where((btmin > 0.0)[:, None], bpos, start_c + d * st["centry_t"][:, None])
    fstart_new = (entry_c - clf) * float(f)
    fcell_new = fstart_new.to(I32)
    ftmax_new = _init_tmax(fcell_new, fstart_new, d, st["step_sign"])
    fdims = torch.full((3,), f, dtype=I32, device=dev)
    fpad_new = _edge_pad(fcell_new, fdims, d)

    # ---------------- fine level ----------------
    in_range_f = ((fcell >= 0) & (fcell < fdims + st["fpad"])).all(dim=-1)
    word = bm.bricks.reshape(-1)[torch.where(fine_phase, slot * wpb + (bit >> 5), 0)]
    occ_f = ((word >> (bit & 31)) & 1) == 1
    fine_hit = fine_phase & in_range_f & occ_f
    fine_try = fine_phase & in_range_f & ~occ_f
    _, _, isect_f, fcell_adv, ftmax_adv, fnorm_adv = _advance(
        fcell, st["ftmax"], st["tdelta"], st["step_sign"], st["fstart"], d
    )
    oob_f = ((isect_f < 0.0) | (isect_f > float(f))).any(dim=-1)
    fine_step = fine_try & ~oob_f
    ascend = (fine_phase & ~in_range_f) | (fine_try & oob_f)

    # ---------------- coarse advance (coarse_adv | ascend) ----------------
    do_cadv = coarse_adv | ascend
    _, tcross_c, _, ccell_adv, ctmax_adv, _ = _advance(
        ccell, st["ctmax"], st["tdelta"], st["step_sign"], start_c, d
    )
    dc, ds, fs = descend[:, None], do_cadv[:, None], fine_step[:, None]

    new_steps = st["steps"] + (do_cadv | fine_step).to(I32)
    ended = fine_hit | coarse_miss | (new_steps >= max_steps)
    if slab is not None:
        ended = ended | pause
    # hit bookkeeping (VolumeRaytracer.cu:427-429,495-503)
    hit_pos = st["fpos"] + (ccell * f).to(F32)
    hit_nrm = torch.where((st["fsteps"] == 0)[:, None], st["cnorm"], st["fnorm"])
    out = dict(st)
    out.update(
        active=active & ~ended,
        in_fine=(in_fine | descend) & ~ascend & ~fine_hit,
        hit=st["hit"] | fine_hit,
        imm=torch.where(descend, imm_new, st["imm"]),
        hit_imm=st["hit_imm"] | (fine_hit & (st["fsteps"] == 0) & st["imm"]),
        steps=new_steps,
        ccell=torch.where(ds, ccell_adv, ccell),
        ctmax=torch.where(ds, ctmax_adv, st["ctmax"]),
        centry_t=torch.where(do_cadv, tcross_c, st["centry_t"]),
        fcell=torch.where(dc, fcell_new, torch.where(fs, fcell_adv, fcell)),
        ftmax=torch.where(dc, ftmax_new, torch.where(fs, ftmax_adv, st["ftmax"])),
        fstart=torch.where(dc, fstart_new, st["fstart"]),
        fpos=torch.where(dc, fstart_new, torch.where(fs, isect_f, st["fpos"])),
        fpad=torch.where(dc, fpad_new, st["fpad"]),
        fsteps=torch.where(descend, 0, st["fsteps"] + fine_step.to(I32)),
        cnorm=torch.where(dc, bnrm, st["cnorm"]),
        fnorm=torch.where(fs, fnorm_adv, st["fnorm"]),
        pos_out=torch.where(fine_hit[:, None], hit_pos, st["pos_out"]),
        norm_out=torch.where(fine_hit[:, None], hit_nrm, st["norm_out"]),
    )
    if slab is not None:
        out["paused"] = st["paused"] | (pause & in_range_c)
    return out


_RESULT_KEYS = ("hit", "hit_imm", "steps", "pos_out", "norm_out")


def _run_loop(step: Callable, st: Dict[str, torch.Tensor], iter_limit: int, keys: Sequence[str]):
    """Run ``work = step(work, it)`` for up to ``iter_limit`` iterations.
    Works on the compacted set of active rays and writes their ``keys``
    back."""
    idx = torch.arange(st["active"].shape[0], device=st["active"].device)
    res = {k: st[k].clone() for k in keys}
    work = st
    for it in range(iter_limit):
        if it % _COMPACT_EVERY == 0:
            for k in keys:
                res[k][idx] = work[k]
            keep = torch.nonzero(work["active"]).squeeze(1)
            if keep.numel() == 0:
                return res
            if keep.numel() < idx.numel():
                work = {k: v[keep] for k, v in work.items()}
                idx = idx[keep]
        work = step(work, it)
    for k in keys:
        res[k][idx] = work[k]
    return res


def trace_brickmap(bm: BrickMap, origins: torch.Tensor, rays: torch.Tensor, max_steps: int = MAX_STEPS) -> TraceOut:
    """Trace a batch of rays through a two-level brickmap.

    ``origins``/``rays`` are ``f32[N, 3]`` in world voxel units on the
    brickmap's device; rays need not be normalized
    (``VolumeRaytracer.cu:367``).  Runs at most ``2 * max_steps + 8``
    iterations, a bound no ray reaches: every descend is followed by a
    charged step or a hit.
    """
    st = _init_state(bm, origins, rays)
    res = _run_loop(lambda s, _: _step(bm, s, max_steps), st, 2 * max_steps + 8, _RESULT_KEYS)
    return _finalize(dict(st, **res), bm.factor)


def _finalize(st: Dict[str, torch.Tensor], factor: int) -> TraceOut:
    """A walk's state as its results (``voxelengine_tpu/ops/trace.py:402``):
    a hit at the ray start reports the clipped entry point and the
    world-AABB entry normal (``VolumeRaytracer.cu:518-522``)."""
    imm = st["hit_imm"][:, None]
    pos = torch.where(imm, st["start_c"] * float(factor), st["pos_out"])
    nrm = torch.where(imm, st["start_normal"], st["norm_out"])
    return TraceOut(hit=st["hit"], position=pos, normal=nrm, steps=st["steps"])


# A slab round's state rows: the walk's state keys in this order, as int32
# words (floats bitcast, bools 0/1); SLAB_CELL_Z is the coarse cell's z.
SLAB_STATE = (
    ("active", torch.bool, ()), ("in_fine", torch.bool, ()), ("hit", torch.bool, ()), ("imm", torch.bool, ()),
    ("hit_imm", torch.bool, ()), ("steps", I32, ()), ("ccell", I32, (3,)), ("ctmax", F32, (3,)),
    ("centry_t", F32, ()), ("fcell", I32, (3,)), ("ftmax", F32, (3,)), ("fstart", F32, (3,)), ("fpos", F32, (3,)),
    ("fpad", I32, (3,)), ("fsteps", I32, ()), ("cnorm", F32, (3,)), ("fnorm", F32, (3,)), ("pos_out", F32, (3,)),
    ("norm_out", F32, (3,)), ("start_c", F32, (3,)), ("d", F32, (3,)), ("tdelta", F32, (3,)),
    ("step_sign", I32, (3,)), ("cpad", I32, (3,)), ("start_normal", F32, (3,)),
)
SLAB_CELL_Z = 8


def pack_slab_state(st: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The walk's state as ``int32[m, words]`` rows (:data:`SLAB_STATE`)."""
    m = st["active"].shape[0]
    cols = [st[k].reshape(m, math.prod(shape)) for k, _, shape in SLAB_STATE]
    return torch.cat([v.view(I32) if v.dtype == F32 else v.to(I32) for v in cols], dim=1)


def unpack_slab_state(rows: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Undo :func:`pack_slab_state`."""
    st, c = {}, 0
    for k, dtype, shape in SLAB_STATE:
        w = math.prod(shape)
        v = rows[:, c:c + w].contiguous()
        c += w
        v = v.view(F32) if dtype == F32 else (v != 0 if dtype == torch.bool else v)
        st[k] = v.reshape((rows.shape[0],) + shape)
    return st


def run_slab(bm: BrickMap, src, max_steps: int, z0: int, full_gz: int):
    """One round of the z-sharded walk: advance rays through ``bm``, the
    slab ``[z0, z0 + bm.grid_dims[2])`` of a grid ``full_gz`` deep, until
    each hits, leaves the grid, spends its budget or pauses at the slab's
    boundary (:func:`_step`).  ``src`` is round 0's state (from
    :func:`_init_state` with ``full_gz``) or the state rows of rays paused
    elsewhere (:func:`pack_slab_state`), which resume where they stopped.

    Returns what K4-slab's host twin on prepared rays writes
    (``csrc/dda_host.cpp::vx_zslab_host``), of which this is the plain
    version: ``(rows, status, flags, position, normal, steps)``, each ray's state rows after the round, its status (0 done, 1
    paused) and, for a ray that is done, its result with ``flags = hit |
    hit_imm << 1`` (zeros for a paused ray)."""
    if isinstance(src, torch.Tensor):
        st = unpack_slab_state(src)
        st["active"] = torch.ones_like(st["active"])  # re-armed: this slab resumes them
    else:
        st = dict(src)
    st["paused"] = torch.zeros_like(st["active"])
    st = _run_loop(lambda s, _: _step(bm, s, max_steps, (z0, full_gz)), st, 2 * max_steps + 8, tuple(st))
    paused = st["paused"]
    flags = st["hit"].to(I32) | (st["hit_imm"].to(I32) << 1)
    steps = torch.where(paused, 0, st["steps"])
    return pack_slab_state(st), paused.to(I32), flags, st["pos_out"], st["norm_out"], steps


def _grid_step(grid: BitGrid, st: Dict[str, torch.Tensor], max_steps: int, skip: bool):
    """One dense-grid DDA event per active ray: a hit, a miss (left the
    grid) or a step.  ``skip`` ignores the start cell (``take_initial_step``)."""
    gdims = _dims(grid.dims, I32, st["cell"].device)
    active, cell = st["active"], st["cell"]
    in_range = ((cell >= 0) & (cell < gdims + st["pad"])).all(dim=-1)
    cl = torch.clamp(cell, min=torch.zeros_like(gdims), max=gdims - 1)
    occ = grid.get_bits(cl[:, 0], cl[:, 1], cl[:, 2]) & in_range & (not skip)
    this_hit = active & occ
    this_miss = active & ~in_range & (not skip)
    _, _, isect, cell_adv, tmax_adv, step_nrm = _advance(
        cell, st["tmax"], st["tdelta"], st["step_sign"], st["start"], st["d"]
    )
    adv = active & ~this_hit & ~this_miss
    a3 = adv[:, None]
    steps = st["steps"] + adv.to(I32)
    out = dict(st)
    out.update(
        active=adv & (steps < max_steps),
        hit=st["hit"] | this_hit,
        steps=steps,
        cell=torch.where(a3, cell_adv, cell),
        tmax=torch.where(a3, tmax_adv, st["tmax"]),
        pos=torch.where(a3, isect, st["pos"]),
        nrm=torch.where(a3, step_nrm, st["nrm"]),
    )
    return out


def trace_grid(
    grid: BitGrid, origins: torch.Tensor, rays: torch.Tensor, max_steps: int = MAX_STEPS,
    take_initial_step: bool = False,
) -> TraceOut:
    """Single-level DDA through a dense bit grid (the reference's plain
    ``DDARayTraversal``, ``VolumeRaytracer.cu:176-352``) with the two-level
    path's world-AABB entry clip.  Counterpart of
    ``voxelengine_tpu/ops/trace.py::trace_grid``; ``origins``/``rays`` are
    ``f32[N, 3]`` in voxel units on the grid's device.  A hit at the start
    cell reports the clipped start and the world-entry normal.
    """
    d, start, start_normal, active = _ray_setup(grid.dims, 1, origins, rays)
    cell = start.to(I32)  # trunc toward zero, like (int)x
    step_sign = torch.where(d > 0.0, 1, -1).to(I32)
    n, dev = origins.shape[0], origins.device
    st = dict(
        active=active,
        hit=torch.zeros((n,), dtype=torch.bool, device=dev),
        steps=torch.zeros((n,), dtype=I32, device=dev),
        cell=cell,
        tmax=_init_tmax(cell, start, d, step_sign),
        pos=start,
        nrm=torch.zeros((n, 3), dtype=F32, device=dev),
        start=start,
        d=d,
        tdelta=torch.where(d != 0.0, torch.abs(fdiv(1.0, d)), INF),
        step_sign=step_sign,
        pad=_edge_pad(cell, _dims(grid.dims, I32, dev), d),
    )
    res = _run_loop(
        lambda s, it: _grid_step(grid, s, max_steps, take_initial_step and it == 0),
        st, max_steps + 1, ("hit", "steps", "pos", "nrm"),
    )
    zero_step = (res["hit"] & (res["steps"] == 0))[:, None]
    return TraceOut(
        hit=res["hit"],
        position=torch.where(zero_step, start, res["pos"]),
        normal=torch.where(zero_step, start_normal, res["nrm"]),
        steps=res["steps"],
    )
