"""Line-table traversal: counterpart of ``voxelengine_tpu/ops/pallas_bigtrace.py``.

The world is kept as 4 KB *lines* of ``[8, 128]`` int32 words: one line per
8x8x8-chunk *region* (512 packed meta words, then 512 brick-slot words),
plus the brick words as lines of their own, and two macro occupancy levels
(``macro``: one bit per region; ``macro2``: 4x1x4-region super-regions and
16x1x16-region blocks).  Entry points, each launching a hand-written Hopper
kernel for rays on a CUDA device and running its plain version for rays on
the CPU:

* :func:`trace_brickmap_hbm`: K1 (:mod:`voxelengine_tpu_torch.kernels.
  bigtrace`), one thread a ray; with ``use_macro`` (the default, as in the
  JAX package) rays in empty regions skip whole empty spans, and
  ``return_iters``/``return_phases`` give the diagnostic counters;
* :func:`trace_brickmap_hbm_rr`: K5 (:mod:`voxelengine_tpu_torch.kernels.
  rrtrace`), the same function with a persistent grid and a work queue;
* :func:`trace_brickmap_hbm_staged`: two K1 launches, a short-budget pass
  and a full-budget retrace of the 128-ray rows that still have survivors;
* :func:`trace_secondary_hbm`: K1's secondary entry, a kind of the
  shading's secondary rays built, walked and reduced in one launch.
* :func:`record_brickmap_k1`: K1's record entry, the engine facade's
  result record stored in the launch (card only; its plain version is
  ``engine/raytracer.py::results_from_trace`` over ``trace_brickmap``).

The plain versions are :func:`trace_brickmap_lt`, a torch state machine over
the line table that takes the macro skips with the TPU kernel's expressions
(``pallas_bigtrace.py::_trace_inner``) and counts its phases, and, with the
macro levels off and no counters asked for,
:func:`~voxelengine_tpu_torch.ops.trace.trace_brickmap`.  A macro skip
re-seeds the coarse tMax from the cell across the span's face where the
chunk-by-chunk walk accumulates it, so the two walks can differ by an ulp
at a near-tie; the port follows the TPU kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from voxelengine_tpu_torch.config import MAX_STEPS
from voxelengine_tpu_torch.core.bitgrid import pack_bits, unique_last, write_bits
from voxelengine_tpu_torch.core.brickmap import BrickMap, _edit_coords, _edit_xyz, apply_edits, unpack_meta
from voxelengine_tpu_torch.core.exact import fdiv
from voxelengine_tpu_torch.core.layout import Layout, sample_index
from voxelengine_tpu_torch.ops.aabb import ray_aabb
from voxelengine_tpu_torch.ops.secondary import secondary_plain, walk_steps
from voxelengine_tpu_torch.ops.trace import (
    _RESULT_KEYS,
    INF,
    TraceOut,
    _advance,
    _axis_pick3,
    _dims,
    _edge_pad,
    _init_state,
    _init_tmax,
    _ray_setup,
    _run_loop,
    trace_brickmap,
)

F32 = torch.float32
I32 = torch.int32
MACRO2_WORDS = 32  # L2 capacity: 1024 super-regions
MACRO3_WORDS = 4  # L3 capacity: 128 16x1x16-region blocks
# _trace_inner's diagnostic counters, in its order (pallas_bigtrace.py:1670-1671)
PHASES = ("stall", "mskip", "cadv", "pend", "desc", "fstep", "step2", "asc", "xrun", "adjstall")


@dataclasses.dataclass(frozen=True)
class LineTable:
    """Line-table form of a brickmap (see module doc).

    ``macro``/``macro2`` are the region / super-region / block occupancy
    bits of the macro skip levels, bit-exact with the JAX package's.
    """

    region_lines: torch.Tensor  # int32[NR * 8, 128]
    macro: torch.Tensor  # int32[8 * ceil(NR / 32768), 128]
    macro2: torch.Tensor  # int32[MACRO2_WORDS + MACRO3_WORDS]
    num_regions: int
    region_dims: Tuple[int, int, int]
    brick_lines: Optional[torch.Tensor] = None  # int32[NBL * 8, 128]


def brick_lines_view(bm: BrickMap) -> torch.Tensor:
    """``bm.bricks`` as int32 brick lines ``[NBL * 8, 128]`` (padded to
    whole 1024-word lines).  A view when no padding is needed."""
    bw = bm.bricks.reshape(-1)
    padw = (-bw.shape[0]) % 1024
    if padw:
        bw = torch.cat([bw, torch.zeros((padw,), dtype=I32, device=bw.device)])
    return bw.reshape(-1, 128)


def materialize_brick_lines(bm: BrickMap, lt: LineTable) -> LineTable:
    """Return ``lt`` with the brick-line form of ``bm.bricks`` attached."""
    return dataclasses.replace(lt, brick_lines=brick_lines_view(bm).contiguous())


def host_brick_lines(bricks: np.ndarray) -> np.ndarray:
    """Host numpy twin of :func:`brick_lines_view`: raw brick words
    (``uint32`` or ``int32 [N, wpb]``, e.g. a memory map of a world cache's
    bricks) as int32 brick lines ``[NBL * 8, 128]``, a view when ``N * wpb``
    is a multiple of 1024.  For worlds whose brick table and its lines do
    not both fit on the card: relayout on the host, upload the lines."""
    bw = bricks.reshape(-1).view(np.int32)
    padw = (-bw.shape[0]) % 1024
    if padw:
        bw = np.concatenate([bw, np.zeros((padw,), np.int32)])
    return bw.reshape(-1, 128)


def _pack_rows(occ: torch.Tensor) -> torch.Tensor:
    """bool ``[rows, 32]`` -> int32 word per row (bit k = column k)."""
    return pack_bits(occ.reshape(-1)).reshape(occ.shape[0])


def make_line_table(bm: BrickMap) -> LineTable:
    """Build the region-line table and the macro occupancy words.

    Any coarse layout: non-LINEAR orders are gathered into region order, so
    the traversal addresses regions by coordinates.  Grid dims are padded
    up to multiples of 8 with empty chunks (meta 0, slot -1).
    """
    gx, gy, gz = bm.grid_dims
    dev = bm.meta.device
    rx, ry, rz = -(-gx // 8), -(-gy // 8), -(-gz // 8)
    nr = rx * ry * rz
    px, py, pz = rx * 8, ry * 8, rz * 8

    if bm.coarse_layout is Layout.LINEAR:
        lin_meta, lin_slots = bm.meta, bm.brick_idx
    else:
        zz, yy, xx = torch.meshgrid(
            torch.arange(gz, device=dev), torch.arange(gy, device=dev),
            torch.arange(gx, device=dev), indexing="ij",
        )
        src = sample_index(xx, yy, zz, gx, gy, bm.coarse_layout).reshape(-1)
        lin_meta, lin_slots = bm.meta[src], bm.brick_idx[src]

    def to_regions(flat, fill):
        a = torch.full((pz, py, px), fill, dtype=I32, device=dev)
        a[:gz, :gy, :gx] = flat.reshape(gz, gy, gx)
        # [rz,8, ry,8, rx,8] -> regions (rz,ry,rx) x local (lz,ly,lx)
        return a.reshape(rz, 8, ry, 8, rx, 8).permute(0, 2, 4, 1, 3, 5).reshape(nr, 512)

    meta_r = to_regions(lin_meta, 0)
    slots_r = to_regions(lin_slots, -1)
    region_lines = torch.cat([meta_r, slots_r], dim=1).reshape(-1, 128)

    occ_r = (((meta_r >> 30) & 1) == 1).any(dim=1)
    nv = -(-nr // 32768)  # 32768 region bits per [8, 128] block
    occ_pad = torch.zeros(nv * 32768, dtype=torch.bool, device=dev)
    occ_pad[:nr] = occ_r
    macro = _pack_rows(occ_pad.reshape(nv * 1024, 32)).reshape(nv * 8, 128)

    # L2: 4x1x4-region super-regions; L3: 16x1x16-region blocks.  A level
    # that does not fit its word budget is all ones (never skips).
    srx, sry, srz = -(-rx // 4), ry, -(-rz // 4)
    nsr = srx * sry * srz
    if nsr <= MACRO2_WORDS * 32:
        occ_grid = torch.zeros((srz * 4, ry, srx * 4), dtype=torch.bool, device=dev)
        occ_grid[:rz, :, :rx] = occ_r.reshape(rz, ry, rx)
        occ_sr = occ_grid.reshape(srz, 4, ry, srx, 4).permute(0, 2, 3, 1, 4).reshape(nsr, 16).any(dim=1)
        sr_pad = torch.zeros(MACRO2_WORDS * 32, dtype=torch.bool, device=dev)
        sr_pad[:nsr] = occ_sr
        macro2 = _pack_rows(sr_pad.reshape(MACRO2_WORDS, 32))
        s3x, s3y, s3z = -(-rx // 16), ry, -(-rz // 16)
        ns3 = s3x * s3y * s3z
        if ns3 <= MACRO3_WORDS * 32:
            sg = torch.zeros((s3z * 4, sry, s3x * 4), dtype=torch.bool, device=dev)
            sg[:srz, :, :srx] = occ_sr.reshape(srz, sry, srx)
            occ3 = sg.reshape(s3z, 4, sry, s3x, 4).permute(0, 2, 3, 1, 4).reshape(ns3, 16).any(dim=1)
            o3_pad = torch.zeros(MACRO3_WORDS * 32, dtype=torch.bool, device=dev)
            o3_pad[:ns3] = occ3
            macro3 = _pack_rows(o3_pad.reshape(MACRO3_WORDS, 32))
        else:
            macro3 = torch.full((MACRO3_WORDS,), -1, dtype=I32, device=dev)
        macro2 = torch.cat([macro2, macro3])
    else:
        macro2 = torch.full((MACRO2_WORDS + MACRO3_WORDS,), -1, dtype=I32, device=dev)

    return LineTable(
        region_lines=region_lines,
        macro=macro,
        macro2=macro2,
        num_regions=nr,
        region_dims=(rx, ry, rz),
    )


def _group_bits(flat: torch.Tensor, gx: int, gy: int, gz: int, x0, y0, z0) -> torch.Tensor:
    """Whether any of the 4x1x4 cells at ``(x0 + dx, y0, z0 + dz)`` inside
    the ``gx * gy * gz`` grid has its bit set in the flat bit words
    ``flat`` (x fastest); one answer per start cell."""
    d = torch.arange(4, device=flat.device)
    cx = x0[:, None, None] + d[None, :, None]
    cz = z0[:, None, None] + d[None, None, :]
    cy = y0[:, None, None]
    valid = (cx < gx) & (cy < gy) & (cz < gz)
    cid = torch.clamp_max(cx, gx - 1) + gx * (torch.clamp_max(cy, gy - 1) + gy * torch.clamp_max(cz, gz - 1))
    bits = ((flat[cid >> 5] >> (cid & 31)) & 1) == 1
    return (bits & valid).flatten(1).any(dim=1)


def apply_edits_hbm(bm: BrickMap, lt: LineTable, x, y, z, value):
    """:func:`~voxelengine_tpu_torch.core.brickmap.apply_edits` on a
    brickmap and its line table, in place; returns ``(bm, lt)``.

    O(edits), as the JAX function: each touched chunk's meta word is
    written into ``region_lines``; each touched region's bit of ``macro``
    is recomputed from its 512 chunk metas; where L2 is real (it fits its
    word budget), each touched super-region's bit from the new ``macro``,
    and where L3 is real too, each touched block's bit from the new L2
    words; attached brick lines take the edited brick words.  Every word is
    written once (brick lines that share the bricks' storage not at all),
    so the tables equal :func:`make_line_table` of the edited world.
    Needs ``dense_slots``."""
    if not bm.dense_slots:
        raise ValueError("edits require dense_slots brickmaps")
    x, y, z = _edit_xyz(bm, x, y, z)
    apply_edits(bm, x, y, z, value)
    ci, col, _ = _edit_coords(bm, x, y, z)
    f = bm.factor
    gx, gy, gz = bm.grid_dims
    rx, ry, rz = lt.region_dims
    cx, cy, cz = x // f, y // f, z // f

    # the meta word in the region record (rows 0..3 of the region's line)
    region = (cx >> 3) + rx * ((cy >> 3) + ry * (cz >> 3))
    local = (cx & 7) + ((cy & 7) << 3) + ((cz & 7) << 6)
    key, last = unique_last(region * 1024 + local)
    lt.region_lines.view(-1)[key] = bm.meta[ci[last]]

    # L1: each touched region's occupancy over its 8^3 chunks
    ureg, last = unique_last(region)
    d = torch.arange(8, device=x.device)
    bx = (cx[last] >> 3)[:, None, None, None] * 8 + d[None, :, None, None]
    by = (cy[last] >> 3)[:, None, None, None] * 8 + d[None, None, :, None]
    bz = (cz[last] >> 3)[:, None, None, None] * 8 + d[None, None, None, :]
    inb = (bx < gx) & (by < gy) & (bz < gz)
    cid = bm.chunk_index(torch.clamp_max(bx, gx - 1), torch.clamp_max(by, gy - 1), torch.clamp_max(bz, gz - 1))
    occ = ((((bm.meta[cid] >> 30) & 1) == 1) & inb).flatten(1).any(dim=1)
    macro = lt.macro.view(-1)
    write_bits(macro, ureg >> 5, ureg & 31, occ)

    # L2 (4x1x4 regions), then L3 (4x1x4 super-regions), where real
    srx, sry, srz = -(-rx // 4), ry, -(-rz // 4)
    if srx * sry * srz <= MACRO2_WORDS * 32:
        sreg, last = unique_last((cx >> 5) + srx * ((cy >> 3) + sry * (cz >> 5)))
        occ2 = _group_bits(macro, rx, ry, rz, (cx[last] >> 5) * 4, cy[last] >> 3, (cz[last] >> 5) * 4)
        write_bits(lt.macro2, sreg >> 5, sreg & 31, occ2)
        s3x, s3y, s3z = -(-rx // 16), ry, -(-rz // 16)
        if s3x * s3y * s3z <= MACRO3_WORDS * 32:
            blk, last = unique_last((cx >> 7) + s3x * ((cy >> 3) + s3y * (cz >> 7)))
            occ3 = _group_bits(lt.macro2, srx, sry, srz, (cx[last] >> 7) * 4, cy[last] >> 3, (cz[last] >> 7) * 4)
            write_bits(lt.macro2, MACRO2_WORDS + (blk >> 5), blk & 31, occ3)

    # attached brick lines: the edited words, unless they are the bricks
    bl = lt.brick_lines
    if bl is not None and bl.untyped_storage().data_ptr() != bm.bricks.untyped_storage().data_ptr():
        flat = torch.unique(bm.brick_idx[ci].long() * bm.words_per_brick + col)
        bl.view(-1)[flat] = bm.bricks.view(-1)[flat]
    return bm, lt


def _group_occ(lt: LineTable, rg, sh: int, base: int, budget: int):
    """Occupancy bit of each region's (1 << sh) x 1 x (1 << sh)-region group
    from the ``budget`` words at ``macro2[base]`` (L2: sh 2, L3: sh 4).
    Words past the world's own count read as all occupied, as
    ``_trace_inner``'s select chain reads them (``pallas_bigtrace.py:855-872``)."""
    rx, ry, rz = lt.region_dims
    gxn = -(-rx // (1 << sh))
    nw = min(budget, -(-(gxn * ry * -(-rz // (1 << sh))) // 32))
    g = (rg[:, 0] >> sh) + gxn * (rg[:, 1] + ry * (rg[:, 2] >> sh))
    w = g >> 5
    word = torch.where(w < nw, lt.macro2[base + torch.clamp(w, 0, budget - 1)], -1)
    return ((word >> (g & 31)) & 1) == 1


def _macro_skip(lt: LineTable, grid_dims, cl, rg, st):
    """``_trace_inner``'s macro skip (``pallas_bigtrace.py:1064-1139``) for
    every ray, as if its region were empty: returns ``(new coarse cell,
    re-seeded tMax, exit time, L1 chunk distance)``."""
    skip2 = ~_group_occ(lt, rg, 2, 0, MACRO2_WORDS)
    skip3 = skip2 & ~_group_occ(lt, rg, 4, MACRO2_WORDS, MACRO3_WORDS)
    # span corner and far faces from the clamped cell, clamped to the grid;
    # y spans stay one region
    sh = torch.where(skip3, 7, torch.where(skip2, 5, 3)).to(I32)[:, None]
    sh = torch.cat([sh, torch.full_like(sh, 3), sh], dim=1)
    lo = (cl >> sh) << sh
    hi = torch.minimum(lo + (1 << sh), _dims(grid_dims, I32, cl.device))
    s, d, sgn = st["start_c"], st["d"], st["step_sign"]
    nb = torch.where(sgn > 0, hi, lo).to(F32)
    rt = torch.where(d != 0.0, (nb - s) / d, INF)
    ax, ay, az = _axis_pick3(rt[:, 0], rt[:, 1], rt[:, 2])
    tc = torch.where(ax, rt[:, 0], torch.where(ay, rt[:, 1], rt[:, 2]))
    m = s + tc[:, None] * d
    axis = torch.stack([ax, ay, az], dim=1)
    # stepped axis: the first cell across the face; others: floor, clamped
    # into the span
    floor_in = torch.clamp(m.to(I32) - (m < 0.0).to(I32), min=lo, max=hi - 1)
    sk = torch.where(axis, torch.where(sgn > 0, hi, lo - 1), floor_in)
    l1 = (sk - st["ccell"]).abs().sum(dim=1, dtype=I32)
    return sk, _init_tmax(sk, s, d, sgn), tc, l1


def _lt_step(bm: BrickMap, lt: LineTable, st, max_steps: int, use_macro: bool, diag: bool):
    """One DDA event per active ray over the line table: a macro skip, a
    coarse step, a descend, a fine step, an ascend or a hit (csrc/dda.cuh's
    loop body), with the diag counters when ``diag``."""
    dev = st["active"].device
    f = bm.factor
    rx, ry, _ = lt.region_dims
    gdims = _dims(bm.grid_dims, I32, dev)
    wpb = bm.words_per_brick
    active, in_fine = st["active"], st["in_fine"]
    ccell, fcell, d, start_c = st["ccell"], st["fcell"], st["d"], st["start_c"]
    coarse_phase = active & ~in_fine
    fine_phase = active & in_fine

    # ---------------- coarse level ----------------
    in_range_c = ((ccell >= 0) & (ccell < gdims + st["cpad"])).all(dim=-1)
    cl = torch.clamp(ccell, min=torch.zeros_like(gdims), max=gdims - 1)
    rg = cl >> 3
    region = rg[:, 0] + rx * (rg[:, 1] + ry * rg[:, 2])
    local = (cl[:, 0] & 7) + ((cl[:, 1] & 7) << 3) + ((cl[:, 2] & 7) << 6)
    cidx = torch.where(active, region.long() * 1024 + local, 0)
    lines = lt.region_lines.reshape(-1)
    slot = torch.clamp_min(lines[cidx + 512], 0)
    occ_c, bmn, bmx = unpack_meta(lines[cidx])
    clf = cl.to(F32)
    box_min = clf + fdiv(bmn.to(F32), float(f))
    box_max = clf + fdiv(bmx.to(F32) + 1.0, float(f))
    bhit, btmin, bpos, bnrm = ray_aabb(start_c, d, box_min, box_max)
    if use_macro:
        region_occ = ((lt.macro.reshape(-1)[region >> 5] >> (region & 31)) & 1) == 1
        skip = coarse_phase & in_range_c & ~region_occ
    else:
        skip = torch.zeros_like(active)

    occupied = in_range_c & occ_c & bhit & ~skip
    descend = coarse_phase & occupied
    coarse_miss = coarse_phase & ~in_range_c
    coarse_adv = coarse_phase & in_range_c & ~occupied & ~skip

    imm_new = (st["steps"] == 0) & (btmin <= 0.0)
    entry_c = torch.where((btmin > 0.0)[:, None], bpos, start_c + d * st["centry_t"][:, None])
    fstart_new = (entry_c - clf) * float(f)
    fcell_new = fstart_new.to(I32)
    ftmax_new = _init_tmax(fcell_new, fstart_new, d, st["step_sign"])
    fdims = torch.full((3,), f, dtype=I32, device=dev)
    fpad_new = _edge_pad(fcell_new, fdims, d)

    # ---------------- fine level ----------------
    in_range_f = ((fcell >= 0) & (fcell < fdims + st["fpad"])).all(dim=-1)
    cl_f = torch.clamp(fcell, 0, f - 1)
    bit = sample_index(cl_f[:, 0], cl_f[:, 1], cl_f[:, 2], f, f, bm.brick_layout)
    bricks = (lt.brick_lines if lt.brick_lines is not None else brick_lines_view(bm)).reshape(-1)
    word = bricks[torch.where(fine_phase, slot.long() * wpb + (bit >> 5), 0)]
    occ_f = ((word >> (bit & 31)) & 1) == 1
    fine_hit = fine_phase & in_range_f & occ_f
    fine_try = fine_phase & in_range_f & ~occ_f
    faxis, _, isect_f, fcell_adv, ftmax_adv, fnorm_adv = _advance(
        fcell, st["ftmax"], st["tdelta"], st["step_sign"], st["fstart"], d
    )
    oob_f = ((isect_f < 0.0) | (isect_f > float(f))).any(dim=-1)
    fine_step = fine_try & ~oob_f
    ascend = (fine_phase & ~in_range_f) | (fine_try & oob_f)

    # ------------- coarse advance (coarse_adv | ascend) or macro skip -------------
    do_cadv = coarse_adv | ascend
    _, tcross_c, _, ccell_adv, ctmax_adv, _ = _advance(
        ccell, st["ctmax"], st["tdelta"], st["step_sign"], start_c, d
    )
    ccell_next = torch.where(do_cadv[:, None], ccell_adv, ccell)
    ctmax_next = torch.where(do_cadv[:, None], ctmax_adv, st["ctmax"])
    centry_next = torch.where(do_cadv, tcross_c, st["centry_t"])
    new_steps = st["steps"] + (do_cadv | fine_step).to(I32)
    if use_macro:
        sk, sk_tmax, sk_t, l1 = _macro_skip(lt, bm.grid_dims, cl, rg, st)
        ccell_next = torch.where(skip[:, None], sk, ccell_next)
        ctmax_next = torch.where(skip[:, None], sk_tmax, ctmax_next)
        centry_next = torch.where(skip, sk_t, centry_next)
        new_steps = torch.where(skip, torch.clamp_max(st["steps"] + l1, max_steps), new_steps)

    dc, fs = descend[:, None], fine_step[:, None]
    hit_pos = st["fpos"] + (ccell * f).to(F32)
    hit_nrm = torch.where((st["fsteps"] == 0)[:, None], st["cnorm"], st["fnorm"])
    out = dict(st)
    out.update(
        active=active & ~fine_hit & ~coarse_miss & ~(new_steps >= max_steps),
        in_fine=(in_fine | descend) & ~ascend & ~fine_hit,
        hit=st["hit"] | fine_hit,
        imm=torch.where(descend, imm_new, st["imm"]),
        hit_imm=st["hit_imm"] | (fine_hit & (st["fsteps"] == 0) & st["imm"]),
        steps=new_steps,
        ccell=ccell_next,
        ctmax=ctmax_next,
        centry_t=centry_next,
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
    if diag:
        # a fine step that _trace_inner would pair with the next one in the
        # same iteration (double_step, pallas_bigtrace.py:1016-1051) counts
        # fstep and step2; its partner counts nothing (csrc/dda.cuh)
        in_range1 = ((fcell_adv >= 0) & (fcell_adv < fdims + st["fpad"])).all(dim=-1)
        cl1 = torch.clamp(fcell_adv, 0, f - 1)
        bit1 = sample_index(cl1[:, 0], cl1[:, 1], cl1[:, 2], f, f, bm.brick_layout)
        occ1 = ((word >> (bit1 & 31)) & 1) == 1
        _, _, isect2, _, _, _ = _advance(fcell_adv, ftmax_adv, st["tdelta"], st["step_sign"], st["fstart"], d)
        oob2 = ((isect2 < 0.0) | (isect2 > float(f))).any(dim=-1)
        pair = in_range1 & ((bit1 >> 5) == (bit >> 5)) & ~occ1 & ~oob2
        counted = fine_step & ~st["paired"]
        zero = torch.zeros_like(active)
        events = (zero, skip, coarse_adv, descend, descend, counted, counted & pair, ascend,
                  counted & faxis[:, 0] & (word == 0), zero, active)
        out["diag"] = st["diag"] + torch.stack(events, dim=1).to(I32)
        out["paired"] = torch.where(fine_step, counted & pair, st["paired"])
    return out


def trace_brickmap_lt(
    bm: BrickMap,
    lt: LineTable,
    origins: torch.Tensor,
    rays: torch.Tensor,
    max_steps: int = MAX_STEPS,
    use_macro: bool = True,
    diag: bool = False,
):
    """Plain version of K1 and K5: the two-level trace through the line
    table, one DDA event per ray per iteration (``csrc/dda.cuh``'s loop in
    torch), with the macro skips when ``use_macro``.

    Returns a :class:`TraceOut`; with ``diag`` also ``int32[11, N]``: the
    :data:`PHASES` counters, then each ray's own iteration count.  Runs at
    most ``3 * max_steps + 64`` iterations (K1's cap); a ray still active
    there reports ``max_steps``.
    """
    st = _init_state(bm, origins, rays)
    keys = _RESULT_KEYS + ("active",)
    if diag:
        st["diag"] = torch.zeros((origins.shape[0], len(PHASES) + 1), dtype=I32, device=origins.device)
        st["paired"] = torch.zeros_like(st["active"])
        keys += ("diag",)
    res = _run_loop(lambda s, _: _lt_step(bm, lt, s, max_steps, use_macro, diag), st, 3 * max_steps + 64, keys)
    imm = res["hit_imm"][:, None]
    out = TraceOut(
        hit=res["hit"],
        position=torch.where(imm, st["start_c"] * float(bm.factor), res["pos_out"]),
        normal=torch.where(imm, st["start_normal"], res["norm_out"]),
        steps=torch.where(res["active"], max_steps, res["steps"]),
    )
    return (out, res["diag"].t().contiguous()) if diag else out


def prepared_rays(bm: BrickMap, origins, rays):
    """Ray setup of the prepared-ray form (the record kernel,
    ``kernels/crossings.py``, and the host twins of K1, K4 and K5 that the
    CPU tests hold to the JAX kernels): ``(start_c, d, active, pad,
    start_normal)``, contiguous, on the rays' device."""
    gdims = _dims(bm.grid_dims, I32, origins.device)
    d, start_c, start_normal, active0 = _ray_setup(bm.grid_dims, bm.factor, origins, rays)
    pad = _edge_pad(start_c.to(I32), gdims, d)
    return start_c.contiguous(), d.contiguous(), active0.to(I32), pad.contiguous(), start_normal


def _kernel_tables(bm: BrickMap, lt: LineTable, max_steps: int, use_macro: bool):
    """The line-table kernels' table arguments, positional and keyword."""
    brick_lines = lt.brick_lines if lt.brick_lines is not None else brick_lines_view(bm)
    kw = dict(grid_dims=bm.grid_dims, region_dims=lt.region_dims, factor=bm.factor, wpb=bm.words_per_brick,
              max_steps=max_steps, brick_layout=bm.brick_layout, use_macro=use_macro)
    return (lt.region_lines, brick_lines, lt.macro, lt.macro2), kw


def _is_cuda(t: torch.Tensor) -> bool:
    """Whether rays on ``t``'s device go to K1 (one place, so a test can
    route a CPU call as a card call)."""
    return t.is_cuda


def trace_brickmap_k1(bm: BrickMap, lt: LineTable, origins: torch.Tensor, rays: torch.Tensor, max_steps: int,
                      use_macro: bool, diag: bool = False):
    """One K1 launch whatever the rays' device: :func:`trace_brickmap_hbm`'s
    card branch, K1's rays entry (the ray setup, the walk and the
    ``hit_imm`` fix-up in the launch).  Returns the :class:`TraceOut`, with
    ``diag`` also the ``int32[11, N]`` counters."""
    from voxelengine_tpu_torch.kernels import bigtrace as k1

    tables, kw = _kernel_tables(bm, lt, max_steps, use_macro)
    outs = k1.bigtrace_rays(origins.to(F32), rays.to(F32), *tables, diag=diag, **kw)
    res = TraceOut(*outs[:4])
    return (res, outs[4]) if diag else res


def record_brickmap_k1(bm: BrickMap, lt: LineTable, origins: torch.Tensor, rays: torch.Tensor, max_steps: int):
    """The ray API's result record (``engine/raytracer.py::RayTraceResults``'s
    fields) of rays on the card in one K1 launch, its record entry: the
    macro levels off (``trace_brickmap``'s function, as the facade traces
    it), the record stored by the thread that walked the ray."""
    from voxelengine_tpu_torch.kernels import bigtrace as k1

    tables, kw = _kernel_tables(bm, lt, max_steps, False)
    del kw["use_macro"]
    return k1.bigtrace_record(origins.to(F32), rays.to(F32), *tables, **kw)


def trace_brickmap_hbm(
    bm: BrickMap,
    lt: LineTable,
    origins: torch.Tensor,
    rays: torch.Tensor,
    max_steps: int = MAX_STEPS,
    use_macro: bool = True,
    return_iters: bool = False,
    return_phases: bool = False,
):
    """Two-level brickmap trace through the line table.

    Hits, positions, normals and steps are the JAX package's
    ``trace_brickmap_hbm``'s (macro skips charge the exact L1 chunk
    distance).  Rays on a CUDA device run in K1 (one launch); rays on the
    CPU run the plain :func:`trace_brickmap_lt`, or with ``use_macro=False``
    and no counters the plain chunk-by-chunk
    :func:`~voxelengine_tpu_torch.ops.trace.trace_brickmap` (the line-table
    walk, the same function, where the world's bricks stay on the host).

    Returns the :class:`TraceOut`, as the JAX function does; with
    ``return_iters`` also each ray's iteration count (on the card the loop
    count of its warp's longest lane, where the TPU reports its tile's; on
    the CPU the ray's own), with ``return_phases`` also a dict of the
    :data:`PHASES` counters plus ``"iters"``: ``res``, ``(res, iters)``,
    ``(res, phases)`` or ``(res, iters, phases)``.
    """
    diag = return_iters or return_phases
    if not _is_cuda(origins):
        if use_macro or diag or bm.bricks is None:
            res = trace_brickmap_lt(bm, lt, origins, rays, max_steps, use_macro, diag)
        else:
            res = trace_brickmap(bm, origins, rays, max_steps)
    else:
        res = trace_brickmap_k1(bm, lt, origins, rays, max_steps, use_macro, diag)
    if not diag:
        return res
    res, dg = res
    phases = {k: dg[i] for i, k in enumerate(PHASES)}
    phases["iters"] = dg[len(PHASES)]
    if return_phases:
        return (res, phases["iters"], phases) if return_iters else (res, phases)
    return res, phases["iters"]


def trace_secondary_hbm(bm: BrickMap, lt: LineTable, kind: str, out: TraceOut, dirs, px, py, env, frame_number: int,
                        cfg) -> object:
    """One kind of the shading's secondary rays (``ops/secondary.py``) of
    the primary trace ``out`` through the line table, with the macro levels
    as ``cfg.trace_use_macro``: for CUDA tensors one launch of K1's
    secondary entry (the rays built, walked and reduced in the launch), for
    CPU tensors the plain :func:`~voxelengine_tpu_torch.ops.secondary.
    secondary_plain` over :func:`trace_brickmap_hbm`.  ``dirs``, ``px``,
    ``py`` are the primary rays' raw directions and pixels, ``env`` the
    frame's :class:`~voxelengine_tpu_torch.config.Environment`.  Returns
    the kind's results (``secondary_plain``'s)."""
    use_macro = cfg.trace_use_macro
    if not _is_cuda(out.position):
        def trace(o, d, max_steps):
            return trace_brickmap_hbm(bm, lt, o, d, max_steps, use_macro=use_macro)

        return secondary_plain(kind, trace, out, dirs, px, py, env, frame_number, cfg)
    from voxelengine_tpu_torch.kernels import bigtrace as k1

    tables, kw = _kernel_tables(bm, lt, walk_steps(kind, cfg), use_macro)
    return k1.bigtrace_secondary(kind, out.position, out.normal, *tables, light=env.light_direction,
                                 dirs=dirs.to(F32), px=px, py=py, width=cfg.width, frame_number=frame_number,
                                 ao_samples=cfg.ao_samples, **kw)


def trace_brickmap_hbm_rr(
    bm: BrickMap,
    lt: LineTable,
    origins: torch.Tensor,
    rays: torch.Tensor,
    max_steps: int = MAX_STEPS,
    use_macro: bool = True,
    refill: Optional[int] = None,
) -> TraceOut:
    """:func:`trace_brickmap_hbm`'s function through K5, the persistent-
    threads kernel (counterpart of the JAX package's row-retirement
    ``trace_brickmap_hbm_rr``): a grid sized to the card whose warps refill
    a lane with a new ray as soon as ``refill`` (1-32; ``None``: the
    kernel's measured default, ``kernels/rrtrace.py::REFILL``) of their
    lanes are idle.  On the card one launch of K5's rays entry (the ray
    setup and the ``hit_imm`` fix-up in the launch); rays on the CPU run
    the same plain versions as :func:`trace_brickmap_hbm`."""
    if not _is_cuda(origins):
        if use_macro:
            return trace_brickmap_lt(bm, lt, origins, rays, max_steps, use_macro)
        return trace_brickmap(bm, origins, rays, max_steps)
    from voxelengine_tpu_torch.kernels import rrtrace as k5

    tables, kw = _kernel_tables(bm, lt, max_steps, use_macro)
    outs = k5.rrtrace_rays(origins.to(F32), rays.to(F32), *tables, refill=k5.REFILL if refill is None else refill,
                           **kw)
    return TraceOut(*outs)


def trace_brickmap_hbm_staged(
    bm: BrickMap,
    lt: LineTable,
    origins: torch.Tensor,
    rays: torch.Tensor,
    max_steps: int = MAX_STEPS,
    stage_steps: int = 128,
    tail_frac: int = 8,
    use_macro: bool = True,
) -> TraceOut:
    """Straggler-compacted trace (counterpart of the JAX package's
    ``trace_brickmap_hbm_staged``, ``pallas_bigtrace.py:428-522``).

    Traces every ray at the budget ``stage_steps``, then retraces from
    scratch at ``max_steps`` every 128-ray row that holds a ray cut by that
    budget (not hit, ``steps >= stage_steps``) and merges the rows back.  A
    retrace follows the same path, so the result equals one
    :func:`trace_brickmap_hbm` call at ``max_steps``.  When more than
    ``ceil(rows / tail_frac)`` rows survive, everything is retraced at full
    width instead (the overflow rescue).  Where JAX keeps the row count on
    the device, this reads it on the host: one stream synchronisation.
    """
    n = origins.shape[0]
    out1 = trace_brickmap_hbm(bm, lt, origins, rays, stage_steps, use_macro)
    surv = ~out1.hit & (out1.steps >= stage_steps)
    padn = (-n) % 128
    nrows = (n + padn) // 128

    def rows(a, fill=0):
        if padn:
            a = torch.cat([a, torch.full((padn,) + a.shape[1:], fill, dtype=a.dtype, device=a.device)])
        return a.reshape((nrows, 128) + a.shape[1:])

    row_idx = torch.nonzero(rows(surv).any(dim=1)).squeeze(1)  # the one host read
    if row_idx.numel() == 0:
        return out1
    if row_idx.numel() > min(nrows, -(-nrows // tail_frac)):
        return trace_brickmap_hbm(bm, lt, origins, rays, max_steps, use_macro)
    out2 = trace_brickmap_hbm(
        bm, lt, rows(origins)[row_idx].reshape(-1, 3),
        rows(rays, 1.0)[row_idx].reshape(-1, 3),  # no zero-direction pad rays
        max_steps, use_macro,
    )

    def merge(full, tail):
        full = rows(full).clone()
        full[row_idx] = tail.reshape((-1, 128) + full.shape[2:])
        return full.reshape((nrows * 128,) + full.shape[2:])[:n]

    return TraceOut(*(merge(a, b) for a, b in zip(out1, out2)))
