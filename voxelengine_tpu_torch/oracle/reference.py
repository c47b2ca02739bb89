"""Scalar numpy oracle with the reference engine's exact traversal semantics:
the PyTorch port's own copy of ``voxelengine_tpu/oracle/reference.py``.

numpy only; the port keeps this copy so that it imports nothing of the JAX
package (``voxelengine_tpu_torch/apps/bench_configs.py``'s config 1 holds
the kernels' hits against it).  Everything below is the JAX package's
module as it stands, with that module's notes:

Scalar numpy oracle with the reference engine's exact traversal semantics.

This module transliterates the *behavior* (not the code) of the reference's
device traversal into readable scalar numpy float32, serving the role the 2D
``DDATestCpp`` prototype plays for the CUDA engine (``DDATestCpp.cpp:26-260``):
a deterministic CPU implementation every fast path is validated against.

Covered semantics, each cited to the reference:
* ``DDARayTraversal`` (``VolumeRaytracer.cu:176-352``): Amanatides-Woo 3D DDA
  with per-axis tie-breaking (x if strictly smallest, else y on ties with x,
  else z), the max-edge padding hack for rays starting exactly on a maximal
  face with a negative direction component (``:216-232``), optional per-voxel
  tight-AABB refinement (``:248-272``), optional hard bounds clip flagging
  out-of-bounds (``:325-341``), and ``takeInitialStep`` (``:236-238``).
* Two-level ``Raytrace`` (``VolumeRaytracer.cu:354-525``): origin scaled into
  coarse space, world-AABB entry clip with entry normal (``:369-381``),
  coarse DDA with tight bounds -> fine DDA clipped to ``[0, factor]^3``,
  ``nextafter`` epsilon-nudging across chunk borders with
  smallest-diff-axis fallback (``:438-489``), repeat-cell infinite-loop
  guard (``:402-407``), normal selection (chunk-entry normal when the fine
  DDA hits at step 0, else the fine step normal, ``:495-503``), and the
  degenerate 0-step hit returning the clipped entry point (``:518-522``).

All arithmetic is float32 to match the GPU.  This oracle intentionally
reproduces reference quirks (e.g. the repeat-cell guard can kill a ray that
legitimately re-enters a chunk); the production traversal in
``voxelengine_tpu/ops/trace.py`` resumes the coarse DDA instead, which is
strictly more robust.  The resulting deviation is MEASURED, not budgeted:
over a 1M-ray campaign (PARITY.md round-4 table,
``experiments/oracle_deviation.py``) generic rays show zero hit mismatches;
all 37 deviations live in an adversarial exact-lattice-corner graze class
(guard kills + corner-tie immediate hits), bounded by
``tests/test_oracle_parity.py::test_deviation_rate_bounds``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np

F32 = np.float32
INF = np.float32(np.inf)
FLT_EPS = np.float32(np.finfo(np.float32).eps)
FLT_EPS_DDA = np.float32(1e-6)
MAX_STEPS = 2048


@dataclasses.dataclass
class DDAResult:
    hit: bool = False
    out_of_bounds: bool = False
    hit_cell: Optional[np.ndarray] = None
    hit_point: Optional[np.ndarray] = None
    next_cell: Optional[np.ndarray] = None
    normal: Optional[np.ndarray] = None
    steps: int = 0


def ray_aabb(start, direction, bmin, bmax):
    """Scalar slab test (``VolumeRaytracer.cu:124-174``)."""
    start = np.asarray(start, F32)
    direction = np.asarray(direction, F32)
    inv = np.empty(3, F32)
    for a in range(3):
        d = direction[a] if direction[a] != 0 else FLT_EPS
        inv[a] = F32(1.0) / d
    t_lo = (np.asarray(bmin, F32) - start) * inv
    t_hi = (np.asarray(bmax, F32) - start) * inv
    t1 = np.minimum(t_lo, t_hi)
    t2 = np.maximum(t_lo, t_hi)
    t_min = F32(max(t1[0], t1[1], t1[2]))
    t_max = F32(min(t2[0], t2[1], t2[2]))
    if t_max < max(t_min, F32(0.0)):
        return False, None, None
    point = start + t_min * direction
    if t_min == t1[0]:
        normal = np.array([-1.0 if inv[0] < 0 else 1.0, 0.0, 0.0], F32)
    elif t_min == t1[1]:
        normal = np.array([0.0, -1.0 if inv[1] < 0 else 1.0, 0.0], F32)
    else:
        normal = np.array([0.0, 0.0, -1.0 if inv[2] < 0 else 1.0], F32)
    return True, point, normal


def dda_traversal(
    occupancy,  # callable (ix, iy, iz) -> bool, for cells in [0, dims)
    dims,  # (cols, rows, depth) = (X, Y, Z)
    start,
    direction,
    max_steps: int = MAX_STEPS,
    bounds: Optional[Tuple[np.ndarray, np.ndarray]] = None,
    per_voxel_bounds=None,  # callable (ix,iy,iz) -> (bmin[3], bmax[3]) or None
    per_voxel_bounds_scale: int = 0,
    take_initial_step: bool = False,
    record: Optional[list] = None,
) -> DDAResult:
    """Single-level DDA with reference semantics (``VolumeRaytracer.cu:176-352``).

    ``record``: optional list; every boundary crossing appends
    ``((ix, iy, iz), point)`` — the cell ENTERED and the float32 crossing
    position — the role of the reference's ``RECORD_INTERSECTED_POINTS``
    build (``DDATestCpp.cpp:15-25,129-131``).
    """
    start = np.asarray(start, F32)
    direction = np.asarray(direction, F32)
    x, y, z = start
    dx, dy, dz = direction
    cell = np.array([int(x), int(y), int(z)], np.int64)
    cols, rows, depth = int(dims[0]), int(dims[1]), int(dims[2])

    step = np.array([1 if dx > 0 else -1, 1 if dy > 0 else -1, 1 if dz > 0 else -1])
    t_delta = np.array(
        [
            abs(F32(1.0) / dx) if dx != 0 else INF,
            abs(F32(1.0) / dy) if dy != 0 else INF,
            abs(F32(1.0) / dz) if dz != 0 else INF,
        ],
        F32,
    )
    t_max = np.array(
        [
            ((F32(cell[0] + (step[0] > 0)) - x) / dx) if dx != 0 else INF,
            ((F32(cell[1] + (step[1] > 0)) - y) / dy) if dy != 0 else INF,
            ((F32(cell[2] + (step[2] > 0)) - z) / dz) if dz != 0 else INF,
        ],
        F32,
    )

    res = DDAResult()
    res.hit_point = start.copy()
    res.normal = np.zeros(3, F32)

    # max-edge padding (VolumeRaytracer.cu:216-232)
    pad = np.zeros(3, np.int64)
    if cell[0] == cols or cell[1] == rows or cell[2] == depth:
        if dx < 0:
            pad[0] = 1
        if dy < 0:
            pad[1] = 1
        if dz < 0:
            pad[2] = 1

    exit_flag = False
    for it in range(max_steps):
        skip_check = take_initial_step and it == 0
        if not skip_check:
            if (
                0 <= cell[0] < cols + pad[0]
                and 0 <= cell[1] < rows + pad[1]
                and 0 <= cell[2] < depth + pad[2]
            ):
                cl = np.minimum(np.maximum(cell, 0), [cols - 1, rows - 1, depth - 1])
                res.hit_cell = cl.astype(F32)
                if per_voxel_bounds is not None:
                    pb = per_voxel_bounds(cl[0], cl[1], cl[2])
                    if pb is not None:
                        pmin, pmax = pb
                        s = F32(per_voxel_bounds_scale)
                        bmin = (np.asarray(pmin, F32) + F32(0)) / s + cl.astype(F32)
                        bmax = (np.asarray(pmax, F32) + F32(1)) / s + cl.astype(F32)
                        if occupancy(cl[0], cl[1], cl[2]) and bmin[0] <= bmax[0]:
                            ok, pt, nrm = ray_aabb(start, direction, bmin, bmax)
                            if ok:
                                res.hit = True
                                res.normal = nrm
                                if it != 0:
                                    res.hit_point = pt
                                exit_flag = True
                else:
                    if occupancy(cl[0], cl[1], cl[2]):
                        res.hit = True
                        exit_flag = True
            else:
                res.out_of_bounds = True
                exit_flag = True

        # advance (VolumeRaytracer.cu:290-322)
        if t_max[0] < t_max[1] and t_max[0] < t_max[2]:
            isect = np.array(
                [F32(cell[0] + (step[0] > 0)), y + t_max[0] * dy, z + t_max[0] * dz], F32
            )
            cell[0] += step[0]
            t_max[0] += t_delta[0]
            if not exit_flag:
                res.normal = np.array([step[0], 0, 0], F32)
        elif t_max[1] <= t_max[0] and t_max[1] < t_max[2]:
            isect = np.array(
                [x + t_max[1] * dx, F32(cell[1] + (step[1] > 0)), z + t_max[1] * dz], F32
            )
            cell[1] += step[1]
            t_max[1] += t_delta[1]
            if not exit_flag:
                res.normal = np.array([0, step[1], 0], F32)
        else:
            isect = np.array(
                [x + t_max[2] * dx, y + t_max[2] * dy, F32(cell[2] + (step[2] > 0))], F32
            )
            cell[2] += step[2]
            t_max[2] += t_delta[2]
            if not exit_flag:
                res.normal = np.array([0, 0, step[2]], F32)

        if not exit_flag:
            if bounds is not None:
                bmn, bmx = bounds
                if (
                    isect[0] < int(bmn[0]) or isect[0] > int(bmx[0])
                    or isect[1] < int(bmn[1]) or isect[1] > int(bmx[1])
                    or isect[2] < int(bmn[2]) or isect[2] > int(bmx[2])
                ):
                    res.out_of_bounds = True
                    break
            res.steps += 1
            if record is not None:
                record.append(((int(cell[0]), int(cell[1]), int(cell[2])),
                               isect.copy()))
            res.hit_point = isect
        else:
            res.next_cell = cell.astype(F32)
            break

    return res


@dataclasses.dataclass
class TraceResult:
    hit: bool = False
    position: Optional[np.ndarray] = None
    normal: Optional[np.ndarray] = None
    steps: int = 0
    # True when the repeat-cell infinite-loop guard (VolumeRaytracer.cu:402-407)
    # terminated the trace: the one reference quirk the production traversal
    # deliberately does NOT reproduce (ops/trace.py resumes the coarse DDA
    # instead).  Parity harnesses use this to attribute mismatches.
    guard_tripped: bool = False


def raytrace_brickmap(
    coarse_occupancy,  # callable (cx,cy,cz) -> bool
    coarse_dims,  # (gx, gy, gz)
    brick_occupancy,  # callable (cx,cy,cz, lx,ly,lz) -> bool
    chunk_bounds,  # callable (cx,cy,cz) -> (bmin[3], bmax[3]) chunk-local ints
    factor: int,
    origin,
    ray,
    max_steps: int = MAX_STEPS,
    record: Optional[list] = None,
) -> TraceResult:
    """Two-level hierarchical trace with reference semantics
    (``VolumeRaytracer.cu:354-525``).

    ``record``: optional list; every boundary crossing appends
    ``("coarse", cell, point)`` (chunk units) or
    ``("fine", cell, point, chunk)`` (cell/point chunk-local in voxel
    units, plus the chunk being walked — the spaces the crossing-trace
    kernel dump uses).
    """
    out = TraceResult()
    f = F32(factor)
    previous_cell = np.array([-1, -1, -1], F32)
    total_steps = 0

    start = np.asarray(origin, F32) / f
    direction = np.asarray(ray, F32)
    direction = direction / F32(np.sqrt(np.float32(np.dot(direction, direction))))
    start_normal = np.zeros(3, F32)
    gx, gy, gz = coarse_dims

    inside = (
        start[0] >= 0 and start[1] >= 0 and start[2] >= 0
        and start[0] < gx and start[1] < gy and start[2] < gz
    )
    if not inside:
        ok, pt, nrm = ray_aabb(
            start,
            direction,
            np.array([FLT_EPS_DDA] * 3, F32),
            np.array([gx - FLT_EPS_DDA, gy - FLT_EPS_DDA, gz - FLT_EPS_DDA], F32),
        )
        if ok:
            start = pt
            start_normal = nrm

    out.normal = np.zeros(3, F32)
    hit_position = np.zeros(3, F32)
    hit = False

    while total_steps < max_steps:
        rec_c = [] if record is not None else None
        res = dda_traversal(
            coarse_occupancy,
            coarse_dims,
            start,
            direction,
            max_steps=MAX_STEPS,
            per_voxel_bounds=chunk_bounds,
            per_voxel_bounds_scale=factor,
            record=rec_c,
        )
        if record is not None:
            record.extend(("coarse", c, p) for c, p in rec_c)
        total_steps += res.steps
        start_high_res = res.hit_point * f
        hit_position = start_high_res.copy()
        if res.hit and not res.out_of_bounds:
            if np.array_equal(previous_cell, res.hit_cell):
                out.guard_tripped = True
                break  # repeat-cell guard (VolumeRaytracer.cu:402-407)
            previous_cell = res.hit_cell.copy()
            cellf = res.hit_cell * f
            local = start_high_res - cellf
            cx, cy, cz = int(res.hit_cell[0]), int(res.hit_cell[1]), int(res.hit_cell[2])

            rec_f = [] if record is not None else None
            res_hr = dda_traversal(
                lambda lx, ly, lz: brick_occupancy(cx, cy, cz, lx, ly, lz),
                (factor, factor, factor),
                local,
                direction,
                max_steps=MAX_STEPS,
                bounds=(np.zeros(3, F32), np.array([f, f, f], F32)),
                record=rec_f,
            )
            if record is not None:
                record.extend(("fine", c, p, (cx, cy, cz)) for c, p in rec_f)
            total_steps += res_hr.steps
            hit_position = res_hr.hit_point + cellf

            if not res_hr.hit:
                start = hit_position / f
                if res_hr.out_of_bounds:
                    # nextafter nudging (VolumeRaytracer.cu:438-489)
                    c = np.array([int(start[0]), int(start[1]), int(start[2])])
                    same = cx == c[0] and cy == c[1] and cz == c[2]
                    if same:
                        for a, ca in ((0, cx), (1, cy), (2, cz)):
                            if ca == c[a]:
                                start[a] = np.nextafter(
                                    start[a], -INF if direction[a] < 0 else INF, dtype=F32
                                )
                        c = np.array([int(start[0]), int(start[1]), int(start[2])])
                        same = cx == c[0] and cy == c[1] and cz == c[2]
                        if same and res.next_cell is not None:
                            # NB: the reference uses the *coarse* DDA's NextCell
                            # here (VolumeRaytracer.cu:473)
                            diff = res.next_cell - start
                            adiff = np.abs(diff)
                            if adiff[0] < adiff[1] and adiff[0] < adiff[2]:
                                start[0] += diff[0]
                            elif adiff[1] < adiff[0] and adiff[1] < adiff[2]:
                                start[1] += diff[1]
                            else:
                                start[2] += diff[2]
                continue
            else:
                if res_hr.steps == 0:
                    out.normal = res.normal
                else:
                    out.normal = res_hr.normal
                hit = True
                break
        else:
            break

    out.steps = total_steps
    out.hit = hit
    if hit:
        out.position = hit_position
        if total_steps == 0:
            out.position = start * f
            out.normal = start_normal
    return out


def make_grid_callbacks(dense):
    """Occupancy callback over a dense bool array indexed [z, y, x]."""
    zdim, ydim, xdim = dense.shape

    def occ(ix, iy, iz):
        return bool(dense[int(iz), int(iy), int(ix)])

    return occ, (xdim, ydim, zdim)


def make_brickmap_callbacks(dense, factor):
    """Build coarse/brick/bounds callbacks from a dense [z,y,x] bool array,
    mirroring ``GenerateLowresVoxelBuffer`` (``VolumeRaytracer.cuh:379-516``)."""
    zdim, ydim, xdim = dense.shape
    gx, gy, gz = xdim // factor, ydim // factor, zdim // factor
    blocks = dense.reshape(gz, factor, gy, factor, gx, factor).transpose(0, 2, 4, 1, 3, 5)
    occ = blocks.any(axis=(3, 4, 5))  # [gz, gy, gx]

    bounds = {}
    for cz in range(gz):
        for cy in range(gy):
            for cx in range(gx):
                blk = blocks[cz, cy, cx]  # [z, y, x]
                if blk.any():
                    zz, yy, xx = np.nonzero(blk)
                    bounds[(cx, cy, cz)] = (
                        np.array([xx.min(), yy.min(), zz.min()], F32),
                        np.array([xx.max(), yy.max(), zz.max()], F32),
                    )

    def coarse(cx, cy, cz):
        return bool(occ[int(cz), int(cy), int(cx)])

    def brick(cx, cy, cz, lx, ly, lz):
        return bool(blocks[int(cz), int(cy), int(cx), int(lz), int(ly), int(lx)])

    def chunk_bounds(cx, cy, cz):
        return bounds.get((int(cx), int(cy), int(cz)), (np.zeros(3, F32), np.full(3, -1, F32)))

    return coarse, (gx, gy, gz), brick, chunk_bounds
