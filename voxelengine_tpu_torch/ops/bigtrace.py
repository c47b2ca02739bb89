"""Line-table traversal: counterpart of :mod:`voxelengine_tpu.ops.pallas_bigtrace`.

The world is kept as 4 KB *lines* of ``[8, 128]`` int32 words: one line per
8x8x8-chunk *region* (512 packed meta words, then 512 brick-slot words),
plus the brick words as lines of their own.  :func:`trace_brickmap_hbm`
walks rays through these tables in the hand-written Hopper kernel
(:mod:`voxelengine_tpu_torch.kernels.bigtrace`) when the rays lie on a
CUDA device, and through the plain :func:`~voxelengine_tpu_torch.ops.trace.
trace_brickmap` when they lie on the CPU.  Both give the same hits, steps,
positions and normals.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from voxelengine_tpu_torch.config import MAX_STEPS
from voxelengine_tpu_torch.core.bitgrid import pack_bits
from voxelengine_tpu_torch.core.brickmap import BrickMap
from voxelengine_tpu_torch.core.layout import Layout, sample_index
from voxelengine_tpu_torch.ops.trace import TraceOut, _dims, _edge_pad, _ray_setup, kernel_result, trace_brickmap

I32 = torch.int32
MACRO2_WORDS = 32  # L2 capacity: 1024 super-regions
MACRO3_WORDS = 4  # L3 capacity: 128 16x1x16-region blocks


@dataclasses.dataclass(frozen=True)
class LineTable:
    """Line-table form of a brickmap (see module doc).

    ``macro``/``macro2`` are the region / super-region occupancy bits of the
    TPU kernel's macro skip levels.  They are built bit-exactly, but the
    Hopper kernel does not read them yet: it walks chunk by chunk, which
    gives the same results.
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


def trace_brickmap_hbm(
    bm: BrickMap,
    lt: LineTable,
    origins: torch.Tensor,
    rays: torch.Tensor,
    max_steps: int = MAX_STEPS,
    use_macro: bool = True,
) -> TraceOut:
    """Two-level brickmap trace through the line table.

    Same results as :func:`~voxelengine_tpu_torch.ops.trace.trace_brickmap`
    (hits, positions, normals, steps).  Rays on a CUDA device run in the
    Hopper kernel (one launch); rays on the CPU run the plain trace.
    ``use_macro`` is accepted for parity with the TPU kernel: the skip
    levels are not yet in the Hopper kernel, which walks chunk by chunk and
    so gives the same results either way.
    """
    del use_macro  # see docstring
    if not origins.is_cuda:
        return trace_brickmap(bm, origins, rays, max_steps)

    from voxelengine_tpu_torch.kernels import bigtrace as k1

    f = bm.factor
    gdims = _dims(bm.grid_dims, I32, origins.device)
    d, start_c, start_normal, active0 = _ray_setup(bm.grid_dims, f, origins, rays)
    pad = _edge_pad(start_c.to(I32), gdims, d)
    brick_lines = lt.brick_lines if lt.brick_lines is not None else brick_lines_view(bm)
    flags, pos, nrm, steps = k1.bigtrace(
        start_c, d, active0.to(I32), pad, lt.region_lines, brick_lines,
        grid_dims=bm.grid_dims, region_dims=lt.region_dims, factor=f,
        wpb=bm.words_per_brick, max_steps=max_steps, brick_layout=bm.brick_layout,
    )
    return kernel_result(flags, pos, nrm, steps, start_c, start_normal, f)
