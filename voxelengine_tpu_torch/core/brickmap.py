"""Two-level brickmap world: counterpart of :mod:`voxelengine_tpu.core.brickmap`.

Three flat tensors on one device:

* ``meta`` — ``int32[num_chunks]``: occupancy bit 30 and the chunk's tight
  AABB in six 5-bit fields (:func:`pack_meta`);
* ``brick_idx`` — ``int32[num_chunks]``: chunk -> brick slot.  In the
  compact form slot 0 is the shared all-full brick and -1 an empty chunk;
* ``bricks`` — ``int32[num_bricks, words_per_brick]``: packed per-chunk
  occupancy in brick-layout order (uint32 bit patterns held as int32).

Builders (streamed by z-slab on the device; the terrain builds through W1
on the card), :func:`compact_brickmap`, and in-place edits of dense-slot
worlds (:func:`apply_edits`).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import numpy as np
import torch

from voxelengine_tpu_torch.config import default_device
from voxelengine_tpu_torch.core.bitgrid import (
    BitGrid,
    layout_order_bits,
    pack_bits,
    unpack_bits,
    words_for_bits,
    write_bits,
)
from voxelengine_tpu_torch.core.layout import Layout, sample_index

# meta word: [4:0]=min_x [9:5]=min_y [14:10]=min_z [19:15]=max_x
# [24:20]=max_y [29:25]=max_z [30]=occupied (factor <= 32)
META_OCC_BIT = 30


def choose_layout(dims: Tuple[int, int, int], want: Layout) -> Layout:
    """Fall back to LINEAR when dims aren't tileable by 8."""
    if want is Layout.LINEAR or all(d % 8 == 0 for d in dims):
        return want
    return Layout.LINEAR


def _full_brick_words(factor: int) -> np.ndarray:
    """The canonical all-full brick (``int32[wpb]`` bit patterns): all ones,
    with the tail bits beyond ``factor^3`` masked off for tiny bricks."""
    wpb = words_for_bits(factor**3)
    bits = np.arange(wpb * 32) < factor**3
    words = np.packbits(bits.reshape(wpb, 32), axis=1, bitorder="little")
    return words.view("<u4").reshape(wpb).astype(np.uint32).view(np.int32)


def pack_meta(occ: torch.Tensor, bmin: torch.Tensor, bmax: torch.Tensor) -> torch.Tensor:
    """Pack occupancy + tight bounds (int ``[..., 3]``, chunk-local voxels)
    into the int32 meta word."""
    bmin = bmin.to(torch.int32)
    bmax = bmax.to(torch.int32)
    return (
        bmin[..., 0]
        | (bmin[..., 1] << 5)
        | (bmin[..., 2] << 10)
        | (bmax[..., 0] << 15)
        | (bmax[..., 1] << 20)
        | (bmax[..., 2] << 25)
        | (occ.to(torch.int32) << META_OCC_BIT)
    )


def unpack_meta(meta: torch.Tensor):
    """Inverse of :func:`pack_meta` -> (occ bool, bmin [...,3], bmax [...,3])."""
    occ = ((meta >> META_OCC_BIT) & 1) == 1
    bmin = torch.stack([meta & 31, (meta >> 5) & 31, (meta >> 10) & 31], dim=-1)
    bmax = torch.stack([(meta >> 15) & 31, (meta >> 20) & 31, (meta >> 25) & 31], dim=-1)
    return occ, bmin, bmax


@dataclasses.dataclass(frozen=True)
class BrickMap:
    """Two-level brickmap world state (see module doc)."""

    meta: torch.Tensor  # int32[num_chunks]
    brick_idx: torch.Tensor  # int32[num_chunks]
    bricks: torch.Tensor  # int32[num_bricks, words_per_brick]
    grid_dims: Tuple[int, int, int]
    factor: int
    coarse_layout: Layout
    brick_layout: Layout
    dense_slots: bool

    @property
    def world_dims(self) -> Tuple[int, int, int]:
        gx, gy, gz = self.grid_dims
        return (gx * self.factor, gy * self.factor, gz * self.factor)

    @property
    def num_chunks(self) -> int:
        gx, gy, gz = self.grid_dims
        return gx * gy * gz

    @property
    def words_per_brick(self) -> int:
        return words_for_bits(self.factor**3)

    def chunk_index(self, cx, cy, cz) -> torch.Tensor:
        """Chunk index of chunk coords in ``coarse_layout``."""
        gx, gy, _ = self.grid_dims
        return sample_index(cx, cy, cz, gx, gy, self.coarse_layout)

    def voxel_bit(self, x, y, z) -> torch.Tensor:
        """Occupancy of world voxels (integer tensors of one shape).
        Out-of-range coordinates read False: clamped, they would alias real
        chunks.  Raises where the brick words live on the host
        (``io/checkpoint.py::load_world_host_bricks``)."""
        if self.bricks is None:
            raise ValueError(
                "brick words are host-resident (load_world_host_bricks placeholder); "
                "attach device bricks to query voxels"
            )
        f = self.factor
        X, Y, Z = self.world_dims
        x, y, z = (torch.as_tensor(a, device=self.meta.device) for a in (x, y, z))
        in_range = (x >= 0) & (x < X) & (y >= 0) & (y < Y) & (z >= 0) & (z < Z)
        x, y, z = torch.clamp(x, 0, X - 1), torch.clamp(y, 0, Y - 1), torch.clamp(z, 0, Z - 1)
        ci = self.chunk_index(x // f, y // f, z // f).long()
        occ, _, _ = unpack_meta(self.meta[ci])
        slot = self.brick_idx[ci].long()
        bit = sample_index(x % f, y % f, z % f, f, f, self.brick_layout)
        word = self.bricks[torch.clamp_min(slot, 0), (bit >> 5).long()]
        return (((word >> (bit & 31)) & 1) == 1) & occ & (slot >= 0) & in_range

    def to_dense(self) -> torch.Tensor:
        """The whole world as bool ``[Z, Y, X]`` (small worlds, tests)."""
        X, Y, Z = self.world_dims
        dev = self.meta.device
        x, y, z = torch.meshgrid(*(torch.arange(n, device=dev) for n in (X, Y, Z)), indexing="ij")
        return self.voxel_bit(x, y, z).permute(2, 1, 0)


def _occ_bounds(vol: torch.Tensor):
    """Occupancy and tight bounds of blocks ``bool[..., z, y, x]`` (cubes):
    ``(occ [...], lo [..., 3], hi [..., 3])``, bounds in (x, y, z) order,
    those of an empty block meaningless."""
    f, z, y, x = vol.shape[-1], vol.dim() - 3, vol.dim() - 2, vol.dim() - 1
    occ = vol.any(dim=x).any(dim=y).any(dim=z)

    def axis_bounds(axis):
        line = vol
        for a in sorted((a for a in (z, y, x) if a != axis), reverse=True):
            line = line.any(dim=a)
        line = line.to(torch.uint8)  # [..., f]; argmax takes the first max
        lo = torch.argmax(line, dim=-1)
        hi = f - 1 - torch.argmax(line.flip(-1), dim=-1)
        return lo.to(torch.int32), hi.to(torch.int32)

    (zlo, zhi), (ylo, yhi), (xlo, xhi) = axis_bounds(z), axis_bounds(y), axis_bounds(x)
    return occ, torch.stack([xlo, ylo, zlo], dim=-1), torch.stack([xhi, yhi, zhi], dim=-1)


def _slab_to_chunks(slab: torch.Tensor, factor: int, chunks_y: int, chunks_x: int, brick_layout: Layout):
    """Reduce one dense z-slab ``bool[factor, Y, X]`` to per-chunk
    (occ [cy*cx], bmin [cy*cx, 3], bmax [cy*cx, 3], words [cy*cx, wpb]),
    chunks in (cy, cx) row-major order."""
    f = factor
    # [f(z), cy, f(y), cx, f(x)] -> chunk-major [cy, cx, f(z), f(y), f(x)]
    c = slab.reshape(f, chunks_y, f, chunks_x, f).permute(1, 3, 0, 2, 4)
    occ, lo, hi = _occ_bounds(c)
    # empty chunks: min=0, max=-1 (VolumeRaytracer.cuh:454-463); read only if occ
    bmin = lo * occ[..., None]
    bmax = torch.where(occ[..., None], hi, -1)

    bits = layout_order_bits(c.reshape(chunks_y * chunks_x, f, f, f), brick_layout)
    nbits = words_for_bits(f**3) * 32
    if bits.shape[1] < nbits:
        pad = torch.zeros((bits.shape[0], nbits - bits.shape[1]), dtype=torch.bool, device=bits.device)
        bits = torch.cat([bits, pad], dim=1)
    return occ.reshape(-1), bmin.reshape(-1, 3), bmax.reshape(-1, 3), pack_bits(bits)


def build_brickmap_from_fn(
    slab_fn: Callable[[int], torch.Tensor],
    world_dims: Tuple[int, int, int],
    factor: int,
    coarse_layout: Layout = Layout.TILED_LINEAR,
    brick_layout: Layout = Layout.TILED_LINEAR,
    dense_slots: bool = False,
    dedupe_uniform: bool = True,
    device=default_device(),
) -> BrickMap:
    """Build a :class:`BrickMap` on ``device`` by streaming dense z-slabs.

    ``slab_fn(z0)`` returns the dense occupancy slab ``bool[factor, Y, X]``
    of world rows ``z0 .. z0+factor`` (a tensor or array; it is moved to
    ``device``).  The reduction, brick packing and slot assignment of each
    slab stay on ``device``.

    dense_slots: every chunk owns the brick slot of its chunk index.
    dedupe_uniform: in compact mode, all-full bricks share slot 0; empty
      chunks get -1 either way.  Kept bricks are numbered in build order
      (z-slab, then chunk row), as in the JAX builder.
    """
    X, Y, Z = world_dims
    f = factor
    _check_dims(world_dims, f)
    brick_layout = choose_layout((f, f, f), brick_layout)

    def chunks_fn(z0):
        slab = torch.as_tensor(slab_fn(z0), device=device)
        return _slab_to_chunks(slab, f, Y // f, X // f, brick_layout)

    return build_brickmap_from_chunks(
        chunks_fn, world_dims, f, coarse_layout=coarse_layout, brick_layout=brick_layout,
        dense_slots=dense_slots, dedupe_uniform=dedupe_uniform, device=device,
    )


def _check_dims(world_dims, f: int) -> None:
    if any(d % f for d in world_dims) or f > 32:
        raise ValueError(f"world dims {world_dims} must be multiples of factor {f} <= 32")


def build_brickmap_from_chunks(
    chunks_fn: Callable[[int], Tuple[torch.Tensor, ...]],
    world_dims: Tuple[int, int, int],
    factor: int,
    coarse_layout: Layout = Layout.TILED_LINEAR,
    brick_layout: Layout = Layout.TILED_LINEAR,
    dense_slots: bool = False,
    dedupe_uniform: bool = True,
    device=default_device(),
) -> BrickMap:
    """:func:`build_brickmap_from_fn` from each slab's chunks:
    ``chunks_fn(z0)`` returns what :func:`_slab_to_chunks` returns for world
    rows ``z0 .. z0+factor`` (``occ``, ``bmin``, ``bmax`` and the words in
    ``brick_layout``, which must be a layout :func:`choose_layout` keeps),
    on ``device``."""
    X, Y, Z = world_dims
    f = factor
    _check_dims(world_dims, f)
    gx, gy, gz = X // f, Y // f, Z // f
    coarse_layout = choose_layout((gx, gy, gz), coarse_layout)
    if choose_layout((f, f, f), brick_layout) is not brick_layout:
        raise ValueError(f"brick layout {brick_layout.name} needs a factor divisible by 8, got {f}")
    wpb = words_for_bits(f**3)
    full = torch.as_tensor(_full_brick_words(f), device=device)
    dedupe = dedupe_uniform and not dense_slots

    occ_parts, bmin_parts, bmax_parts, slot_parts = [], [], [], []
    brick_parts = [full[None, :]] if dedupe else []
    next_slot = 1 if dedupe else 0
    for cz in range(gz):
        occ, bmn, bmx, words = chunks_fn(cz * f)
        occ_parts.append(occ)
        bmin_parts.append(bmn)
        bmax_parts.append(bmx)
        if dense_slots:
            brick_parts.append(words)
            continue
        keep = occ
        slots = torch.full((gy * gx,), -1, dtype=torch.int32, device=device)
        if dedupe:
            is_full = (words == full[None, :]).all(dim=1)
            slots[occ & is_full] = 0
            keep = occ & ~is_full
        cnt = int(keep.sum())
        slots[keep] = next_slot + torch.arange(cnt, dtype=torch.int32, device=device)
        next_slot += cnt
        brick_parts.append(words[keep])
        slot_parts.append(slots)

    # build order (cz, cy, cx) is the LINEAR chunk index; other coarse
    # layouts gather into their order
    perm = None
    if coarse_layout is not Layout.LINEAR:
        cz_, cy_, cx_ = torch.meshgrid(*(torch.arange(n, device=device) for n in (gz, gy, gx)), indexing="ij")
        perm = torch.empty((gx * gy * gz,), dtype=torch.int64, device=device)
        perm[sample_index(cx_, cy_, cz_, gx, gy, coarse_layout).reshape(-1)] = torch.arange(
            perm.numel(), device=device
        )

    def ordered(parts):
        a = torch.cat(parts)
        return a if perm is None else a[perm]

    meta = pack_meta(ordered(occ_parts), ordered(bmin_parts).clamp_min(0), ordered(bmax_parts).clamp_min(0))
    if dense_slots:
        bricks = ordered(brick_parts)
        brick_idx = torch.arange(gx * gy * gz, dtype=torch.int32, device=device)
    else:
        bricks = torch.cat(brick_parts)
        if bricks.shape[0] == 0:
            bricks = torch.zeros((1, wpb), dtype=torch.int32, device=device)
        brick_idx = ordered(slot_parts)
    return BrickMap(
        meta=meta,
        brick_idx=brick_idx,
        bricks=bricks,
        grid_dims=(gx, gy, gz),
        factor=f,
        coarse_layout=coarse_layout,
        brick_layout=brick_layout,
        dense_slots=dense_slots,
    )


def build_brickmap(
    grid: BitGrid,
    factor: int,
    dense_slots: bool = True,
    dedupe_uniform: bool = False,
    coarse_layout: Layout = Layout.TILED_LINEAR,
    brick_layout: Layout = Layout.TILED_LINEAR,
) -> BrickMap:
    """A brickmap of an in-memory :class:`BitGrid`, on the grid's device
    (``GenerateLowresVoxelBuffer``, ``VolumeRaytracer.cuh:379``).  Defaults
    to dense slots, like the reference demo's always-allocated chunks."""
    dense = grid.to_dense()  # [Z, Y, X]
    return build_brickmap_from_fn(
        lambda z0: dense[z0 : z0 + factor], grid.dims, factor,
        coarse_layout=coarse_layout, brick_layout=brick_layout,
        dense_slots=dense_slots, dedupe_uniform=dedupe_uniform, device=grid.words.device,
    )


def terrain_slab_chunks_plain(z0: int, world_dims, factor: int, brick_layout: Layout, octaves: int,
                              seed: int = 0x71889283, device=default_device()):
    """W1's plain version: the plain ``solid_at`` slab of world rows ``z0 ..
    z0+factor`` on ``device``, reduced by :func:`_slab_to_chunks`."""
    from voxelengine_tpu_torch.worldgen.terrain import solid_at

    X, Y, _ = world_dims
    y = torch.arange(Y, device=device)[None, :, None]
    x = torch.arange(X, device=device)[None, None, :]
    slab = solid_at(x, y, z0 + torch.arange(factor, device=device)[:, None, None], seed, octaves)
    return _slab_to_chunks(slab, factor, Y // factor, X // factor, brick_layout)


def terrain_slab_chunks(z0: int, world_dims, factor: int, brick_layout: Layout, octaves: int,
                        seed: int = 0x71889283, device=default_device()):
    """One z-slab of the terrain world's chunks, as :func:`_slab_to_chunks`
    returns them: W1 (``kernels/terrain.py``) on a CUDA device, the plain
    version on the CPU.  ``seed`` reaches only the plain version, where the
    noise ignores it too (``ops/noise.py::repeater_perlin``)."""
    if torch.device(device).type == "cuda":
        from voxelengine_tpu_torch.kernels import terrain

        return terrain.terrain_slab(z0, world_dims, factor, brick_layout, octaves, device)
    return terrain_slab_chunks_plain(z0, world_dims, factor, brick_layout, octaves, seed, device)


def build_brickmap_terrain_compact(
    world_dims: Tuple[int, int, int],
    factor: int,
    seed: int = 0x71889283,
    octaves: int = 32,
    brick_layout: Layout = Layout.TILED_LINEAR,
    device=default_device(),
    chunks_fn=None,
) -> BrickMap:
    """Terrain world straight to compact indirection, one chunk-row z-slab
    at a time on ``device``: each slab's chunks from W1 on a CUDA device
    (:func:`terrain_slab_chunks`; no dense slab exists), from the plain
    worldgen and reduction on the CPU; then the slot assignment in torch.
    All-full chunks share slot 0, empty chunks get -1, and each non-uniform
    occupied chunk keeps its own brick, in chunk order.  Coarse layout
    LINEAR (build order).  ``chunks_fn(z0, world_dims, factor,
    brick_layout, octaves, seed, device)`` replaces the slab source (the
    smoke run passes :func:`terrain_slab_chunks_plain` to build the same
    world through the plain path on the card).  Matches
    :func:`voxelengine_tpu.core.brickmap.build_brickmap_terrain_compact`
    bit for bit."""
    f = factor
    brick_layout = choose_layout((f, f, f), brick_layout)
    chunks_fn = chunks_fn or terrain_slab_chunks
    return build_brickmap_from_chunks(
        lambda z0: chunks_fn(z0, world_dims, f, brick_layout, octaves, seed, device), world_dims, f,
        coarse_layout=Layout.LINEAR, brick_layout=brick_layout, dense_slots=False, dedupe_uniform=True,
        device=device,
    )


def build_brickmap_terrain(
    world_dims: Tuple[int, int, int],
    factor: int,
    seed: int = 0x71889283,
    octaves: int = 32,
    brick_layout: Layout = Layout.TILED_LINEAR,
    device=default_device(),
) -> BrickMap:
    """Terrain world with dense slots (every chunk owns the brick of its
    chunk index, the form edits need) and LINEAR coarse layout, one
    chunk-row z-slab at a time on ``device``: each slab's chunks from W1 on
    a CUDA device (:func:`terrain_slab_chunks`), from the plain worldgen and
    reduction on the CPU.  Matches
    :func:`voxelengine_tpu.core.brickmap.build_brickmap_terrain` bit for
    bit."""
    f = factor
    brick_layout = choose_layout((f, f, f), brick_layout)
    return build_brickmap_from_chunks(
        lambda z0: terrain_slab_chunks(z0, world_dims, f, brick_layout, octaves, seed, device), world_dims, f,
        coarse_layout=Layout.LINEAR, brick_layout=brick_layout, dense_slots=True, device=device,
    )


def compact_brickmap(bm: BrickMap, dedupe_uniform: bool = True) -> BrickMap:
    """A dense-slot brickmap in compact form, on its device: slot 0 is the
    shared all-full brick (with ``dedupe_uniform``), each other occupied
    chunk keeps its brick in chunk order, and empty chunks get -1.  One host
    read (the kept count)."""
    if not bm.dense_slots:
        raise ValueError("compact_brickmap expects a dense_slots brickmap")
    dev = bm.meta.device
    occ = ((bm.meta >> META_OCC_BIT) & 1) == 1
    full = torch.as_tensor(_full_brick_words(bm.factor), device=dev)
    keep = occ & ~(bm.bricks == full[None, :]).all(dim=1) if dedupe_uniform else occ
    kept_idx = torch.nonzero(keep).squeeze(1)
    base = 1 if dedupe_uniform else 0
    slots = torch.full((bm.num_chunks,), -1, dtype=torch.int32, device=dev)
    slots[kept_idx] = base + torch.arange(kept_idx.numel(), dtype=torch.int32, device=dev)
    if dedupe_uniform:
        slots[occ & ~keep] = 0
    kept = bm.bricks[kept_idx]
    if dedupe_uniform:
        bricks = torch.cat([full[None, :], kept])
    else:
        bricks = kept if kept.shape[0] else torch.zeros((1, bm.words_per_brick), dtype=torch.int32, device=dev)
    return dataclasses.replace(bm, brick_idx=slots, bricks=bricks, dense_slots=False)


# ---------------------------------------------------------------------------
# edits (voxel place/break)
# ---------------------------------------------------------------------------


def _edit_xyz(bm: BrickMap, x, y, z):
    """Edit coordinates as flat int64 tensors on the world's device."""
    return tuple(torch.as_tensor(a, device=bm.meta.device).reshape(-1).long() for a in (x, y, z))


def _edit_coords(bm: BrickMap, x, y, z):
    """Shared edit addressing: chunk ids, brick word column and bit."""
    f = bm.factor
    ci = bm.chunk_index(x // f, y // f, z // f)
    bit = sample_index(x % f, y % f, z % f, f, f, bm.brick_layout)
    return ci, bit >> 5, bit & 31


def _chunk_meta(bm: BrickMap, ci: torch.Tensor) -> torch.Tensor:
    """The meta words of chunks ``ci`` recomputed from their bricks: the
    occupancy and the tight bounds, all 0 for an empty chunk."""
    f = bm.factor
    dev = bm.meta.device
    bits = unpack_bits(bm.bricks[ci])  # [U, 32 * wpb]
    r = torch.arange(f, device=dev)
    bidx = sample_index(r[None, None, :], r[None, :, None], r[:, None, None], f, f, bm.brick_layout)
    vol = bits[:, bidx.reshape(-1)].reshape(-1, f, f, f)  # [U, z, y, x]
    occ, lo, hi = _occ_bounds(vol)
    o = occ[:, None].to(torch.int32)
    return pack_meta(occ, lo * o, hi * o)


def apply_edits(bm: BrickMap, x, y, z, value) -> BrickMap:
    """Set world voxels ``(x, y, z)`` (in range) to ``value`` and refresh
    the meta word (occupancy and tight bounds) of each touched chunk, in
    place on ``bm``'s tensors; returns ``bm``.  As the JAX function's
    sequential read-modify-write leaves it: for each voxel the last edit
    wins, and edits to one brick word compose (``BitRef``'s atomics,
    ``VolumeRaytracer.cu:19-36``).  Needs ``dense_slots`` (a chunk's brick
    is its own) and a contiguous brick table."""
    if not bm.dense_slots:
        raise ValueError("edits require dense_slots brickmaps")
    x, y, z = _edit_xyz(bm, x, y, z)
    ci, col, bit = _edit_coords(bm, x, y, z)
    write_bits(bm.bricks.view(-1), ci * bm.words_per_brick + col, bit, value)
    uci = torch.unique(ci)
    bm.meta[uci] = _chunk_meta(bm, uci)
    return bm
