"""Bit-packed voxel occupancy: counterpart of ``voxelengine_tpu/core/bitgrid.py``.

One bit per voxel, 32 to a word, LSB first (``VolumeRaytracer.cu:61-73``),
the bit index given by a :class:`~voxelengine_tpu_torch.core.layout.Layout`
swizzle.  Words are ``int32`` tensors holding the uint32 bit pattern: torch
has few uint32 operations, and ``(word >> bit) & 1`` reads the same bit
under the arithmetic shift of int32.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from voxelengine_tpu_torch.config import default_device
from voxelengine_tpu_torch.core.layout import Layout, sample_index


def words_for_bits(num_bits: int) -> int:
    """Number of 32-bit words backing ``num_bits`` (``VolumeRaytracer.cu:44``)."""
    return (num_bits + 31) // 32


@dataclasses.dataclass(frozen=True)
class BitGrid:
    """A 3D occupancy grid (``VoxelBuffer3D``, ``VolumeRaytracer.cuh:227-233``).

    ``words`` is ``int32[ceil(X*Y*Z/32)]``; bit ``i`` of the grid, in
    ``layout`` order, is ``(words[i // 32] >> (i % 32)) & 1``.  ``dims`` is
    ``(X, Y, Z)``.
    """

    words: torch.Tensor
    dims: Tuple[int, int, int]
    layout: Layout

    @property
    def num_bits(self) -> int:
        x, y, z = self.dims
        return x * y * z

    @staticmethod
    def zeros(dims, layout: Layout = Layout.TILED_LINEAR, device=default_device()) -> "BitGrid":
        n = dims[0] * dims[1] * dims[2]
        return BitGrid(torch.zeros((words_for_bits(n),), dtype=torch.int32, device=device), tuple(dims), layout)

    @staticmethod
    def from_dense(dense, layout: Layout = Layout.TILED_LINEAR) -> "BitGrid":
        """Pack a dense bool ``[z, y, x]`` tensor (or array) into a grid on
        its device (``VolumeRaytracer.cuh:434-436`` loop nesting)."""
        dense = torch.as_tensor(dense)
        zdim, ydim, xdim = dense.shape
        bits = layout_order_bits(dense, layout)
        pad = words_for_bits(bits.shape[0]) * 32 - bits.shape[0]
        if pad:
            bits = torch.cat([bits, torch.zeros((pad,), dtype=torch.bool, device=bits.device)])
        return BitGrid(pack_bits(bits), (xdim, ydim, zdim), layout)

    def to_dense(self) -> torch.Tensor:
        """Unpack to a dense bool ``[z, y, x]`` tensor."""
        bits = unpack_bits(self.words)[: self.num_bits]
        return layout_order_bits_inverse(bits, self.dims, self.layout)

    def get_bits(self, x, y, z) -> torch.Tensor:
        """Occupancy at integer voxel coords; out-of-range reads are False
        (``BitArray::operator[]``, ``VolumeRaytracer.cu:61-68``)."""
        xdim, ydim, zdim = self.dims
        in_range = (x >= 0) & (x < xdim) & (y >= 0) & (y < ydim) & (z >= 0) & (z < zdim)
        idx = sample_index(
            torch.clamp(x, 0, xdim - 1), torch.clamp(y, 0, ydim - 1), torch.clamp(z, 0, zdim - 1),
            xdim, ydim, self.layout,
        )
        word = self.words[idx >> 5]
        return (((word >> (idx & 31)) & 1) == 1) & in_range

    def set_bits(self, x, y, z, value) -> "BitGrid":
        """A new grid with the voxels at in-range ``(x, y, z)`` set to
        ``value`` (a bool broadcast to the coordinates' shape):
        ``BitRef::operator=`` (``VolumeRaytracer.cu:19-36``).  Where one
        voxel is written more than once, the last write in the given order
        wins (XLA's scatter leaves that undefined); writes to other bits of
        one word compose."""
        xdim, ydim, _ = self.dims
        dev = self.words.device
        x, y, z = (torch.as_tensor(a, device=dev).reshape(-1).long() for a in (x, y, z))
        idx = sample_index(x, y, z, xdim, ydim, self.layout)
        words = self.words.clone()
        write_bits(words, idx >> 5, idx & 31, value)
        return dataclasses.replace(self, words=words)

    def count(self) -> torch.Tensor:
        """Number of solid voxels (population count over the words)."""
        return popcount32(self.words).sum()


def _morton_perm() -> np.ndarray:
    """Morton index within an 8^3 tile -> linear (z, y, x) offset."""
    m = np.arange(512)

    def compact(x):
        x = x & 0x00249249
        x = (x ^ (x >> 2)) & 0x000C30C3
        x = (x ^ (x >> 4)) & 0x00000F00F
        x = (x ^ (x >> 8)) & 0x0000000FF
        return x

    lx, ly, lz = compact(m), compact(m >> 1), compact(m >> 2)
    return (lz * 64 + ly * 8 + lx).astype(np.int64)


def layout_order_bits(dense: torch.Tensor, layout: Layout) -> torch.Tensor:
    """Flatten a dense ``[..., Z, Y, X]`` bool tensor into layout bit order
    along its last three axes (leading axes are batch).  Tiled modes need
    dims divisible by 8, like the reference."""
    *lead, zdim, ydim, xdim = dense.shape
    if layout is Layout.LINEAR:
        return dense.reshape(*lead, -1)
    tz, ty, tx = zdim // 8, ydim // 8, xdim // 8
    nl = len(lead)
    t = dense.reshape(*lead, tz, 8, ty, 8, tx, 8)
    t = t.permute(*range(nl), nl, nl + 2, nl + 4, nl + 1, nl + 3, nl + 5)
    if layout is Layout.TILED_LINEAR:
        return t.reshape(*lead, -1)
    flat = t.reshape(*lead, tz * ty * tx, 512)
    perm = torch.as_tensor(_morton_perm(), device=dense.device)
    return flat[..., perm].reshape(*lead, -1)


def layout_order_bits_inverse(bits: torch.Tensor, dims, layout: Layout) -> torch.Tensor:
    """Inverse of :func:`layout_order_bits`: flat layout-order bits ->
    dense ``[Z, Y, X]`` (``dims`` is ``(X, Y, Z)``)."""
    xdim, ydim, zdim = dims
    if layout is Layout.LINEAR:
        return bits.reshape(zdim, ydim, xdim)
    tz, ty, tx = zdim // 8, ydim // 8, xdim // 8
    if layout is Layout.TILED_MORTON:
        inv = np.empty(512, np.int64)
        inv[_morton_perm()] = np.arange(512)
        bits = bits.reshape(tz * ty * tx, 512)[:, torch.as_tensor(inv, device=bits.device)]
    t = bits.reshape(tz, ty, tx, 8, 8, 8)
    return t.permute(0, 3, 1, 4, 2, 5).reshape(zdim, ydim, xdim)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack bool bits (last axis a multiple of 32) into int32 words, bit
    ``i`` -> word ``i // 32`` bit ``i % 32``.  Leading axes are batch."""
    b = bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    # disjoint bits: the int64 sum is the bitwise or, then wrap to int32
    s = (b << shifts).sum(dim=-1)
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def np_pack_bits(bits: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`pack_bits` for host-side and oracle use: flat
    ``uint32`` words (the JAX package's ``np_pack_bits``)."""
    b = bits.reshape(-1, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return np.bitwise_or.reduce(b << shifts, axis=-1).astype(np.uint32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32 words ``[..., n]`` -> flat bool
    bits ``[..., 32 n]``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return (((words[..., None] >> shifts) & 1) == 1).reshape(*words.shape[:-1], -1)


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Per-word population count of uint32 bit patterns (SWAR in int64, so
    the int32 sign bit counts as bit 31); returns int64 counts."""
    v = words.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return ((v * 0x01010101) & 0xFFFFFFFF) >> 24


def unique_last(keys: torch.Tensor):
    """``(distinct keys, sorted; index of each one's last occurrence)``."""
    u, inv = torch.unique(keys, return_inverse=True)
    last = torch.full(u.shape, -1, dtype=torch.int64, device=keys.device)
    last.scatter_reduce_(0, inv, torch.arange(keys.numel(), device=keys.device), "amax")
    return u, last


def write_bits(words: torch.Tensor, word: torch.Tensor, bit: torch.Tensor, value) -> None:
    """Set bit ``bit`` of ``words[word]`` to ``value`` for each write, in
    place on the flat int32 tensor ``words``, as a sequential read-modify-
    write would leave it: the last write of each (word, bit) wins and
    writes to other bits of one word compose.  Vectorized: the last write
    of each bit is kept, then each touched word takes the OR of its set
    mask and the AND of its clear mask, written once."""
    word, bit = word.reshape(-1).long(), bit.reshape(-1).long()
    value = torch.as_tensor(value, dtype=torch.bool, device=words.device).expand(word.shape).reshape(-1)
    keys, last = unique_last(word * 32 + bit)
    val = value[last]
    mask = torch.ones_like(keys) << (keys & 31)
    touched, winv = torch.unique(keys >> 5, return_inverse=True)
    # distinct bits of one word: the int64 sums are exact ORs
    set_m = torch.zeros_like(touched).index_add_(0, winv, torch.where(val, mask, 0))
    clr_m = torch.zeros_like(touched).index_add_(0, winv, torch.where(val, 0, mask))
    cur = words[touched].long() & 0xFFFFFFFF
    new = (cur | set_m) & ~clr_m & 0xFFFFFFFF
    words[touched] = torch.where(new >= 2**31, new - 2**32, new).to(words.dtype)
