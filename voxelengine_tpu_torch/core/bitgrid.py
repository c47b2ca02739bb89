"""Bit-packed voxel occupancy words.

Counterpart of the word helpers of :mod:`voxelengine_tpu.core.bitgrid`:
one bit per voxel, 32 to a word, LSB first (``VolumeRaytracer.cu:61-73``).
Words are ``int32`` tensors holding the uint32 bit pattern: torch has few
uint32 operations, and ``(word >> bit) & 1`` reads the same bit under the
arithmetic shift of int32.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelengine_tpu_torch.core.layout import Layout


def words_for_bits(num_bits: int) -> int:
    """Number of 32-bit words backing ``num_bits`` (``VolumeRaytracer.cu:44``)."""
    return (num_bits + 31) // 32


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


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """Pack bool bits (last axis a multiple of 32) into int32 words, bit
    ``i`` -> word ``i // 32`` bit ``i % 32``.  Leading axes are batch."""
    b = bits.reshape(*bits.shape[:-1], -1, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    # disjoint bits: the int64 sum is the bitwise or, then wrap to int32
    s = (b << shifts).sum(dim=-1)
    return torch.where(s >= 2**31, s - 2**32, s).to(torch.int32)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: int32 words ``[..., n]`` -> flat bool
    bits ``[..., 32 n]``."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return (((words[..., None] >> shifts) & 1) == 1).reshape(*words.shape[:-1], -1)
