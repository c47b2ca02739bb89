"""Wrappers of W1, the Hopper terrain slab kernel, and of its noise probe
(``csrc/terrain.cu`` over ``csrc/terrain.cuh`` and ``csrc/noise.cuh``).

:func:`terrain_slab` (W1) computes one z-slab of chunks of the terrain
world: what ``core/brickmap.py::_slab_to_chunks`` returns for the slab
``worldgen/terrain.py::solid_at`` makes, without the dense slab.  It has
no TPU counterpart: the JAX package's build (``voxelengine_tpu/core/brickmap.py:
284``) is XLA, not a ``pallas_call``.  Its plain version is
:func:`voxelengine_tpu_torch.core.brickmap.terrain_slab_chunks_plain`,
which ``core/brickmap.py`` runs for a build on the CPU.
:func:`noise_points` evaluates one of ``noise.cuh``'s functions on a flat
batch of points, against which the plain ``ops/noise.py`` and the golden
values are held.  ``launches`` and ``noise_launches`` count their launches.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.core.bitgrid import words_for_bits
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import build

launches = 0
noise_launches = 0
# noise_points' kinds: name -> (kernel kind, input dtype, input row width)
NOISE_KINDS = {
    "hash": (0, torch.int32, None), "random_float": (1, torch.int32, None),
    "perlin": (2, torch.float32, 3), "repeater_perlin": (3, torch.float32, 3),
    "terrain_t": (4, torch.int32, 3), "solid": (5, torch.int32, 3),
}


def slab_shape(world_dims, factor: int, brick_layout: Layout):
    """Check a terrain world's dims, factor and brick layout; returns
    ``(chunks_x, chunks_y, words per brick)`` of one slab."""
    X, Y, Z = world_dims
    f = factor
    if not 1 <= f <= 32 or X % f or Y % f or Z % f:
        raise ValueError(f"terrain_slab: world dims {world_dims} must be multiples of factor {f} in 1..32")
    if brick_layout is not Layout.LINEAR and f % 8:
        raise ValueError(f"terrain_slab: brick layout {brick_layout.name} needs a factor divisible by 8, got {f}")
    if max(X, Y, Z) >= 2**24:
        raise ValueError(f"terrain_slab: world dims {world_dims} exceed the float32-exact coordinates")
    gx, gy, wpb = X // f, Y // f, words_for_bits(f**3)
    if gx * gy * wpb >= 2**31:
        raise ValueError(f"terrain_slab: a slab of {gx}x{gy} chunks overflows the kernel's int32 word index")
    return gx, gy, wpb


def terrain_slab(z0: int, world_dims, factor: int, brick_layout: Layout, octaves: int, device):
    """W1: the chunks of world rows ``z0 .. z0 + factor`` on the CUDA
    ``device``, one launch.  Returns ``(occ bool[n], bmin i32[n, 3], bmax
    i32[n, 3], words i32[n, wpb])``, ``n = (Y/f) * (X/f)`` chunks in (cy,
    cx) row-major order, as ``_slab_to_chunks``.  Launches on the current
    stream without synchronising and raises if the launch is refused."""
    global launches
    dev = torch.device(device)
    build.require_cuda("terrain_slab", dev)
    gx, gy, wpb = slab_shape(world_dims, factor, brick_layout)
    if not 0 <= z0 <= world_dims[2] - factor or z0 % factor or octaves < 0:
        raise ValueError(f"terrain_slab: z0 {z0} must be a slab of the world, octaves {octaves} >= 0")
    n = gx * gy
    occ = torch.empty((n,), dtype=torch.uint8, device=dev)
    bmin = torch.empty((n, 3), dtype=torch.int32, device=dev)
    bmax = torch.empty((n, 3), dtype=torch.int32, device=dev)
    words = torch.empty((n, wpb), dtype=torch.int32, device=dev)
    build.launch(
        "terrain_slab", build.load_kernel("terrain").vx_terrain_slab,
        z0, factor, gx, gy, wpb, brick_layout.value, octaves,
        occ.data_ptr(), bmin.data_ptr(), bmax.data_ptr(), words.data_ptr(), dev=dev,
    )
    launches += 1
    return occ.view(torch.bool), bmin, bmax, words


def noise_points(kind: str, points: torch.Tensor, *, scale: float = 1.0, seed: int = 0, octaves: int = 0,
                 lacunarity: float = 2.0, decay: float = 0.5) -> torch.Tensor:
    """One of ``noise.cuh``'s functions on the CUDA tensor ``points``, one
    launch: ``hash`` and ``random_float`` of int32 seeds ``[n]`` (uint32 bit
    patterns), ``perlin`` (``scale``, ``seed``) and ``repeater_perlin``
    (``scale``, ``octaves``, ``lacunarity``, ``decay``) of float32 points
    ``[n, 3]``, ``terrain_t`` and ``solid`` (``octaves``) of int32 voxel
    coords ``[n, 3]``.  Returns int64 uint32 values (``hash``), bool
    (``solid``) or float32 ``[n]``."""
    global noise_launches
    k, dtype, width = NOISE_KINDS[kind]
    dev = points.device
    build.require_cuda("noise_points", dev)
    n = points.shape[0]
    build.check("noise_points", "points", points, dtype, (n,) if width is None else (n, width), dev)
    fout = torch.empty((n,), dtype=torch.float32, device=dev)
    uout = torch.empty((n,), dtype=torch.int32, device=dev)
    build.launch(
        "noise_points", build.load_kernel("terrain").vx_noise_points,
        k, n, points.data_ptr(), scale, seed, octaves, lacunarity, decay, fout.data_ptr(), uout.data_ptr(), dev=dev,
    )
    noise_launches += 1
    if kind == "hash":
        return uout.to(torch.int64) & 0xFFFFFFFF
    return uout != 0 if kind == "solid" else fout
