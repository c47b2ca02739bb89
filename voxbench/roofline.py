"""Roofline arithmetic: the least time the card could take for a kernel's
work, from the bytes it must move and the DDA steps it must take.

Frozen copies, so that a change to the program cannot move the yardstick:

* ``HBM_BYTES_PER_S``, ``GRID_OUT_BYTES``, ``OPS_PER_STEP``: ``chip_smoke.py:
  269-285`` (commit eb10204);
* :func:`issue_rates`: ``chip_smoke.py:323-337``;
* :func:`bound`: ``chip_smoke.py:354-364``;
* :func:`hit_table_bytes`: ``chip_smoke.py:366-394`` over the TILED_LINEAR
  bit order of ``voxelengine_tpu_torch/core/layout.py:55-72``;
* :func:`data_bytes`, :func:`grid_ray_bytes`: ``chip_smoke.py:413-423``;
* :func:`slot_bytes`: ``chip_smoke.py:365-373, 3535-3540`` (commit
  c5555df), K4-compact's phase: a compact world's walk without a line
  table also reads each hit chunk's ``brick_idx`` word;
* :func:`secondary_bytes`: ``chip_smoke.py:1236-1249``;
* ``SHADE_OPS``, :func:`framebuffer_sector_bytes`, :func:`shade_bytes`:
  ``chip_smoke.py:3805-3852``, with the shaded frame's secondary inputs
  added (:func:`shade_bytes`'s ``secondary``).

Peaks: the H100 SXM data sheet's 3.35 TB/s of HBM3, and the instruction
issue rate read on the card (the kernels are built with ``--fmad=false``,
so no op is a fused pair).  A card below its 700 W limit runs slower; the
run prints the limit beside these.
"""

from __future__ import annotations

import functools
import math
import subprocess

import torch

HBM_BYTES_PER_S = 3.35e12
GRID_OUT_BYTES = 29  # hit (1 B), position, normal (12 B each), steps (4 B) a ray
OPS_PER_STEP = 8
SHADE_OPS, SHADE_MISS_OPS = 80, 6
TILE = 8  # the brick's TILED_LINEAR tile side


@functools.cache
def issue_rates() -> dict:
    """The card's lane-op rates: ``issue`` (SMs x 4 schedulers x 32 lanes x
    the SM clock, ``nvidia-smi``'s ``clocks.max.sm``), with the SM count and
    the clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True, timeout=60)
    hz = float(out.stdout.strip().splitlines()[0]) * 1e6
    return {"sms": sms, "clock_hz": hz, "issue": sms * 4 * 32 * hz}


def bound(rays: int, table_bytes: int, work: int, ray_bytes: float) -> float:
    """The bound in ms: the larger of the bytes the trace must move
    (``ray_bytes`` a ray and the ``table_bytes`` its hits need) over the
    memory rate and the float ops of its ``work`` DDA steps over the issue
    rate."""
    bytes_ms = (rays * ray_bytes + table_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = work * OPS_PER_STEP / issue_rates()["issue"] * 1e3
    return max(bytes_ms, ops_ms)


def _tiled_bit(x, y, z, f: int):
    """TILED_LINEAR bit index of brick-local voxel ``(x, y, z)``."""
    tx, ty, tz = x // TILE, y // TILE, z // TILE
    tiles = f // TILE
    return (tx + ty * tiles + tz * tiles * tiles) * TILE ** 3 + (x % TILE) + (y % TILE) * TILE + (z % TILE) * TILE * TILE


def hit_table_bytes(hit, position, normal, world_dims, factor: int, wpb: int) -> int:
    """Table bytes a correct trace must read for these hits: the 4-byte
    word of each distinct hit voxel and each distinct hit chunk's 4-byte
    coarse entry (a lower bound on what the rays touch)."""
    v = torch.floor(position[hit] + 0.5 * normal[hit]).long()
    v = torch.minimum(v.clamp_min(0), torch.tensor(world_dims, device=v.device) - 1)
    X, Y, _ = world_dims
    c, fine = v // factor, v % factor
    gx, gy = X // factor, Y // factor
    chunk = c[:, 0] + c[:, 1] * gx + c[:, 2] * gx * gy
    word = _tiled_bit(fine[:, 0], fine[:, 1], fine[:, 2], factor) >> 5
    return 4 * (int(torch.unique(chunk * wpb + word).numel()) + int(torch.unique(chunk).numel()))


def slot_bytes(hit, position, normal, world_dims, factor: int) -> int:
    """The 4-byte ``brick_idx`` word of each distinct hit chunk, which K4's
    compact instantiation reads besides :func:`hit_table_bytes`'s."""
    v = torch.floor(position[hit] + 0.5 * normal[hit]).long()
    v = torch.minimum(v.clamp_min(0), torch.tensor(world_dims, device=v.device) - 1)
    c = v // factor
    gx, gy = world_dims[0] // factor, world_dims[1] // factor
    return 4 * int(torch.unique(c[:, 0] + c[:, 1] * gx + c[:, 2] * gx * gy).numel())


def data_bytes(t) -> int:
    """The distinct float32 data of ``t``: a broadcast row counts once."""
    return 4 * math.prod(size for size, stride in zip(t.shape, t.stride()) if stride != 0)


def grid_ray_bytes(origins, rays) -> float:
    """Bytes a ray of a rays entry must move: its distinct origin and
    direction data, and :data:`GRID_OUT_BYTES` out."""
    return GRID_OUT_BYTES + (data_bytes(origins) + data_bytes(rays)) / rays.shape[0]


def secondary_bytes(kind: str, dirs) -> float:
    """Bytes a secondary entry must move a primary ray besides its walks'
    tables: position (12 B), the normal (12 B) where read, the reflection's
    direction, AO's pixel (16 B); out the shadow's hit and steps (5 B), the
    reflection's hit, position and normal (25 B), the AO factor (4 B)."""
    if kind == "shadow":
        return 12 + 5
    if kind == "reflection":
        return 24 + data_bytes(dirs) / dirs.shape[0] + 25
    return 24 + 16 + 4


def framebuffer_sector_bytes(width: int, height: int, px, py, write) -> int:
    """Bytes the memory moves to write a frame's pixels into the
    framebuffer (``f32[H, W, 3]``): each 32-byte sector touched is written,
    and one filled only in part is read first."""
    keep = write & (py < height)
    off = 12 * (py[keep] * width + px[keep])
    first = off // 32
    in_first = torch.clamp(32 - off % 32, max=12)
    sectors = torch.cat([first, first[in_first < 12] + 1])
    filled = torch.cat([in_first, 12 - in_first[in_first < 12]])
    per = torch.zeros(int(sectors.max()) + 1 if sectors.numel() else 1, dtype=torch.int64, device=px.device)
    per.index_add_(0, sectors, filled)
    touched, full = int((per > 0).sum()), int((per == 32).sum())
    return 32 * (2 * (touched - full) + full)


def shade_bytes(width: int, height: int, hit, dirs, px, py, crosshair: bool, secondary: bool) -> int:
    """Bytes the shading kernel's SHADED composite must move: each ray's
    hit (1 B) and pixel (16 B), the hits' position and normal (24 B), the
    misses' directions (one row where broadcast), the camera and the
    environment (48 B), the crosshair column's pre-remap row (8 B a ray),
    the framebuffer's sectors; with ``secondary`` each ray's shadow hit and
    steps (5 B), reflection hit, position and normal (25 B) and AO factor
    (4 B).  Every ray writes its pixel in the SHADED view."""
    n, hits = hit.shape[0], int(hit.sum())
    b = n * (1 + 8 + 8) + 24 * hits + (12 if dirs.stride(0) == 0 else 12 * (n - hits)) + 48
    if crosshair:
        b += 8 * int((px == width // 2).sum())
    if secondary:
        b += n * (5 + 25 + 4)
    return b + framebuffer_sector_bytes(width, height, px, py, torch.ones_like(hit))


def shade_ops_ms(hit) -> float:
    """The shading kernel's float ops over the issue rate, in ms."""
    hits = int(hit.sum())
    return (SHADE_OPS * hits + SHADE_MISS_OPS * (hit.shape[0] - hits)) / issue_rates()["issue"] * 1e3
