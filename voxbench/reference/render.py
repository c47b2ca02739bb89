"""The upstream renderer's pixels and the ray API's record, in plain torch.

For chosen pixels of chosen frames: the pinhole ray (``Renderer.cu:27-59``,
the upstream's 3.1415 for pi), its walk (:mod:`voxbench.reference.walk`),
the shadow, mirror and AO rays the port's shaded frame adds, Lambert plus
hemispheric ambient plus specular shading and the Reinhard tonemap
(``Renderer.cu:89-177``), the sky as the raw direction, and the store's
clamp; the BGRA8 bytes of a presented frame (``Renderer.cuh:29-31``); and
``RayTraceResults`` of a batch query (``VolumeRaytracer.cu:574-618``, with
the voxel index of the hit voxel).  Float math is in ``dtype``; the AO
sample directions come from the upstream's hash in float32.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from voxbench.reference.terrain import random_float
from voxbench.reference.walk import walk

LIGHT = (1.0, 1.0, 1.0)  # main.cu:58-63: light direction (normalised), colour 2, ambient 0.5
LIGHT_COLOR = 2.0
AMBIENT = 0.5
REFLECTIVITY = 0.35
AO_STEPS = 8
SECONDARY_OFFSET = 0.01


def _dot(a, b):
    return (a * b).sum(dim=-1)


def _normalize(v):
    return v / torch.sqrt(_dot(v, v))[..., None]


def _reflect(i, n):
    return i - 2.0 * n * _dot(n, i)[..., None]


def basis(euler: torch.Tensor, dtype):
    """``(forward, up, right)`` of float32 Euler angles ``[R, 3]`` (pitch,
    yaw), forward and up negated as upstream."""
    e = euler.to(torch.float64)
    p, y = e[:, 0], e[:, 1]
    fwd = torch.stack([torch.cos(p) * torch.sin(y), -torch.sin(p), torch.cos(p) * torch.cos(y)], dim=-1)
    right = torch.stack([torch.cos(y), torch.zeros_like(y), -torch.sin(y)], dim=-1)
    up = torch.linalg.cross(fwd, right)
    return (-fwd).to(dtype), (-up).to(dtype), right.to(dtype)


def pixel_dirs(euler, px, py, width: int, height: int, fov: float, dtype):
    """Normalised directions of pixels ``(px, py)`` (final rows, after the
    checkerboard's remap) of cameras ``euler [R, 3]``."""
    fwd, up, right = basis(euler, dtype)
    half = float(np.float32(fov) * np.float32(3.1415) / np.float32(180.0)) / 2.0
    sy = math.tan(half)
    sx = sy * width / height
    u = px.to(dtype) / width * 2.0 - 1.0
    v = py.to(dtype) / height * 2.0 - 1.0
    return _normalize(fwd + (u * sx)[:, None] * right + (v * sy)[:, None] * up)


def _light(dtype, dev):
    return _normalize(torch.tensor(LIGHT, dtype=torch.float64, device=dev)).to(dtype)


def _color(cam, n, pos, L, shadow_hit):
    """``calculateColor``: ``n`` the shading normal, ``shadow_hit`` bool."""
    lit = (~shadow_hit).to(n.dtype)
    l_dot = torch.clamp_min(_dot(n, L), 0.0) * lit
    hemi = n[:, 1] * 0.5 + 0.5
    base = (l_dot * LIGHT_COLOR + AMBIENT * (0.25 + 0.75 * hemi))[:, None]
    view = pos - cam
    view = view / torch.clamp_min(torch.sqrt(_dot(view, view)), 1e-12)[:, None]
    s = torch.clamp_min(_dot(view, _reflect(L.expand_as(n), n)), 0.0) ** 32
    return base + (torch.where(shadow_hit, 0.0, s) * LIGHT_COLOR)[:, None]


def _ao_dirs(px, py, s: int, width: int, frame_number: torch.Tensor, n, dtype):
    """AO sample ``s``'s direction of pixels ``(px, py)``: the hash of the
    pixel, sample and frame, normalised, flipped into ``n``'s hemisphere."""
    si = py.to(torch.int64) * width + px.to(torch.int64) + s * 1000 + (frame_number.to(torch.int64) + 1) * 7919
    sd = torch.stack([random_float(si) * 2.0 - 1.0, random_float(si * 10) * 2.0 - 1.0,
                      random_float(si * 100) * 2.0 - 1.0], dim=-1).to(dtype)
    sd = _normalize(sd)
    return torch.where((_dot(sd, n) < 0.0)[:, None], _reflect(sd, n), sd)


def shade_pixels(cam, euler, frame_number, px, py, world, frame, shading, dtype=torch.float64):
    """Colours ``[R, 3]`` (float, clamped to [0, 1]) that a frame stores at
    pixels ``(px, py)``.  ``cam``, ``euler`` ``[R, 3]`` float32 and
    ``frame_number`` ``[R]`` are each pixel's frame's camera and number;
    ``world``: ``dims``, ``octaves``; ``frame``: ``width``, ``height``,
    ``fov``; ``shading``: ``shadows``, ``ao_samples``, ``reflections``."""
    W, H = frame["width"], frame["height"]
    o = cam.to(dtype)
    d = pixel_dirs(euler, px, py, W, H, frame["fov"], dtype)
    prim = walk(o, d, tuple(world["dims"]), world["octaves"], dtype=dtype)
    color = d.clone()  # a miss shows the sky, its raw direction
    h = torch.nonzero(prim.hit).squeeze(1)
    if h.numel():
        color[h] = _shade_hits(o[h], d[h], prim.position[h], -prim.normal[h], px[h], py[h], frame_number[h], world,
                               W, shading, dtype)
    return torch.clamp(color, 0.0, 1.0)


def _shade_hits(o, d, pos, n, px, py, frame_number, world, width: int, shading, dtype):
    """Tonemapped colours of primary hits at ``pos`` with shading normals
    ``n``, after their shadow, mirror and AO rays."""
    dims, octaves = tuple(world["dims"]), world["octaves"]
    L = _light(dtype, o.device)
    shadow_hit = torch.zeros(pos.shape[0], dtype=torch.bool, device=o.device)
    if shading.get("shadows"):
        shadow_hit = walk(pos + L * SECONDARY_OFFSET, L.expand_as(pos), dims, octaves, dtype=dtype).hit
    color = _color(o, n, pos, L, shadow_hit)
    if shading.get("reflections"):
        rdir = _reflect(d, n)
        ro = pos + n * SECONDARY_OFFSET
        rf = walk(ro, rdir, dims, octaves, dtype=dtype)
        rcol = torch.where(rf.hit[:, None], _color(ro, -rf.normal, rf.position, L, torch.zeros_like(rf.hit)), rdir)
        color = color + (rcol - color) * REFLECTIVITY
    samples = shading.get("ao_samples", 0)
    if samples:
        ao_o = pos + n * SECONDARY_OFFSET
        occ = torch.zeros_like(pos[:, 0])
        for s in range(samples):
            a = walk(ao_o, _ao_dirs(px, py, s, width, frame_number, n, dtype), dims, octaves, max_steps=AO_STEPS,
                     dtype=dtype)
            dist = torch.sqrt(_dot(a.position - pos, a.position - pos))
            falloff = 1.0 - torch.clamp_max(1.0 / torch.clamp_min(dist * 10.0, 1e-6), 1.0)
            occ = occ + torch.where(a.hit, falloff, 1.0)
        ao = occ / samples
        color = torch.where((torch.clamp_min(_dot(n, L), 0.0) == 0.0)[:, None], color * ao[:, None], color)
    return color / (color + 1.0)


def bgra8(color: torch.Tensor) -> torch.Tensor:
    """BGRA8888 bytes ``[R, 4]`` of colours in [0, 1]: each channel
    ``(unsigned char)(c * 255)``, alpha 255."""
    u8 = (torch.clamp(color.to(torch.float32), 0.0, 1.0) * 255.0).to(torch.uint8)
    return torch.cat([u8[:, 2:3], u8[:, 1:2], u8[:, 0:1], torch.full_like(u8[:, :1], 255)], dim=1)


def query_record(origins, dirs, world, dtype=torch.float64) -> dict:
    """``RayTraceResults`` of rays ``origins``, ``dirs`` (no step budget):
    ``valid``, ``hit_point`` (inf on a miss), ``normal`` (the step-sign
    convention), ``distance`` (0 on a miss), ``voxel_index`` (x-fastest
    linear index of the hit voxel, 0 on a miss)."""
    X, Y, _ = world["dims"]
    w = walk(origins, dirs, tuple(world["dims"]), world["octaves"], dtype=dtype)
    diff = origins.to(dtype) - w.position
    lin = w.cell[:, 2] * (X * Y) + w.cell[:, 1] * X + w.cell[:, 0]
    return dict(
        valid=w.hit,
        hit_point=torch.where(w.hit[:, None], w.position, float("inf")),
        normal=w.normal,
        distance=torch.where(w.hit, torch.sqrt(_dot(diff, diff)), 0.0),
        voxel_index=torch.where(w.hit, lin, 0),
    )
