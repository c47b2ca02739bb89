"""Camera model: counterpart of ``voxelengine_tpu/render/camera.py``.

Euler pitch/yaw to a (forward, up, right) basis with the reference's signs
(forward and up negated, ``Renderer.cu:39-41``), the perspective pinhole
generator with the reference's 3.1415 pi (``Renderer.cu:44-59``) and the
orthographic variant (``Renderer.cu:61-70``).  ``sin``/``cos``/``tan`` are
torch's, which may differ from XLA's by an ulp.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelengine_tpu_torch.core.exact import dot3, sqrt_rn

REF_PI = 3.1415  # Renderer.cu:50 uses this literal, not M_PI


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` with each product and difference a separate op."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def get_directions(euler_angles: torch.Tensor):
    """Euler angles (pitch, yaw, roll) -> (forward, up, right)
    (``Renderer.cu:27-42``)."""
    e = euler_angles.to(torch.float32)
    pitch, yaw = e[..., 0], e[..., 1]
    fwd = torch.stack(
        [torch.cos(pitch) * torch.sin(yaw), -torch.sin(pitch), torch.cos(pitch) * torch.cos(yaw)],
        dim=-1,
    )
    right = torch.stack([torch.cos(yaw), torch.zeros_like(yaw), -torch.sin(yaw)], dim=-1)
    up = _cross(fwd, right)
    return -fwd, -up, right


def get_directions_np(euler_angles):
    """Host-numpy twin of :func:`get_directions` (the same formulas in
    float32), for input handling that needs the basis every event without
    a device round trip: it aims movement and the crosshair edits, never
    the render rays.  Bit-equal to JAX's ``get_directions_np``."""
    e = np.asarray(euler_angles, np.float32)
    pitch, yaw = e[..., 0], e[..., 1]
    fwd = np.stack(
        [np.cos(pitch) * np.sin(yaw), -np.sin(pitch), np.cos(pitch) * np.cos(yaw)], axis=-1
    ).astype(np.float32)
    right = np.stack([np.cos(yaw), np.zeros_like(yaw), -np.sin(yaw)], axis=-1).astype(np.float32)
    up = np.cross(fwd, right).astype(np.float32)
    return -fwd, -up, right


def ray_direction(fwd, up, right, width: int, height: int, u, v, fov_degrees):
    """Perspective primary-ray direction for uv in [0,1]^2
    (``Renderer.cu:44-59``); returns ``[..., 3]``."""
    aspect = float(np.float32(width) / np.float32(height))
    ux = u * 2.0 - 1.0
    vy = v * 2.0 - 1.0
    fov = float(np.float32(fov_degrees) * np.float32(REF_PI) / np.float32(180.0))
    half = torch.full((), fov / 2.0, dtype=torch.float32, device=fwd.device)
    scale_y = torch.tan(half)
    scale_x = scale_y * aspect
    d = fwd + ux[..., None] * scale_x * right + vy[..., None] * scale_y * up
    return d / sqrt_rn(dot3(d, d))[..., None]


def ray_origin_ortho(fwd, up, right, width: int, height: int, u, v, origin, ortho_size):
    """Orthographic ray origin; the direction is ``fwd`` (``Renderer.cu:61-70``).
    ``ortho_size`` is a pair of numbers or a ``[2]`` tensor (the
    interactive zoom's, which changes without a new configuration)."""
    ratio = float(np.float32(width) / np.float32(height))
    if isinstance(ortho_size, torch.Tensor):
        osz = ortho_size.to(device=fwd.device, dtype=torch.float32)
        sx, sy = osz[0], osz[1]
    else:
        sx, sy = float(np.float32(ortho_size[0])), float(np.float32(ortho_size[1]))
    return (
        origin.to(torch.float32)
        + right * ((u * 2.0 - 1.0) * sx * ratio)[..., None]
        + up * ((v * 2.0 - 1.0) * sy)[..., None]
    )
