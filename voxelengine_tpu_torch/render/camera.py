"""Camera model: counterpart of ``voxelengine_tpu/render/camera.py``.

Euler pitch/yaw to a (forward, up, right) basis with the reference's signs
(forward and up negated, ``Renderer.cu:39-41``), the perspective pinhole
generator with the reference's 3.1415 pi (``Renderer.cu:44-59``) and the
orthographic variant (``Renderer.cu:61-70``).  ``sin``, ``cos`` and
``tan`` are glibc's ``sinf``, ``cosf`` and ``tanf``, which the reference's
XLA:CPU computes: on the card :func:`get_directions` is one launch of the
camera kernel (``kernels/camera.py``), elsewhere :func:`basis_plain`
(``core/libm.py``); ``tan`` of the half field of view is taken once on the
host.  A frame's rays on the card take the basis inside the ray-setup
kernel (``kernels/rays.py``, the same ``csrc/camera.cuh``), not from here.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from voxelengine_tpu_torch.core import libm
from voxelengine_tpu_torch.core.exact import dot3, sqrt_rn
from voxelengine_tpu_torch.kernels import camera as camera_kernel

REF_PI = 3.1415  # Renderer.cu:50 uses this literal, not M_PI


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a x b`` with each product and difference a separate op."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2, a0 * b1 - a1 * b0], dim=-1)


def basis_plain(e: torch.Tensor):
    """The camera kernel's plain version: :func:`get_directions` of the
    float32 ``e`` in torch ops, with ``core/libm.py``'s ``sincosf``."""
    s, c = libm.sincosf(e[..., :2])
    sp, sy, cp, cy = s[..., 0], s[..., 1], c[..., 0], c[..., 1]
    fwd = torch.stack([cp * sy, -sp, cp * cy], dim=-1)
    right = torch.stack([cy, torch.zeros_like(cy), -sy], dim=-1)
    up = _cross(fwd, right)
    return -fwd, -up, right


def get_directions(euler_angles: torch.Tensor):
    """Euler angles (pitch, yaw, roll) ``[..., 3]`` -> (forward, up, right)
    (``Renderer.cu:27-42``): the camera kernel for a CUDA tensor,
    :func:`basis_plain` otherwise."""
    e = euler_angles.to(torch.float32)
    if not e.is_cuda:
        return basis_plain(e)
    b = camera_kernel.camera_basis(e.reshape(-1, 3).contiguous()).reshape(*e.shape[:-1], 3, 3)
    return b[..., 0, :], b[..., 1, :], b[..., 2, :]


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


@functools.lru_cache(maxsize=64)
def tan_half_fov(fov_degrees: float) -> float:
    """glibc's ``tanf`` of half the field of view in radians, in float32 as
    the reference rounds ``fov * 3.1415 / 180 / 2``: one value per
    configuration, taken on the host (``core/libm.py::tanf``)."""
    fov = np.float32(fov_degrees) * np.float32(REF_PI) / np.float32(180.0)
    return float(libm.tanf(torch.tensor(fov / np.float32(2.0))))


@functools.lru_cache(maxsize=64)
def perspective_scales(width: int, height: int, fov_degrees: float):
    """``(scale_x, scale_y)`` of the pinhole (``Renderer.cu:44-59``): the
    half field of view's tangent, and it times the aspect ratio, each a
    float32 value (as a Python float), taken on the host once a
    configuration."""
    scale_y = tan_half_fov(fov_degrees)
    return float(np.float32(scale_y) * (np.float32(width) / np.float32(height))), scale_y


def ortho_window(ortho_size, device):
    """The orthographic window ``(sx, sy)``: float32 values (as Python
    floats) of a pair of numbers, or the elements of a ``[2]`` tensor (the
    interactive zoom's, which changes without a new configuration) as
    float32 on ``device``, never read on the host."""
    if isinstance(ortho_size, torch.Tensor):
        osz = ortho_size.to(device=device, dtype=torch.float32)
        return osz[0], osz[1]
    return float(np.float32(ortho_size[0])), float(np.float32(ortho_size[1]))


def ray_direction(fwd, up, right, width: int, height: int, u, v, fov_degrees):
    """Perspective primary-ray direction for uv in [0,1]^2
    (``Renderer.cu:44-59``); returns ``[..., 3]``."""
    ux = u * 2.0 - 1.0
    vy = v * 2.0 - 1.0
    scale_x, scale_y = perspective_scales(width, height, fov_degrees)
    d = fwd + ux[..., None] * scale_x * right + vy[..., None] * scale_y * up
    return d / sqrt_rn(dot3(d, d))[..., None]


def ray_origin_ortho(fwd, up, right, width: int, height: int, u, v, origin, ortho_size):
    """Orthographic ray origin; the direction is ``fwd`` (``Renderer.cu:61-70``).
    ``ortho_size`` is a pair of numbers or a ``[2]`` tensor
    (:func:`ortho_window`)."""
    ratio = float(np.float32(width) / np.float32(height))
    sx, sy = ortho_window(ortho_size, fwd.device)
    return (
        origin.to(torch.float32)
        + right * ((u * 2.0 - 1.0) * sx * ratio)[..., None]
        + up * ((v * 2.0 - 1.0) * sy)[..., None]
    )
