"""Hit shading: counterpart of ``voxelengine_tpu/render/shading.py``.

``calculateColor`` + ``Tonemap`` (``Renderer.cu:89-177``): Lambert diffuse,
hemispheric ambient keyed on world up, Phong-style specular (exponent 32)
and a Reinhard ``c / (c + 1)`` tonemap.  Dot products are summed as
``x + y + z`` and ``** 32`` is five squarings, as XLA evaluates them.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.config import Environment
from voxelengine_tpu_torch.core.exact import dot3, sqrt_rn


def reflect(i: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """``i - 2 * n * dot(n, i)`` (helper_math.h:1427 semantics)."""
    return i - 2.0 * n * dot3(n, i)[..., None]


def lerp(a, b, t):
    return a + t * (b - a)


def calculate_color(cam_pos, normal, position, env: Environment, shadow_hit=None):
    """Shade a batch of hit points (``Renderer.cu:90-118``).  ``normal``
    and ``position`` are ``[N, 3]``; ``shadow_hit`` an optional bool[N]."""
    L = env.light_direction
    if shadow_hit is None:
        shadow_hit = torch.zeros(position.shape[:-1], dtype=torch.bool, device=position.device)
    lit = torch.where(shadow_hit, 0.0, 1.0)

    l_dot = torch.clamp_min(dot3(normal, L), 0.0) * lit
    diffuse = l_dot[..., None] * env.light_color
    hemi = normal[..., 1] * 0.5 + 0.5  # dot(normal, (0, 1, 0))
    ambient = env.ambient_color * lerp(0.25, 1.0, hemi)[..., None]
    color = diffuse + ambient

    view = position - cam_pos
    # guard the zero-length view (camera inside the hit voxel)
    view = view / torch.clamp_min(sqrt_rn(dot3(view, view)), 1e-12)[..., None]
    refl = reflect(L.expand_as(normal), normal)
    s = torch.clamp_min(dot3(view, refl), 0.0)
    for _ in range(5):  # s ** 32
        s = s * s
    return color + torch.where(shadow_hit, 0.0, s)[..., None] * env.light_color


def tonemap(color: torch.Tensor) -> torch.Tensor:
    """Reinhard tonemap + clamp (``Renderer.cu:170-177``)."""
    return torch.clamp(color / (color + 1.0), 0.0, 1.0)
