"""Ray/AABB slab intersection: counterpart of ``voxelengine_tpu/ops/aabb.py``.

The reference's ``RayIntersectsAABB`` (``VolumeRaytracer.cu:124-174``): a
zero direction component is replaced by FLT_EPSILON before the reciprocal,
the entry point is ``start + t_min * dir``, and the entry normal is picked
x, then y, then z among the slabs that produced ``t_min``.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelengine_tpu_torch.core.exact import fdiv

FLT_EPS = float(np.finfo(np.float32).eps)


def ray_aabb(start, direction, bmin, bmax):
    """Slab test on ``[..., 3]`` float32 tensors (broadcasting).  Returns
    ``(hit, t_min, point, normal)``; ``t_min`` may be negative when
    ``start`` is inside the box (the reference then reports the point
    behind the start, which is kept)."""
    inv = fdiv(1.0, torch.where(direction == 0.0, FLT_EPS, direction))
    t_lo = (bmin - start) * inv
    t_hi = (bmax - start) * inv
    t1 = torch.minimum(t_lo, t_hi)  # per-axis entering time
    t2 = torch.maximum(t_lo, t_hi)  # per-axis exiting time
    t_min = torch.maximum(torch.maximum(t1[..., 0], t1[..., 1]), t1[..., 2])
    t_max = torch.minimum(torch.minimum(t2[..., 0], t2[..., 1]), t2[..., 2])
    hit = t_max >= torch.clamp_min(t_min, 0.0)

    point = start + t_min[..., None] * direction

    is_x = t_min == t1[..., 0]
    is_y = ~is_x & (t_min == t1[..., 1])
    sign = torch.where(inv < 0.0, -1.0, 1.0)
    normal = torch.stack(
        [
            torch.where(is_x, sign[..., 0], 0.0),
            torch.where(is_y, sign[..., 1], 0.0),
            torch.where(is_x | is_y, 0.0, sign[..., 2]),
        ],
        dim=-1,
    )
    return hit, t_min, point, normal
