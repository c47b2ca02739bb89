"""Wrapper of the shading kernel (``csrc/shade.cu`` over ``csrc/shade.cuh``).

:func:`shade` computes ``render/frame.py::shade_traced`` after its traces
in one launch, one thread a ray: ``(color, write)``.
:func:`shade_composite` shades the same rays straight into the
framebuffer, ``composite_frame`` included.  It has no TPU counterpart: the
JAX package shades and composites with XLA ops of its jitted frame
(``voxelengine_tpu/render/frame.py:350-470, 114-169``).  Its plain versions
are ``render/frame.py::shade_traced_plain`` and ``composite_frame``, which
the CPU runs.  The camera position and the environment stay on the card:
no call reads them on the host.  ``launches`` counts the launches of both
entries.
"""

from __future__ import annotations

import numpy as np
import torch

from voxelengine_tpu_torch.config import FLT_EPS_DDA, DebugView, Environment, RenderConfig
from voxelengine_tpu_torch.kernels import build

F32, I64, U8 = torch.float32, torch.int64, torch.bool
# render/frame.py::_mod's divisor in the DEBUG view
MOD_M = float(np.float32(1.0) + np.float32(FLT_EPS_DDA))
launches = 0


def _args(kernel: str, out, origins, dirs, px, py, py_r, origin, env: Environment, cfg: RenderConfig,
          shadow=None, reflection=None, ao=None) -> tuple:
    """``(device, n, the launcher's arguments before its outputs, the rays
    they point into)``, checked; the caller holds the last until the launch
    is made (a copied ``origins`` or ``dirs`` lives only there).  ``out`` is
    the primary trace's ``TraceOut`` (hit bool, position, normal, steps
    i32); ``origins`` and ``dirs`` the rays (``f32[N, 3]``,
    rows of 3 floats or one broadcast row); ``px``, ``py``, ``py_r`` the
    pixels (``int64[N]``); ``origin`` the camera position (``f32[3]``);
    ``shadow`` ``(hit, steps)``, ``reflection`` ``(hit, position, normal,
    direction)`` and ``ao`` (``f32[N]``) the secondary results, or None."""
    dev = out.position.device
    build.require_cuda(kernel, dev)
    n = out.position.shape[0]
    build.check(kernel, "hit", out.hit, U8, (n,), dev)
    build.check(kernel, "position", out.position, F32, (n, 3), dev)
    build.check(kernel, "normal", out.normal, F32, (n, 3), dev)
    build.check(kernel, "steps", out.steps, torch.int32, (n,), dev)
    o, os = build.ray_rows(kernel, "origins", origins, n, dev)
    d, ds = build.ray_rows(kernel, "dirs", dirs, n, dev)
    for name, t in (("px", px), ("py", py), ("py_r", py_r)):
        build.check(kernel, name, t, I64, (n,), dev)
    vecs = (origin, env.light_direction, env.light_color, env.ambient_color)
    for name, t in zip(("origin", "light_direction", "light_color", "ambient_color"), vecs):
        build.check(kernel, name, t, F32, (3,), dev)
    opt = [None] * 7
    if shadow is not None:
        build.check(kernel, "shadow hit", shadow[0], U8, (n,), dev)
        build.check(kernel, "shadow steps", shadow[1], torch.int32, (n,), dev)
        opt[0:2] = shadow
    if reflection is not None:
        build.check(kernel, "reflection hit", reflection[0], U8, (n,), dev)
        for name, t in zip(("reflection position", "reflection normal", "reflection direction"), reflection[1:]):
            build.check(kernel, name, t, F32, (n, 3), dev)
        opt[2:6] = reflection
    if ao is not None:
        build.check(kernel, "ao", ao, F32, (n,), dev)
        opt[6] = ao
    args = (
        *(t.data_ptr() for t in out), o.data_ptr(), os, d.data_ptr(), ds, px.data_ptr(), py.data_ptr(),
        py_r.data_ptr(), *(t.data_ptr() for t in vecs), *(None if t is None else t.data_ptr() for t in opt),
        cfg.width, cfg.height, DebugView(cfg.debug_view).value, int(cfg.crosshair), float(cfg.reflectivity),
        float(cfg.debug_pos_mod), MOD_M, n,
    )
    return dev, n, args, (o, d)


def shade(out, origins, dirs, px, py, py_r, origin, env: Environment, cfg: RenderConfig, *, shadow=None,
          reflection=None, ao=None):
    """The frame's shading of N traced rays on the card: ``(color f32[N, 3],
    write bool[N])``, ``shade_traced``'s.  Arguments as :func:`_args`'s.
    Launches on the current stream without synchronising and raises if the
    launch is refused."""
    global launches
    dev, n, args, _rows = _args("shade", out, origins, dirs, px, py, py_r, origin, env, cfg, shadow, reflection, ao)
    color = torch.empty((n, 3), dtype=F32, device=dev)
    write = torch.empty((n,), dtype=torch.bool, device=dev)
    if n:
        build.launch("shade", build.load_kernel("shade").vx_shade, *args, color.data_ptr(), write.data_ptr(),
                     dev=dev)
        launches += 1
    return color, write


def shade_composite(framebuffer: torch.Tensor, out, origins, dirs, px, py, py_r, origin, env: Environment,
                    cfg: RenderConfig, *, shadow=None, reflection=None, ao=None) -> torch.Tensor:
    """:func:`shade` written straight into ``framebuffer`` (``f32[H, W, 3]``,
    contiguous) at each written ray's ``(px, py)``, rows ``py >= H`` dropped:
    ``composite_frame`` of the shaded frame, in place.  Returns
    ``framebuffer``."""
    global launches
    dev, n, args, _rows = _args("shade_composite", out, origins, dirs, px, py, py_r, origin, env, cfg, shadow,
                                reflection, ao)
    build.check("shade_composite", "framebuffer", framebuffer, F32, (cfg.height, cfg.width, 3), dev)
    if n:
        build.launch("shade_composite", build.load_kernel("shade").vx_shade_composite, *args,
                     framebuffer.data_ptr(), dev=dev)
        launches += 1
    return framebuffer
