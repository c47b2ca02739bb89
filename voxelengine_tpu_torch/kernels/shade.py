"""Wrapper of the shading kernel (``csrc/shade.cu`` over ``csrc/shade.cuh``).

:func:`shade` computes ``render/frame.py::shade_traced`` after its traces
in one launch, one thread a ray: ``(color, write)``.
:func:`shade_composite` shades the same rays straight into the
framebuffer, ``composite_frame`` included; with ``dest`` it writes a
rank's part of a sharded frame's framebuffer (a row band or its
block-cyclic blocks), the sharded frames' pair select included.  It has no
TPU counterpart: the JAX package shades and composites with XLA ops of its
jitted frame (``voxelengine_tpu/render/frame.py:350-470, 114-169``).  Its
plain versions are ``render/frame.py::shade_traced_plain`` and
``composite_frame`` (``parallel/sharded.py``'s plain composites for a
rank's part), which the CPU runs.  The camera position and the
environment stay on the card: no call reads them on the host.
``launches`` counts the launches of both.
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
    ``shadow`` ``(hit, steps)``, ``reflection`` ``(hit, position,
    normal)`` (the kernel reflects ``dirs`` again for a miss's sky) and
    ``ao`` (``f32[N]``) the secondary results, or None."""
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
    opt = [None] * 6
    if shadow is not None:
        build.check(kernel, "shadow hit", shadow[0], U8, (n,), dev)
        build.check(kernel, "shadow steps", shadow[1], torch.int32, (n,), dev)
        opt[0:2] = shadow
    if reflection is not None:
        build.check(kernel, "reflection hit", reflection[0], U8, (n,), dev)
        for name, t in zip(("reflection position", "reflection normal"), reflection[1:]):
            build.check(kernel, name, t, F32, (n, 3), dev)
        opt[2:5] = reflection
    if ao is not None:
        build.check(kernel, "ao", ao, F32, (n,), dev)
        opt[5] = ao
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
                    cfg: RenderConfig, *, shadow=None, reflection=None, ao=None, dest=None) -> torch.Tensor:
    """:func:`shade` written straight into ``framebuffer`` at each written
    ray's pixel, in place.  ``dest = (tw, th, tiles_x, ranks, rank)``
    (``csrc/shade.cuh::FrameDest``) says where ``framebuffer`` lies in the
    ``W x H`` image: tiles of ``th`` rows by ``tw`` columns, ``tiles_x`` to
    a row of tiles, tile ``j`` on rank ``j % ranks`` at entry ``j //
    ranks`` (a contiguous tensor of ``tiles / ranks * th * tw * 3``
    floats).  A ray writes only where its pixel is the rank's, its row
    ``py`` lies in ``[0, H)`` and its pre-remap row is not negative (rank
    0's halo row).  The default, ``(W, H, 1, 1, 0)``, is the whole
    ``f32[H, W, 3]`` framebuffer: ``composite_frame`` of the shaded frame.
    A sharded frame passes its rank's band or blocks
    (``parallel/sharded.py``).  Returns ``framebuffer``."""
    global launches
    kernel = "shade_composite"
    dev, n, args, _rows = _args(kernel, out, origins, dirs, px, py, py_r, origin, env, cfg, shadow, reflection, ao)
    if dest is None:
        dest = (cfg.width, cfg.height, 1, 1, 0)
        build.check(kernel, "framebuffer", framebuffer, F32, (cfg.height, cfg.width, 3), dev)
    else:
        tw, th, tiles_x, ranks, rank = dest
        tiles = -(-cfg.height // th) * tiles_x
        if tiles_x * tw != cfg.width or tiles % ranks or not 0 <= rank < ranks:
            raise ValueError(f"{kernel}: tiles {dest} do not cut a {cfg.width}x{cfg.height} image among its ranks")
        build.check(kernel, "framebuffer", framebuffer, F32, tuple(framebuffer.shape), dev)
        if framebuffer.numel() != tiles // ranks * th * tw * 3:
            raise ValueError(f"{kernel}: a rank's {tiles // ranks} tiles of {th}x{tw} pixels need "
                             f"{tiles // ranks * th * tw * 3} floats, the framebuffer has {framebuffer.numel()}")
    if n:
        build.launch(kernel, build.load_kernel("shade").vx_shade_composite, *args, *dest, framebuffer.data_ptr(),
                     dev=dev)
        launches += 1
    return framebuffer
