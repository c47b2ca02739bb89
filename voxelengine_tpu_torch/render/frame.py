"""Frame rendering: primary rays -> traversal -> shading -> framebuffer.

Counterpart of ``voxelengine_tpu/render/frame.py`` (the reference's
``screenDispatch`` + ``RenderScreen``, ``Renderer.cu:179-328``):

* checkerboard row remap ``y = 2*y' + (x even) + (frame even)`` with the
  overflow row dropped (``Renderer.cu:186-196``);
* the SHADED view with optional shadow rays, hemisphere AO and one-bounce
  reflections, and the DEBUG (quadrants plus the bottom-left step heatmap,
  whose row ``y == H/2`` keeps stale content, ``Renderer.cu:215-243,
  270-275``), NORMALS, DEPTH and STEPS views;
* sky = raw ray direction, channel-clamped at store (``Renderer.cu:254-258``);
* the crosshair uses the pre-remap row, so it never fires while
  checkerboarding (``Renderer.cu:260-268``);
* normals are negated before shading (``Renderer.cu:212``).

:func:`render_frame` traces a brickmap; :func:`render_frame_dense` traces
a dense :class:`~voxelengine_tpu_torch.core.bitgrid.BitGrid` world (the
small-world path, K2 on the card), which traces no secondary rays and
ignores those three flags, as the JAX dense path does.

The primary rays of a CUDA frame are one launch of the ray-setup kernel
(:func:`primary_rays`, ``kernels/rays.py``), the camera basis included;
the CPU builds them in torch ops (:func:`primary_rays_plain`).  Its
shadow, reflection and AO rays are one launch a kind of K1's or K4's
secondary entry, which builds, walks and reduces them
(:func:`_secondary_inputs`, ``ops/secondary.py``); over a caller's tracer
(the z-sharded frame's) a build and a reduce launch around one call of
it.  Its shading is one
launch of the shading kernel (``kernels/shade.py``): its composite entry
writes the framebuffer (:func:`shade_and_composite`), its other entry
gives ``(color, write)`` (:func:`shade_traced`); the CPU runs
:func:`shade_traced_plain` and :func:`composite_frame`.  A primary-only
frame with a line table is three CUDA kernels: the ray kernel, K1's rays
entry and the shading kernel; with shadows, AO and reflections six.

Where the rays go: with a line table, through
:func:`~voxelengine_tpu_torch.ops.bigtrace.trace_brickmap_hbm` (K1 for CUDA
tensors).  Without one, CUDA rays go through
:func:`~voxelengine_tpu_torch.ops.trace2.trace_brickmap_no_table` (K4, in
its dense-slot or compact instantiation by the world's form); CPU rays run
the plain :func:`~voxelengine_tpu_torch.ops.trace.trace_brickmap`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from voxelengine_tpu_torch.config import FLT_EPS_DDA, DebugView, Environment, Projection, RenderConfig, default_device
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import BrickMap
from voxelengine_tpu_torch.core.exact import dot3, fdiv
from voxelengine_tpu_torch.kernels import rays as rays_kernel
from voxelengine_tpu_torch.kernels import shade as shade_kernel
from voxelengine_tpu_torch.ops.bigtrace import (
    LineTable, trace_brickmap_hbm, trace_brickmap_hbm_staged, trace_secondary_hbm,
)
from voxelengine_tpu_torch.ops.gridtrace import trace_grid_vpu
from voxelengine_tpu_torch.ops.secondary import frame_kinds, norm3, secondary_traced
from voxelengine_tpu_torch.ops.trace import TraceOut
from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_no_table, trace_secondary_no_table
from voxelengine_tpu_torch.render import camera as cam
from voxelengine_tpu_torch.render.shading import calculate_color, reflect, tonemap
from voxelengine_tpu_torch.utils.profiling import span

F32 = torch.float32


def make_framebuffer(cfg: RenderConfig, device=default_device()) -> torch.Tensor:
    """Persistent RGB float framebuffer ``[H, W, 3]`` (``SDLRenderer.cpp:19-31``)."""
    return torch.zeros((cfg.height, cfg.width, 3), dtype=F32, device=device)


def _block_side(n: int) -> int:
    """Largest divisor of n that is <= 32 (1080p checkerboard: 540 -> 30)."""
    for b in range(32, 0, -1):
        if n % b == 0:
            return b
    return 1


def block_geometry(cfg: RenderConfig):
    """(block_w, block_h, num_blocks) of the tile-order pixel blocking."""
    rows = cfg.height // 2 if cfg.checkerboard else cfg.height
    bw, bh = _block_side(cfg.width), _block_side(rows)
    return bw, bh, (cfg.width // bw) * (rows // bh)


def block_permutation_from_steps(steps: torch.Tensor, cfg: RenderConfig, prev_perm=None) -> torch.Tensor:
    """Difficulty-sort permutation of the pixel blocks from a previous
    frame's per-ray steps (taken in ``tile_order``), costliest block first;
    ties keep block order (a stable sort, as ``jnp.argsort``).  Only the
    order of the rays changes, never a pixel.  If that frame itself ran
    under a permutation, pass it as ``prev_perm``: stream block j of a
    permuted frame is original block ``prev_perm[j]``."""
    bw, bh, nb = block_geometry(cfg)
    cost = steps.reshape(nb, bw * bh).max(dim=1).values
    order = torch.argsort(-cost, stable=True)
    return order if prev_perm is None else torch.as_tensor(prev_perm, device=order.device)[order]


def _unblock(a: torch.Tensor, cfg: RenderConfig, block_perm=None) -> torch.Tensor:
    """Invert the tile_order ray layout (and ``block_perm``'s block order)
    back to a ``[rows, W, ...]`` image."""
    W = cfg.width
    rows = cfg.height // 2 if cfg.checkerboard else cfg.height
    rest = a.shape[1:]
    bw, bh = _block_side(W), _block_side(rows)
    if cfg.tile_order and bw * bh > 1:
        if block_perm is not None:
            a = a.reshape(-1, bh * bw, *rest)[torch.argsort(block_perm)]
        a = a.reshape(rows // bh, W // bw, bh, bw, *rest)
        a = a.permute(0, 2, 1, 3, *range(4, 4 + len(rest)))
    return a.reshape(rows, W, *rest)


def checkerboard_pair_select(framebuffer, h, w, h_prev, w_prev, frame_number: int):
    """Write a pre-remap row image into the framebuffer's row pairs
    (``y = 2*y' + (x even) + (frame even)``, ``Renderer.cu:186-196``).
    ``h_prev``/``w_prev`` hold each row's predecessor (the even-frame +2
    source).  Updates ``framebuffer`` in place and returns it."""
    rows, W = w.shape
    ce = (torch.arange(W, device=w.device) % 2 == 0)[None, :]  # column parity
    if frame_number % 2 == 0:
        src0, m0, m1 = h_prev, ce & w_prev, w & ~ce
    else:
        src0, m0, m1 = h, ~ce & w, w & ce
    pairs = framebuffer.view(rows, 2, W, 3)
    pairs[:, 0] = torch.where(m0[..., None], src0, pairs[:, 0])
    pairs[:, 1] = torch.where(m1[..., None], h, pairs[:, 1])
    return framebuffer


def composite_frame(framebuffer, color, write, cfg: RenderConfig, frame_number: int, block_perm=None):
    """Write a frame's shaded pixel stream into the persistent framebuffer,
    in place (the JAX version donates the buffer; ``frame.py:473``)."""
    H, W = cfg.height, cfg.width
    h = _unblock(color, cfg, block_perm)  # [rows, W, 3]
    w = _unblock(write, cfg, block_perm)  # [rows, W] bool
    if not cfg.checkerboard:
        framebuffer.copy_(torch.where(w[..., None], h, framebuffer))
        return framebuffer
    if H % 2:
        # odd height: the last row pair is half a pair, so write the pixels
        # whose target row exists (JAX scatters with mode="drop")
        dev = framebuffer.device
        py = (torch.arange(H // 2, device=dev)[:, None] * 2
              + (torch.arange(W, device=dev) % 2 == 0)[None, :] + int(frame_number % 2 == 0))
        keep = w & (py < H)
        px = torch.arange(W, device=dev)[None, :].expand_as(py)
        framebuffer[py[keep], px[keep]] = h[keep]
        return framebuffer
    h_prev = torch.cat([torch.zeros_like(h[:1]), h[:-1]], dim=0)
    w_prev = torch.cat([torch.zeros_like(w[:1]), w[:-1]], dim=0)
    return checkerboard_pair_select(framebuffer, h, w, h_prev, w_prev, frame_number)


def _is_cuda(t: torch.Tensor) -> bool:
    """Whether rays on ``t``'s device come from the ray-setup kernel (one
    place, so a test can route a CPU call as a card call)."""
    return t.is_cuda


def _projection_args(cfg: RenderConfig, ortho_size, device) -> dict:
    """The ray-setup kernel's projection arguments (``kernels/rays.py``):
    ``ortho``, and ``a``, ``b`` (``scale_x``, ``scale_y``; or the
    orthographic window of ``ortho_size``, else ``cfg.ortho_size``, which as
    a ``[2]`` tensor goes to the kernel as ``window`` instead)."""
    if cfg.projection is Projection.PERSPECTIVE:
        a, b = cam.perspective_scales(cfg.width, cfg.height, cfg.fov_degrees)
        return dict(ortho=False, a=a, b=b)
    osz = cfg.ortho_size if ortho_size is None else ortho_size
    if isinstance(osz, torch.Tensor):
        return dict(ortho=True, a=0.0, b=0.0, window=osz.to(device=device, dtype=F32).reshape(2).contiguous())
    a, b = cam.ortho_window(osz, device)
    return dict(ortho=True, a=a, b=b)


def _kernel_rays(origin: torch.Tensor, rows: torch.Tensor, basis):
    """``(origins, dirs)`` of the ray-setup kernel's ``rows``: directions,
    from one origin (a row stride of 0, as the plain version broadcasts
    it), or, with a ``basis`` (orthographic), origins along ``fwd``."""
    if basis is None:
        return origin.expand_as(rows), rows
    return rows, basis[:3].expand(rows.shape[0], 3)


def primary_rays(cfg: RenderConfig, origin: torch.Tensor, euler: torch.Tensor, frame_number: int,
                 block_perm=None, ortho_size=None):
    """The frame's primary rays on ``origin``'s device.

    Returns ``(origins [N,3], dirs [N,3], px [N], py [N], py_r [N])`` with
    (px, py) final framebuffer coordinates (checkerboard-remapped; py may
    equal H for dropped rows) and ``py_r`` the pre-remap row.  With
    ``tile_order`` the rays come in ~32x32 pixel blocks, in ``block_perm``'s
    order where given (:func:`block_permutation_from_steps`).
    ``ortho_size`` (a ``[2]`` tensor) overrides ``cfg.ortho_size``, as the
    interactive zoom does (``SetOrthoWindowSize``, ``main.cu:94-107``).
    On the card one launch of the ray-setup kernel (``kernels/rays.py``),
    the camera basis included; on the CPU :func:`primary_rays_plain`.
    """
    if not _is_cuda(origin):
        return primary_rays_plain(cfg, origin, euler, frame_number, block_perm, ortho_size)
    W, H = cfg.width, cfg.height
    rows = H // 2 if cfg.checkerboard else H
    bw, bh = _block_side(W), _block_side(rows)
    tiled = cfg.tile_order and bw * bh > 1
    if tiled and block_perm is not None:
        block_perm = torch.as_tensor(block_perm, device=origin.device).to(torch.int64)
    origin = origin.to(F32)
    out, basis, px, py, py_r = rays_kernel.frame_rays(
        euler.to(F32), origin, n=rows * W, width=W, height=H, tile=(bw, bh) if tiled else (W, 1),
        checkerboard=cfg.checkerboard, even_frame=frame_number % 2 == 0, block_perm=block_perm if tiled else None,
        **_projection_args(cfg, ortho_size, origin.device),
    )
    return (*_kernel_rays(origin, out, basis), px, py, py_r)


def primary_rays_plain(cfg: RenderConfig, origin: torch.Tensor, euler: torch.Tensor, frame_number: int,
                       block_perm=None, ortho_size=None):
    """:func:`primary_rays` in eager torch ops: the ray-setup kernel's
    plain version, which the CPU runs."""
    dev = origin.device
    W, H = cfg.width, cfg.height
    rows = H // 2 if cfg.checkerboard else H
    yg, xg = torch.meshgrid(torch.arange(rows, device=dev), torch.arange(W, device=dev), indexing="ij")
    bw, bh = _block_side(W), _block_side(rows)
    if cfg.tile_order and bw * bh > 1:
        def blocked(a):
            a = a.reshape(rows // bh, bh, W // bw, bw).permute(0, 2, 1, 3).reshape(-1)
            if block_perm is not None:
                a = a.reshape(-1, bh * bw)[block_perm].reshape(-1)
            return a
        px, py_r = blocked(xg), blocked(yg)
    else:
        px, py_r = xg.reshape(-1), yg.reshape(-1)
    if cfg.checkerboard:
        py = py_r * 2 + (px % 2 == 0).to(px.dtype) + int(frame_number % 2 == 0)
    else:
        py = py_r

    u = fdiv(px.to(F32), float(W))
    v = fdiv(py.to(F32), float(H))
    fwd, up, right = cam.get_directions(euler)
    origin = origin.to(F32)
    if cfg.projection is Projection.PERSPECTIVE:
        dirs = cam.ray_direction(fwd, up, right, W, H, u, v, cfg.fov_degrees)
        origins = origin.expand_as(dirs)
    else:
        dirs = fwd.expand(px.shape[0], 3)
        osz = cfg.ortho_size if ortho_size is None else ortho_size
        origins = cam.ray_origin_ortho(fwd, up, right, W, H, u, v, origin, osz)
    return origins, dirs, px, py, py_r


def _secondary_inputs(bm: Optional[BrickMap], lt: Optional[LineTable], out: TraceOut, dirs, px, py,
                      env: Environment, frame_number: int, cfg: RenderConfig, secondary=None):
    """The shading's secondary traces (``ops/secondary.py``): ``(shadow,
    reflection, ao)``, ``shadow = (hit, steps)`` of the shadow rays,
    ``reflection = (hit, position, normal)`` of the mirror bounce, ``ao``
    the AO factor (``f32[N]``), each None where the frame traces none (see
    :func:`shade_traced`).  Each kind is one launch of K1's secondary entry
    through the line table, or of K4's without one, for CUDA tensors, and
    its plain version on the CPU; a caller's ``secondary`` tracer takes
    ``secondary_traced``: on the card a build launch, one call of the
    tracer and a reduce launch a kind."""
    kinds = frame_kinds(cfg)
    if not kinds or (bm is None and secondary is None):
        return None, None, None  # no launch: a primary frame's shading reads the trace alone
    args = (out, dirs, px, py, env, frame_number, cfg)
    res = {}
    for k in kinds:
        with span("frame.secondary", detail=k):
            if secondary is not None:
                res[k] = secondary_traced(k, secondary, *args)
            elif lt is not None:
                res[k] = trace_secondary_hbm(bm, lt, k, *args)
            else:
                res[k] = trace_secondary_no_table(bm, k, *args)
    return res.get("shadow"), res.get("reflection"), res.get("ao")


def shade_traced(
    bm: Optional[BrickMap], out: TraceOut, origins, dirs, px, py, py_r, origin, env: Environment,
    frame_number: int, cfg: RenderConfig, lt: Optional[LineTable] = None, secondary=None,
):
    """Shading stage of ``screenDispatch`` given trace results; returns
    ``(color [N,3], write [N])``.  ``bm``/``lt`` are the world the shadow,
    reflection and AO rays trace; ``secondary`` optionally replaces their
    trace with a ``(origins, dirs, max_steps) -> TraceOut`` of the caller's
    (a distributed world's tracer).  With neither (the dense path) the
    three flags are ignored, as in JAX.  On the card, after the secondary
    entries (:func:`_secondary_inputs`), one launch of the shading kernel;
    on the CPU :func:`shade_traced_plain`."""
    if not _is_cuda(out.position):
        return shade_traced_plain(bm, out, origins, dirs, px, py, py_r, origin, env, frame_number, cfg, lt,
                                  secondary)
    shadow, reflection, ao = _secondary_inputs(bm, lt, out, dirs, px, py, env, frame_number, cfg, secondary)
    return shade_kernel.shade(out, origins, dirs, px, py, py_r, origin.to(F32), env, cfg, shadow=shadow,
                              reflection=reflection, ao=ao)


def shade_traced_plain(
    bm: Optional[BrickMap], out: TraceOut, origins, dirs, px, py, py_r, origin, env: Environment,
    frame_number: int, cfg: RenderConfig, lt: Optional[LineTable] = None, secondary=None,
):
    """:func:`shade_traced` in eager torch ops: the shading kernel's plain
    version, which the CPU runs."""
    shadow, reflection, ao = _secondary_inputs(bm, lt, out, dirs, px, py, env, frame_number, cfg, secondary)
    W, H = cfg.width, cfg.height
    view = cfg.debug_view
    normal = -out.normal  # Renderer.cu:212
    steps = out.steps

    shadow_hit = None
    if shadow is not None:
        shadow_hit = shadow[0] & out.hit
        steps = steps + torch.where(out.hit, shadow[1], 0)

    zero = torch.zeros_like(out.steps, dtype=F32)
    if view in (DebugView.DEBUG, DebugView.DEPTH):
        depth = torch.stack([norm3(out.position - origins) * 0.01, zero, zero], dim=-1)
    if view in (DebugView.DEBUG, DebugView.STEPS):
        heat = torch.stack([fdiv(steps.to(F32), 256.0), zero, zero], dim=-1)
    write = torch.ones_like(out.hit)
    if view is DebugView.SHADED:
        color = calculate_color(origin.to(F32), normal, out.position, env, shadow_hit)
        if reflection is not None:
            # one mirror bounce shaded like a primary hit (its miss: the raw
            # reflected direction), lerped in by reflectivity
            rhit, rpos, rnrm = reflection
            rdir = reflect(dirs, normal)
            ro = out.position + normal * 0.01
            rcol = calculate_color(ro, -rnrm, rpos, env, None)
            rcol = torch.where(rhit[:, None], rcol, rdir)
            color = color + (rcol - color) * cfg.reflectivity
        if ao is not None:
            l_dot = torch.clamp_min(dot3(normal, env.light_direction), 0.0)
            color = torch.where((l_dot == 0.0)[:, None], color * ao[:, None], color)
        color = tonemap(color)
    elif view is DebugView.DEBUG:
        hp = _mod(fdiv(out.position, float(cfg.debug_pos_mod)), float(np.float32(1.0) + np.float32(FLT_EPS_DDA)))
        left = px < (W >> 1)
        top = py < (H >> 1)
        color = torch.where(top[:, None], torch.where(left[:, None], normal, hp), depth)
        write = ~(left & ~top)  # bottom-left quadrant: no write on hit (Renderer.cu:233-235)
    elif view is DebugView.NORMALS:
        color = normal
    elif view is DebugView.DEPTH:
        color = depth
    else:  # STEPS
        color = heat

    # miss -> sky = raw ray direction (Renderer.cu:254-258)
    color = torch.where(out.hit[:, None], color, dirs)
    write = write | ~out.hit
    if cfg.crosshair:
        # pre-remap row: only fires without checkerboarding (Renderer.cu:260-268)
        cross = (px == (W >> 1)) & (py_r == (H >> 1))
        color = torch.where(cross[:, None], 10.0, color)
        write = write | cross
    if view is DebugView.DEBUG:
        # bottom-left step heatmap overlay (Renderer.cu:270-275)
        bl = (px < (W >> 1)) & (py > (H >> 1))
        color = torch.where(bl[:, None], heat, color)
        write = write | bl
    return torch.clamp(color, 0.0, 1.0), write  # setPixelColor clamp (Renderer.cu:79-81)


def shade_and_composite(
    framebuffer: torch.Tensor, bm: Optional[BrickMap], out: TraceOut, origins, dirs, px, py, py_r, origin,
    env: Environment, frame_number: int, cfg: RenderConfig, lt: Optional[LineTable] = None, secondary=None,
    block_perm=None, dest=None, composite_plain=None,
) -> torch.Tensor:
    """:func:`shade_traced` then :func:`composite_frame`, in place; returns
    the framebuffer.  On the card, after the secondary entries, one
    launch of the shading kernel's composite entry, which writes each
    written ray's pixel at ``(px, py)`` (the rays' pixels already hold the
    tile order and ``block_perm``); on the CPU the plain versions.  A
    sharded frame's ``framebuffer`` is its rank's part of the image: it
    passes ``dest``, where that part lies (``kernels/shade.py::
    shade_composite``), and ``composite_plain(framebuffer, color,
    write)``, its plain composite, in place of :func:`composite_frame`."""
    if not _is_cuda(out.position):
        with span("frame.shade"):
            color, write = shade_traced_plain(bm, out, origins, dirs, px, py, py_r, origin, env, frame_number, cfg,
                                              lt, secondary)
            if composite_plain is not None:
                return composite_plain(framebuffer, color, write)
            return composite_frame(framebuffer, color, write, cfg, frame_number, block_perm)
    shadow, reflection, ao = _secondary_inputs(bm, lt, out, dirs, px, py, env, frame_number, cfg, secondary)
    with span("frame.shade"):
        return shade_kernel.shade_composite(framebuffer, out, origins, dirs, px, py, py_r, origin.to(F32), env,
                                            cfg, shadow=shadow, reflection=reflection, ao=ao, dest=dest)


def _mod(a: torch.Tensor, m: float) -> torch.Tensor:
    """``jnp.mod(a, m)`` for ``m > 0``: the truncated remainder, moved into
    ``[0, m)`` when negative, as XLA computes it (``torch.remainder``
    rounds ``a - m * floor(a / m)`` differently)."""
    r = torch.fmod(a, m)
    return torch.where((r != 0.0) & (r < 0.0), r + m, r)


def probe_use_macro(bm: BrickMap, lt: LineTable, origins, dirs, cfg: RenderConfig, stride: int = 4) -> bool:
    """Probe-informed macro selection (``voxelengine_tpu/render/frame.py:
    224-242``): trace every ``stride``-th ray with the diagnostic counters
    and return False when no macro skip fires.  Rays that never leave
    occupied regions trace the same with the skip levels off, which then
    only cost; the decision is a speed hint, never a change of results.
    One host read."""
    _, ph = trace_brickmap_hbm(bm, lt, origins[::stride], dirs[::stride], cfg.max_steps, return_phases=True)
    return int(ph["mskip"].sum()) != 0


def trace_primary(bm: BrickMap, origins, dirs, cfg: RenderConfig, lt: Optional[LineTable] = None) -> TraceOut:
    """The frame's primary trace: with ``lt`` through the line-table
    traversal (K1 for CUDA tensors; with ``cfg.trace_stage_steps``, the
    staged trace), with the macro skip levels when ``cfg.trace_use_macro``;
    otherwise through ``trace_brickmap_no_table`` (K4 for CUDA rays)."""
    if lt is not None and cfg.trace_stage_steps:
        return trace_brickmap_hbm_staged(
            bm, lt, origins, dirs, cfg.max_steps, stage_steps=cfg.trace_stage_steps,
            tail_frac=cfg.trace_tail_frac, use_macro=cfg.trace_use_macro,
        )
    if lt is not None:
        return trace_brickmap_hbm(bm, lt, origins, dirs, cfg.max_steps, use_macro=cfg.trace_use_macro)
    return trace_brickmap_no_table(bm, origins, dirs, cfg.max_steps)


def shade_pixels(
    bm: BrickMap, origins, dirs, px, py, py_r, origin, env: Environment, frame_number: int, cfg: RenderConfig,
    lt: Optional[LineTable] = None,
):
    """Trace (:func:`trace_primary`) + shade (:func:`shade_traced`) a flat
    pixel batch; returns ``(color [N,3], write [N])``."""
    out = trace_primary(bm, origins, dirs, cfg, lt)
    return shade_traced(bm, out, origins, dirs, px, py, py_r, origin, env, frame_number, cfg, lt)


def render_frame(
    bm: BrickMap,
    framebuffer: torch.Tensor,
    origin: torch.Tensor,
    euler: torch.Tensor,
    env: Environment,
    frame_number: int,
    cfg: RenderConfig,
    lt: Optional[LineTable] = None,
    block_perm: Optional[torch.Tensor] = None,
    ortho_size: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Render one frame into the persistent framebuffer (RGB f32 in [0,1]),
    updating it in place; returns it.  ``lt`` selects the line-table
    traversal (see :func:`trace_primary`); ``block_perm`` reorders the pixel
    blocks (:func:`block_permutation_from_steps`), which changes no pixel;
    ``ortho_size`` is the orthographic window as a tensor.  Under
    ``torch.profiler`` a ``frame`` span (``utils/profiling.py::span``) with
    ``frame.rays``, ``frame.trace``, ``frame.secondary`` (a kind each) and
    ``frame.shade`` inside it."""
    with span("frame"):
        with span("frame.rays"):
            origins, dirs, px, py, py_r = primary_rays(cfg, origin, euler, frame_number, block_perm, ortho_size)
        with span("frame.trace"):
            out = trace_primary(bm, origins, dirs, cfg, lt)
        return shade_and_composite(framebuffer, bm, out, origins, dirs, px, py, py_r, origin, env, frame_number, cfg,
                                   lt, block_perm=block_perm)


def render_frame_dense(
    grid: BitGrid,
    framebuffer: torch.Tensor,
    origin: torch.Tensor,
    euler: torch.Tensor,
    env: Environment,
    frame_number: int,
    cfg: RenderConfig,
    ortho_size: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`render_frame` over a dense :class:`BitGrid` world: primary
    rays, :func:`~voxelengine_tpu_torch.ops.gridtrace.trace_grid_vpu` (K2
    for CUDA tensors, the plain ``trace_grid`` on the CPU), shading and
    composite, in place.  No secondary rays are traced: ``shadow_rays``,
    ``ao_samples`` and ``reflections`` are ignored, as on the JAX dense
    path (``voxelengine_tpu/render/frame.py:541-542``).  Spans as
    :func:`render_frame`'s."""
    with span("frame"):
        with span("frame.rays"):
            origins, dirs, px, py, py_r = primary_rays(cfg, origin, euler, frame_number, ortho_size=ortho_size)
        with span("frame.trace"):
            out = trace_grid_vpu(grid, origins, dirs, cfg.max_steps)
        return shade_and_composite(framebuffer, None, out, origins, dirs, px, py, py_r, origin, env, frame_number,
                                   cfg)


def to_bgra8(fb: torch.Tensor) -> torch.Tensor:
    """RGB f32 [0,1] -> BGRA8888 bytes (``Renderer.cuh:29-31``); a
    ``bgra8`` span under ``torch.profiler``."""
    with span("bgra8"):
        u8 = (torch.clamp(fb, 0.0, 1.0) * 255.0).to(torch.uint8)
        a = torch.full(fb.shape[:-1] + (1,), 255, dtype=torch.uint8, device=fb.device)
        return torch.cat([u8[..., 2:3], u8[..., 1:2], u8[..., 0:1], a], dim=-1)
