"""Frame rendering: primary rays -> traversal -> shading -> framebuffer.

Counterpart of :mod:`voxelengine_tpu.render.frame` (the reference's
``screenDispatch`` + ``RenderScreen``, ``Renderer.cu:179-328``), for the
SHADED view:

* checkerboard row remap ``y = 2*y' + (x even) + (frame even)`` with the
  overflow row dropped (``Renderer.cu:186-196``);
* sky = raw ray direction, channel-clamped at store (``Renderer.cu:254-258``);
* the crosshair uses the pre-remap row, so it never fires while
  checkerboarding (``Renderer.cu:260-268``);
* normals are negated before shading (``Renderer.cu:212``).

:func:`render_frame` traces a brickmap; :func:`render_frame_dense` traces
a dense :class:`~voxelengine_tpu_torch.core.bitgrid.BitGrid` world (the
small-world path, K2 on the card).

Not ported yet, and refused rather than ignored: the DEBUG, NORMALS, DEPTH
and STEPS views, shadow / AO / reflection rays over a brickmap, block
permutations and the odd-height checkerboard.  The dense path traces no
secondary rays and ignores those three flags, as the JAX dense path does.
"""

from __future__ import annotations

from typing import Optional

import torch

from voxelengine_tpu_torch.config import DebugView, Environment, Projection, RenderConfig, default_device
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import BrickMap
from voxelengine_tpu_torch.core.exact import fdiv
from voxelengine_tpu_torch.ops.bigtrace import LineTable, trace_brickmap_hbm, trace_brickmap_hbm_staged
from voxelengine_tpu_torch.ops.gridtrace import trace_grid_vpu
from voxelengine_tpu_torch.ops.trace import TraceOut, trace_brickmap
from voxelengine_tpu_torch.render import camera as cam
from voxelengine_tpu_torch.render.shading import calculate_color, tonemap

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


def _unblock(a: torch.Tensor, cfg: RenderConfig) -> torch.Tensor:
    """Invert the tile_order ray layout back to a ``[rows, W, ...]`` image."""
    W = cfg.width
    rows = cfg.height // 2 if cfg.checkerboard else cfg.height
    rest = a.shape[1:]
    bw, bh = _block_side(W), _block_side(rows)
    if cfg.tile_order and bw * bh > 1:
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


def composite_frame(framebuffer, color, write, cfg: RenderConfig, frame_number: int):
    """Write a frame's shaded pixel stream into the persistent framebuffer,
    in place (the JAX version donates the buffer; ``frame.py:473``)."""
    H = cfg.height
    h = _unblock(color, cfg)  # [rows, W, 3]
    w = _unblock(write, cfg)  # [rows, W] bool
    if not cfg.checkerboard:
        framebuffer.copy_(torch.where(w[..., None], h, framebuffer))
        return framebuffer
    if H % 2:
        raise NotImplementedError("odd-height checkerboard is not ported yet")
    h_prev = torch.cat([torch.zeros_like(h[:1]), h[:-1]], dim=0)
    w_prev = torch.cat([torch.zeros_like(w[:1]), w[:-1]], dim=0)
    return checkerboard_pair_select(framebuffer, h, w, h_prev, w_prev, frame_number)


def primary_rays(cfg: RenderConfig, origin: torch.Tensor, euler: torch.Tensor, frame_number: int):
    """The frame's primary rays on ``origin``'s device.

    Returns ``(origins [N,3], dirs [N,3], px [N], py [N], py_r [N])`` with
    (px, py) final framebuffer coordinates (checkerboard-remapped; py may
    equal H for dropped rows) and ``py_r`` the pre-remap row.  With
    ``tile_order`` the rays come in ~32x32 pixel blocks.
    """
    dev = origin.device
    W, H = cfg.width, cfg.height
    rows = H // 2 if cfg.checkerboard else H
    yg, xg = torch.meshgrid(torch.arange(rows, device=dev), torch.arange(W, device=dev), indexing="ij")
    bw, bh = _block_side(W), _block_side(rows)
    if cfg.tile_order and bw * bh > 1:
        def blocked(a):
            return a.reshape(rows // bh, bh, W // bw, bw).permute(0, 2, 1, 3).reshape(-1)
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
        origins = cam.ray_origin_ortho(fwd, up, right, W, H, u, v, origin, cfg.ortho_size)
    return origins, dirs, px, py, py_r


def shade_traced(
    out: TraceOut, origins, dirs, px, py, py_r, origin, env: Environment, cfg: RenderConfig,
    bm: Optional[BrickMap] = None,
):
    """Shading stage of ``screenDispatch`` given trace results; returns
    ``(color [N,3], write [N])``.  SHADED view only.  ``bm`` is the world
    the secondary rays would trace, as in the JAX signature: without it
    (the dense path) ``shadow_rays``, ``ao_samples`` and ``reflections``
    are ignored, as JAX ignores them (``voxelengine_tpu/render/frame.py:
    378,396,415``); with it they are refused until they are ported."""
    if cfg.debug_view is not DebugView.SHADED:
        raise NotImplementedError(f"debug view {cfg.debug_view.name} is not ported yet")
    if bm is not None and (cfg.shadow_rays or cfg.ao_samples or cfg.reflections):
        raise NotImplementedError("shadow, AO and reflection rays are not ported yet")
    W, H = cfg.width, cfg.height
    normal = -out.normal  # Renderer.cu:212
    color = tonemap(calculate_color(origin.to(F32), normal, out.position, env))
    # miss -> sky = raw ray direction (Renderer.cu:254-258)
    color = torch.where(out.hit[:, None], color, dirs)
    write = torch.ones_like(out.hit)
    if cfg.crosshair:
        # pre-remap row: only fires without checkerboarding (Renderer.cu:260-268)
        cross = (px == (W >> 1)) & (py_r == (H >> 1))
        color = torch.where(cross[:, None], 10.0, color)
    return torch.clamp(color, 0.0, 1.0), write  # setPixelColor clamp (Renderer.cu:79-81)


def probe_use_macro(bm: BrickMap, lt: LineTable, origins, dirs, cfg: RenderConfig, stride: int = 4) -> bool:
    """Probe-informed macro selection (``voxelengine_tpu/render/frame.py:
    224-242``): trace every ``stride``-th ray with the diagnostic counters
    and return False when no macro skip fires.  Rays that never leave
    occupied regions trace the same with the skip levels off, which then
    only cost; the decision is a speed hint, never a change of results.
    One host read."""
    _, ph = trace_brickmap_hbm(bm, lt, origins[::stride], dirs[::stride], cfg.max_steps, return_phases=True)
    return int(ph["mskip"].sum()) != 0


def shade_pixels(
    bm: BrickMap, origins, dirs, px, py, py_r, origin, env: Environment, cfg: RenderConfig,
    lt: Optional[LineTable] = None,
):
    """Trace + shade a flat pixel batch; returns ``(color [N,3], write [N])``.
    With ``lt`` the rays go through the line-table traversal (K1 for CUDA
    tensors; with ``cfg.trace_stage_steps``, the staged trace), with the
    macro skip levels when ``cfg.trace_use_macro``; otherwise through the
    plain trace."""
    if lt is not None and cfg.trace_stage_steps:
        out = trace_brickmap_hbm_staged(
            bm, lt, origins, dirs, cfg.max_steps, stage_steps=cfg.trace_stage_steps,
            tail_frac=cfg.trace_tail_frac, use_macro=cfg.trace_use_macro,
        )
    elif lt is not None:
        out = trace_brickmap_hbm(bm, lt, origins, dirs, cfg.max_steps, use_macro=cfg.trace_use_macro)
    else:
        out = trace_brickmap(bm, origins, dirs, cfg.max_steps)
    return shade_traced(out, origins, dirs, px, py, py_r, origin, env, cfg, bm)


def render_frame(
    bm: BrickMap,
    framebuffer: torch.Tensor,
    origin: torch.Tensor,
    euler: torch.Tensor,
    env: Environment,
    frame_number: int,
    cfg: RenderConfig,
    lt: Optional[LineTable] = None,
) -> torch.Tensor:
    """Render one frame into the persistent framebuffer (RGB f32 in [0,1]),
    updating it in place; returns it.  ``lt`` selects the line-table
    traversal (see :func:`shade_pixels`)."""
    origins, dirs, px, py, py_r = primary_rays(cfg, origin, euler, frame_number)
    color, write = shade_pixels(bm, origins, dirs, px, py, py_r, origin, env, cfg, lt)
    return composite_frame(framebuffer, color, write, cfg, frame_number)


def render_frame_dense(
    grid: BitGrid,
    framebuffer: torch.Tensor,
    origin: torch.Tensor,
    euler: torch.Tensor,
    env: Environment,
    frame_number: int,
    cfg: RenderConfig,
) -> torch.Tensor:
    """:func:`render_frame` over a dense :class:`BitGrid` world: primary
    rays, :func:`~voxelengine_tpu_torch.ops.gridtrace.trace_grid_vpu` (K2
    for CUDA tensors, the plain ``trace_grid`` on the CPU), shading and
    composite, in place.  No secondary rays are traced: ``shadow_rays``,
    ``ao_samples`` and ``reflections`` are ignored, as on the JAX dense
    path (``voxelengine_tpu/render/frame.py:541-542``)."""
    origins, dirs, px, py, py_r = primary_rays(cfg, origin, euler, frame_number)
    out = trace_grid_vpu(grid, origins, dirs, cfg.max_steps)
    color, write = shade_traced(out, origins, dirs, px, py, py_r, origin, env, cfg)
    return composite_frame(framebuffer, color, write, cfg, frame_number)


def to_bgra8(fb: torch.Tensor) -> torch.Tensor:
    """RGB f32 [0,1] -> BGRA8888 bytes (``Renderer.cuh:29-31``)."""
    u8 = (torch.clamp(fb, 0.0, 1.0) * 255.0).to(torch.uint8)
    a = torch.full(fb.shape[:-1] + (1,), 255, dtype=torch.uint8, device=fb.device)
    return torch.cat([u8[..., 2:3], u8[..., 1:2], u8[..., 0:1], a], dim=-1)
