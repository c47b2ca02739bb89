"""Pixel-sharded frames and ray batches over a :class:`~voxelengine_tpu_torch.parallel.mesh.Mesh`.

Counterpart of ``voxelengine_tpu/parallel/sharded.py``: every rank holds
the whole world (:func:`replicate_world`) and traces its own share of the
pixels, so the frame path does no communication; only the ray batch's mean
step count is reduced (:func:`raytrace_sharded`).  Each function is called
by every rank with the same arguments (SPMD) and returns the rank's share.

- :func:`render_frame_sharded`: contiguous pre-remap row bands, rank r
  owning rows ``[r * rows / N, (r + 1) * rows / N)``; its framebuffer is
  the rank's band of the image (:func:`make_framebuffer_rows`).
- :func:`render_frame_cyclic`: pixel blocks dealt round-robin (block ``j``
  to rank ``j % N``), which evens out the sky-versus-terrain load of row
  bands; its framebuffer is the rank's blocks
  (:func:`make_framebuffer_cyclic`), made an image by
  :func:`cyclic_to_image` at present time.

Both recompute, for the checkerboard's even-frame ``+2`` remap, the
predecessor pre-remap row of their first framebuffer row pair (a band's,
or each block's) as one halo ray row, instead of asking a neighbour for it.
:func:`gather_rows` assembles the ranks' shares on every rank, for tests
and presenting; it is not part of a frame.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from voxelengine_tpu_torch.config import Environment, Projection, RenderConfig
from voxelengine_tpu_torch.core.brickmap import BrickMap
from voxelengine_tpu_torch.core.exact import fdiv
from voxelengine_tpu_torch.kernels import rays as rays_kernel
from voxelengine_tpu_torch.ops.bigtrace import LineTable, trace_brickmap_hbm
from voxelengine_tpu_torch.ops.trace import TraceOut
from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_no_table
from voxelengine_tpu_torch.parallel.mesh import Mesh, all_gather, make_mesh, psum  # noqa: F401  (make_mesh re-exported)
from voxelengine_tpu_torch.render import camera as cam
from voxelengine_tpu_torch.render.frame import (
    _block_side, _is_cuda, _kernel_rays, _projection_args, block_geometry, checkerboard_pair_select, shade_pixels,
)

F32 = torch.float32


def _rays_for_pixels(cfg: RenderConfig, origin, euler, frame_number: int, px, py_r, osz):
    """Primary rays for any set of ``(px, pre-remap py)`` pixels: the
    per-shard core of :func:`~voxelengine_tpu_torch.render.frame.primary_rays`
    (the same checkerboard remap, projection and camera math).  Returns
    ``(origins, dirs, py)``.  On the card one launch of the ray-setup
    kernel's ``pixels`` entry (``kernels/rays.py``); on the CPU
    :func:`_rays_for_pixels_plain`."""
    if not _is_cuda(origin):
        return _rays_for_pixels_plain(cfg, origin, euler, frame_number, px, py_r, osz)
    origin = origin.to(F32)
    out, basis, py = rays_kernel.pixel_rays(
        euler.to(F32), origin, px, py_r, width=cfg.width, height=cfg.height, checkerboard=cfg.checkerboard,
        even_frame=frame_number % 2 == 0, **_projection_args(cfg, osz, origin.device),
    )
    return (*_kernel_rays(origin, out, basis), py)


def _rays_for_pixels_plain(cfg: RenderConfig, origin, euler, frame_number: int, px, py_r, osz):
    """:func:`_rays_for_pixels` in eager torch ops: the ``pixels`` entry's
    plain version, which the CPU runs."""
    W, H = cfg.width, cfg.height
    if cfg.checkerboard:
        py = py_r * 2 + (px % 2 == 0).to(px.dtype) + int(frame_number % 2 == 0)
    else:
        py = py_r
    u = fdiv(px.to(F32), float(W))
    v = fdiv(py.to(F32), float(H))
    fwd, up, right = cam.get_directions(euler)
    o = origin.to(F32)
    if cfg.projection is Projection.PERSPECTIVE:
        dirs = cam.ray_direction(fwd, up, right, W, H, u, v, cfg.fov_degrees)
        origins = o.expand_as(dirs)
    else:
        dirs = fwd.expand(px.shape[0], 3)
        origins = cam.ray_origin_ortho(fwd, up, right, W, H, u, v, o, osz)
    return origins, dirs, py


def replicate_world(mesh: Mesh, bm: BrickMap) -> BrickMap:
    """``bm`` on the rank's device: every rank holds the whole world."""
    return dataclasses.replace(bm, **{
        f.name: getattr(bm, f.name).to(mesh.device) for f in dataclasses.fields(bm)
        if isinstance(getattr(bm, f.name), torch.Tensor)
    })


def make_framebuffer_rows(cfg: RenderConfig, mesh: Mesh) -> torch.Tensor:
    """The rank's zeroed band of the framebuffer, ``[H / N, W, 3]``, for
    :func:`render_frame_sharded`."""
    if cfg.height % mesh.size:
        raise ValueError(f"height {cfg.height} must divide the {mesh.size}-rank mesh")
    return torch.zeros((cfg.height // mesh.size, cfg.width, 3), dtype=F32, device=mesh.device)


def gather_rows(local: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's share (the same shape on each), concatenated along the
    first axis in rank order, on every rank: the image of
    :func:`render_frame_sharded`'s bands, the ``[N, nb / N, ...]`` form of
    :func:`render_frame_cyclic`'s blocks, the whole batch of
    :func:`raytrace_sharded`'s shards.  For tests and presenting; one
    all-gather, not part of a frame."""
    return all_gather(local, mesh)


def _rows_local(cfg: RenderConfig, mesh: Mesh) -> int:
    """Pre-remap rows of a rank's band."""
    H, n = cfg.height, mesh.size
    if cfg.checkerboard and H % 2:
        raise ValueError("checkerboard sharding needs an even height")
    rows_total = H // 2 if cfg.checkerboard else H
    if H % n or rows_total % n:
        raise ValueError(f"height {H} must divide the {n}-rank mesh")
    return rows_total // n


def band_pixels(cfg: RenderConfig, mesh: Mesh, device):
    """``(px, py_r)``: the pixels (column, pre-remap row) the rank traces in
    :func:`render_frame_sharded`, in tile order within its band where
    ``cfg.tile_order``, then with checkerboarding the halo row: the row
    before the band, whose even-frame ``+2`` writes land in the band's
    first row pair (rank 0's is row -1, which writes nothing)."""
    W = cfg.width
    rows_local = _rows_local(cfg, mesh)
    bw, bh = _block_side(W), _block_side(rows_local)
    row0 = mesh.rank * rows_local
    yg, xg = torch.meshgrid(torch.arange(rows_local, device=device), torch.arange(W, device=device), indexing="ij")
    if cfg.tile_order and bw * bh > 1:
        def blk(a):
            return a.reshape(rows_local // bh, bh, W // bw, bw).permute(0, 2, 1, 3).reshape(-1)
        px, py_r = blk(xg), blk(yg) + row0
    else:
        px, py_r = xg.reshape(-1), yg.reshape(-1) + row0
    if cfg.checkerboard:
        px = torch.cat([px, torch.arange(W, device=device)])
        py_r = torch.cat([py_r, torch.full((W,), row0 - 1, dtype=py_r.dtype, device=device)])
    return px, py_r


def render_frame_sharded(
    bm: BrickMap,
    framebuffer: torch.Tensor,
    origin: torch.Tensor,
    euler: torch.Tensor,
    env: Environment,
    frame_number: int,
    cfg: RenderConfig,
    mesh: Mesh,
    lt: Optional[LineTable] = None,
    ortho_size=None,
) -> torch.Tensor:
    """Row-band frame: ``render_frame`` semantics over N ranks.

    ``framebuffer`` is the rank's band (:func:`make_framebuffer_rows`),
    updated in place and returned; the world is whole on every rank.  The
    rank renders its pre-remap rows with the single-device machinery: tile
    order within the band, :func:`~voxelengine_tpu_torch.render.frame.
    shade_pixels` (K1 with ``lt``, K4 for a dense-slot or compact world
    without one, the plain walk for CPU tensors) and the pair-select
    composite.  The checkerboard remap ``y = 2y' + (x even) + (frame
    even)`` commutes with row bands except for the even-frame ``+2`` seam,
    covered by one halo ray row: the row before the band, recomputed
    here."""
    W = cfg.width
    cb = cfg.checkerboard
    rows_local = _rows_local(cfg, mesh)
    bw, bh = _block_side(W), _block_side(rows_local)
    blocked = cfg.tile_order and bw * bh > 1
    osz = cfg.ortho_size if ortho_size is None else ortho_size
    dev = origin.device

    def unblock(a):
        rest = a.shape[1:]
        if blocked:
            a = a.reshape(rows_local // bh, W // bw, bh, bw, *rest).permute(0, 2, 1, 3, *range(4, 4 + len(rest)))
        return a.reshape(rows_local, W, *rest)

    px, py_r = band_pixels(cfg, mesh, dev)
    origins, dirs, py = _rays_for_pixels(cfg, origin, euler, frame_number, px, py_r, osz)
    color, write = shade_pixels(bm, origins, dirs, px, py, py_r, origin, env, frame_number, cfg, lt)
    if not cb:
        framebuffer.copy_(torch.where(unblock(write)[..., None], unblock(color), framebuffer))
        return framebuffer
    n_main = rows_local * W
    h_main, w_main = unblock(color[:n_main]), unblock(write[:n_main])
    halo_ok = py_r[n_main:] >= 0  # rank 0 has no row -1
    # the halo row stands in for the predecessor of the band's first row
    h_prev = torch.cat([color[n_main:][None], h_main[:-1]], dim=0)
    w_prev = torch.cat([(write[n_main:] & halo_ok)[None], w_main[:-1]], dim=0)
    return checkerboard_pair_select(framebuffer, h_main, w_main, h_prev, w_prev, frame_number)


def make_framebuffer_cyclic(cfg: RenderConfig, mesh: Mesh) -> torch.Tensor:
    """The rank's zeroed block-cyclic framebuffer ``[1, nb / N, bhf, bw,
    3]``: entry ``[0, k]`` holds the pixels of pixel block ``j = k * N +
    rank`` (blocks of :func:`~voxelengine_tpu_torch.render.frame.
    block_geometry`, ``bhf`` its framebuffer rows, ``2 * bh`` under
    checkerboarding).  :func:`gather_rows` gives JAX's global ``[N, nb / N,
    bhf, bw, 3]`` form, which :func:`cyclic_to_image` takes."""
    bw, bh, nb = block_geometry(cfg)
    if nb % mesh.size:
        raise ValueError(f"{nb} pixel blocks must divide the {mesh.size}-rank mesh")
    bhf = 2 * bh if cfg.checkerboard else bh
    return torch.zeros((1, nb // mesh.size, bhf, bw, 3), dtype=F32, device=mesh.device)


def cyclic_to_image(fb, cfg: RenderConfig) -> np.ndarray:
    """The ``[N, nb / N, bhf, bw, 3]`` block-cyclic framebuffer (a tensor
    or an array) as an ``[H, W, 3]`` numpy image, on the host: block ``j``
    is entry ``[j % N, j // N]``."""
    a = fb.detach().cpu().numpy() if isinstance(fb, torch.Tensor) else np.asarray(fb)
    n, nbl, bhf, bw, _ = a.shape
    nbx = cfg.width // bw
    flat = a.reshape(n * nbl, bhf, bw, 3)
    j = (np.arange(nbl)[None, :] * n + np.arange(n)[:, None]).reshape(-1)
    inv = np.empty(n * nbl, np.int64)
    inv[j] = np.arange(n * nbl)
    blocks = flat[inv]  # global (block row, block column) raster order
    nby = (n * nbl) // nbx
    img = blocks.reshape(nby, nbx, bhf, bw, 3).transpose(0, 2, 1, 3, 4)
    return np.ascontiguousarray(img.reshape(cfg.height, cfg.width, 3))


def cyclic_pixels(cfg: RenderConfig, mesh: Mesh, device):
    """``(px, py_r)``: the pixels the rank traces in
    :func:`render_frame_cyclic`, block after block (block ``j = k * N +
    rank``), then with checkerboarding one halo row a block: its
    predecessor pre-remap row."""
    if cfg.checkerboard and cfg.height % 2:
        raise ValueError("checkerboard cyclic sharding needs an even height")
    bw, bh, nb = block_geometry(cfg)
    n = mesh.size
    if nb % n:
        raise ValueError(f"{nb} pixel blocks must divide the {n}-rank mesh")
    j = mesh.rank + n * torch.arange(nb // n, device=device)  # the rank's global block ids
    brow, bcol = j // (cfg.width // bw), j % (cfg.width // bw)
    yy, xx = torch.meshgrid(torch.arange(bh, device=device), torch.arange(bw, device=device), indexing="ij")
    px = (bcol[:, None, None] * bw + xx[None]).reshape(-1)
    py_r = (brow[:, None, None] * bh + yy[None]).reshape(-1)
    if cfg.checkerboard:
        px = torch.cat([px, (bcol[:, None] * bw + torch.arange(bw, device=device)[None]).reshape(-1)])
        py_r = torch.cat([py_r, torch.repeat_interleave(brow * bh - 1, bw)])
    return px, py_r


def render_frame_cyclic(
    bm: BrickMap,
    framebuffer: torch.Tensor,
    origin: torch.Tensor,
    euler: torch.Tensor,
    env: Environment,
    frame_number: int,
    cfg: RenderConfig,
    mesh: Mesh,
    lt: Optional[LineTable] = None,
    ortho_size=None,
) -> torch.Tensor:
    """Block-cyclic frame: ``render_frame`` semantics with pixel block
    ``j`` on rank ``j % N``.  ``framebuffer`` is the rank's
    (:func:`make_framebuffer_cyclic`), updated in place and returned.
    Each rank still traces whole blocks, so neighbouring threads share
    table lines as on one device; the checkerboard's ``+2`` remap needs
    each block's predecessor pre-remap row, one halo ray row a block."""
    cb = cfg.checkerboard
    bw, bh, nb = block_geometry(cfg)
    nb_local = nb // mesh.size
    osz = cfg.ortho_size if ortho_size is None else ortho_size
    dev = origin.device

    fb_block = framebuffer[0]
    px, py_r = cyclic_pixels(cfg, mesh, dev)
    origins, dirs, py = _rays_for_pixels(cfg, origin, euler, frame_number, px, py_r, osz)
    color, write = shade_pixels(bm, origins, dirs, px, py, py_r, origin, env, frame_number, cfg, lt)
    n_main = nb_local * bh * bw
    h = color[:n_main].reshape(nb_local, bh, bw, 3)
    w = write[:n_main].reshape(nb_local, bh, bw)
    if not cb:
        fb_block.copy_(torch.where(w[..., None], h, fb_block))
        return framebuffer
    halo_ok = (py_r[n_main:] >= 0).reshape(nb_local, bw)
    h_prev = torch.cat([color[n_main:].reshape(nb_local, 1, bw, 3), h[:, :-1]], dim=1)
    w_prev = torch.cat([(write[n_main:].reshape(nb_local, bw) & halo_ok)[:, None], w[:, :-1]], dim=1)
    checkerboard_pair_select(
        fb_block.reshape(nb_local * bh * 2, bw, 3), h.reshape(-1, bw, 3), w.reshape(-1, bw),
        h_prev.reshape(-1, bw, 3), w_prev.reshape(-1, bw), frame_number,
    )
    return framebuffer


def raytrace_sharded(
    bm: BrickMap,
    origins: torch.Tensor,
    rays: torch.Tensor,
    mesh: Mesh,
    max_steps: int = 2048,
    lt: Optional[LineTable] = None,
) -> Tuple[TraceOut, torch.Tensor]:
    """Batch ray query sharded over the flat ray axis: rank r traces rays
    ``[r * N / n, (r + 1) * N / n)`` of the whole batch ``origins``,
    ``rays`` (``f32[N, 3]``, the same on every rank), through K1 when
    ``lt`` is given (macro levels on, as the JAX entry), else
    :func:`~voxelengine_tpu_torch.ops.trace2.trace_brickmap_no_table`.
    Returns the rank's :class:`TraceOut` shard and the mesh-wide mean step
    count: a float32 sum a rank (an int32 sum wraps at frame-scale
    batches), then :func:`psum`."""
    n_rays, n = origins.shape[0], mesh.size
    if n_rays % n:
        raise ValueError(f"{n_rays} rays must divide the {n}-rank mesh")
    k = n_rays // n
    o, r = origins[mesh.rank * k:(mesh.rank + 1) * k], rays[mesh.rank * k:(mesh.rank + 1) * k]
    if lt is not None:
        out = trace_brickmap_hbm(bm, lt, o, r, max_steps)
    else:
        out = trace_brickmap_no_table(bm, o, r, max_steps)
    tot = psum(out.steps.to(F32).sum().reshape(1), mesh)
    cnt = psum(torch.full((1,), k, dtype=torch.int32, device=o.device), mesh)
    return out, fdiv(tot, cnt.to(F32))[0]
