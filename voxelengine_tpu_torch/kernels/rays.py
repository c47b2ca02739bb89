"""Wrapper of the ray-setup kernel (``csrc/rays.cu`` over ``csrc/rays.cuh``).

:func:`frame_rays` computes ``render/frame.py::primary_rays`` in one
launch, the camera basis included; :func:`pixel_rays` the same rays for
given pixels (``parallel/sharded.py::_rays_for_pixels``).  It has no TPU
counterpart: the JAX package's ray setup is XLA ops of its jitted frame.
Its plain version is ``render/frame.py::primary_rays_plain`` (and
``parallel/sharded.py::_rays_for_pixels_plain``), which the CPU runs.
Euler angles, origin and a tensor window stay on the card: no call reads
them on the host.  ``launches`` counts the launches of both entries.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.kernels import build

F32, I64 = torch.float32, torch.int64
launches = 0


def _camera(kernel: str, euler, origin, window):
    """``(device, window pointer or 0)``, checked: ``euler`` and ``origin``
    ``f32[3]`` on one CUDA device, ``window`` an ``f32[2]`` tensor there or
    ``None``."""
    dev = origin.device
    build.require_cuda(kernel, dev)
    build.check(kernel, "euler", euler, F32, (3,), dev)
    build.check(kernel, "origin", origin, F32, (3,), dev)
    if window is None:
        return dev, 0
    build.check(kernel, "window", window, F32, (2,), dev)
    return dev, window.data_ptr()


def _launch(kernel: str, fn, *args, dev) -> None:
    """Launch through ``build.launch`` and count it."""
    global launches
    build.launch(kernel, fn, *args, dev=dev)
    launches += 1


def frame_rays(euler: torch.Tensor, origin: torch.Tensor, *, n: int, width: int, height: int, tile: tuple,
               checkerboard: bool, even_frame: bool, ortho: bool, a: float, b: float, window=None, block_perm=None):
    """A frame's ``n`` rays: ``(rows f32[n, 3], basis, px, py, py_r)``, the
    rows directions (perspective) or origins (``ortho``), ``basis`` the
    ``f32[9]`` (fwd, up, right) for ``ortho`` (else ``None``), the pixel
    coordinates ``int64[n]``.  ``tile``: ``(bw, bh)`` of the tile order's
    pixel blocks (``(width, 1)``: row-major), ``block_perm`` their order
    (``int64``, or ``None``).  ``a``, ``b``: ``scale_x`` and ``scale_y``,
    or the orthographic window unless ``window`` (an ``f32[2]`` tensor)
    gives it.  Launches on the current stream without synchronising and
    raises if the launch is refused."""
    dev, win = _camera("rays_frame", euler, origin, window)
    perm = 0
    if block_perm is not None:
        build.check("rays_frame", "block_perm", block_perm, I64, (n // (tile[0] * tile[1]),), dev)
        perm = block_perm.data_ptr()
    rows = torch.empty((n, 3), dtype=F32, device=dev)
    basis = torch.empty(9, dtype=F32, device=dev) if ortho else None
    pix = torch.empty((3, n), dtype=I64, device=dev)  # px, py, py_r: one allocation
    if n:
        p = pix.data_ptr()
        _launch("rays_frame", build.load_kernel("rays").vx_rays_frame, euler.data_ptr(), origin.data_ptr(), win, perm,
                n, width, height, tile[0], tile[1], int(checkerboard), int(even_frame), int(ortho), a, b,
                0 if basis is None else basis.data_ptr(), rows.data_ptr(), p, p + 8 * n, p + 16 * n, dev=dev)
    return rows, basis, pix[0], pix[1], pix[2]


def pixel_rays(euler: torch.Tensor, origin: torch.Tensor, px: torch.Tensor, py_r: torch.Tensor, *, width: int,
               height: int, checkerboard: bool, even_frame: bool, ortho: bool, a: float, b: float, window=None):
    """:func:`frame_rays` for given pixels ``px`` and pre-remap rows
    ``py_r`` (``int64[n]``): ``(rows, basis, py)``."""
    dev, win = _camera("rays_pixels", euler, origin, window)
    n = px.shape[0]
    build.check("rays_pixels", "px", px, I64, (n,), dev)
    build.check("rays_pixels", "py_r", py_r, I64, (n,), dev)
    rows = torch.empty((n, 3), dtype=F32, device=dev)
    basis = torch.empty(9, dtype=F32, device=dev) if ortho else None
    py = torch.empty(n, dtype=I64, device=dev)
    if n:
        _launch("rays_pixels", build.load_kernel("rays").vx_rays_pixels, euler.data_ptr(), origin.data_ptr(), win,
                px.data_ptr(), py_r.data_ptr(), n, width, height, int(checkerboard), int(even_frame), int(ortho), a, b,
                0 if basis is None else basis.data_ptr(), rows.data_ptr(), py.data_ptr(), dev=dev)
    return rows, basis, py
