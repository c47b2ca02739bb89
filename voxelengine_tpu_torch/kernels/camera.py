"""Wrapper of the camera kernel (``csrc/camera.cu`` over ``csrc/camera.cuh``).

:func:`camera_basis` computes ``render/camera.py::get_directions`` for
``n`` Euler triples in one launch, with glibc's ``sinf`` and ``cosf``, as
the JAX reference's XLA:CPU computes them.  It has no TPU counterpart: the
JAX package's basis is a few XLA ops of its jitted frame.  Its plain
version is :func:`voxelengine_tpu_torch.render.camera.basis_plain`
(``core/libm.py``), which ``get_directions`` runs for a CPU tensor.
``launches`` counts its launches.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.kernels import build

launches = 0


def camera_basis(euler: torch.Tensor) -> torch.Tensor:
    """``f32[n, 9]`` rows of (-forward, -up, right) for the CUDA tensor
    ``euler`` ``f32[n, 3]`` of (pitch, yaw, roll).  Launches on the current
    stream without synchronising and raises if the launch is refused."""
    global launches
    dev = euler.device
    build.require_cuda("camera_basis", dev)
    n = euler.shape[0]
    build.check("camera_basis", "euler", euler, torch.float32, (n, 3), dev)
    out = torch.empty((n, 9), dtype=torch.float32, device=dev)
    if n:
        build.launch("camera_basis", build.load_kernel("camera").vx_camera_basis,
                     euler.data_ptr(), n, out.data_ptr(), dev=dev)
        launches += 1
    return out
