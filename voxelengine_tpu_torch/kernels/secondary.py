"""Wrapper of the secondary-ray kernels around a caller's tracer
(``csrc/secondary.cu`` over ``csrc/secondary.cuh``).

:func:`secondary_build` writes a kind's shadow, reflection or AO rays from
the primary trace in one launch; the caller traces them with its own tracer
(a z-sharded world's, ``parallel/distributed.py``); for AO
:func:`secondary_reduce` turns the tracer's results into the AO factor in
one launch (shading reads a shadow's or a reflection's trace as it is).  They
have no TPU kernel: the JAX package builds and reduces these rays with XLA
ops around its tracer (``voxelengine_tpu/render/frame.py:245-293,
378-420``).  Their plain versions are
:func:`voxelengine_tpu_torch.ops.secondary.secondary_rays_plain` and
:func:`~voxelengine_tpu_torch.ops.secondary.secondary_reduce_plain`.
``build_launches`` and ``reduce_launches`` count their launches.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.kernels import build

build_launches = reduce_launches = 0


def ray_count(kind: str, n: int, ao_samples: int) -> int:
    """The rays a kind traces for ``n`` primary rays: ``n``, or ``n *
    ao_samples`` for AO (sample-major: sample ``s`` of primary ray ``i`` is
    ray ``s * n + i``)."""
    return n * ao_samples if kind == "ao" else n


def secondary_build(kind: str, position, normal, **inputs):
    """A kind's secondary rays of N primary rays on the card, one thread a
    ray: ``(origins, dirs)``, ``f32[M, 3]`` each (:func:`ray_count`'s M
    and order).  ``position`` and ``normal`` are the primary trace's;
    ``inputs`` the kind's (``light``; ``dirs``; ``px``, ``py``, ``width``,
    ``frame_number``, ``ao_samples``: ``build.secondary_inputs``).
    Launches on the current stream without synchronising and raises if the
    launch is refused."""
    global build_launches
    dev, n, head = build.secondary_inputs("secondary_build", kind, position, normal, **inputs)
    m = ray_count(kind, n, head[-1])
    if m >= 2**31:
        raise ValueError(f"secondary_build: {m} rays exceed the kernel's int32 ray index")
    origins = torch.empty((m, 3), dtype=torch.float32, device=dev)
    dirs = torch.empty((m, 3), dtype=torch.float32, device=dev)
    if m:
        build.launch("secondary_build", build.load_kernel("secondary").vx_secondary_build, *build.pointers(head), n,
                     origins.data_ptr(), dirs.data_ptr(), dev=dev)
        build_launches += 1
    return origins, dirs


def secondary_reduce(position, hit, hit_position, *, ao_samples: int):
    """AO's factor ``f32[N]`` on the card, one thread a pixel: the falloffs
    of the caller's trace of :func:`secondary_build`'s AO rays (``hit``
    bool ``[M]``, ``hit_position`` ``f32[M, 3]``, contiguous, ``M = N *
    ao_samples``) from the primary trace's ``position`` (``f32[N, 3]``),
    summed in sample order, over ``ao_samples``.  A shadow or a reflection
    has no reduce: what shading reads of it is the trace's own.  One launch
    on the current stream, without synchronising."""
    global reduce_launches
    dev = position.device
    build.require_cuda("secondary_reduce", dev)
    if ao_samples < 1:
        raise ValueError(f"secondary_reduce: AO needs ao_samples >= 1, got {ao_samples}")
    n = position.shape[0]
    build.check("secondary_reduce", "position", position, torch.float32, (n, 3), dev)
    m = ray_count("ao", n, ao_samples)
    build.check("secondary_reduce", "trace hit", hit, torch.bool, (m,), dev)
    build.check("secondary_reduce", "trace position", hit_position, torch.float32, (m, 3), dev)
    ao = torch.empty((n,), dtype=torch.float32, device=dev)
    if n:
        build.launch("secondary_reduce", build.load_kernel("secondary").vx_secondary_reduce, position.data_ptr(),
                     ao_samples, n, hit.data_ptr(), hit_position.data_ptr(), ao.data_ptr(), dev=dev)
        reduce_launches += 1
    return ao
