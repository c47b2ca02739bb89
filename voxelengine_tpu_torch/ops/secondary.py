"""The shading's secondary rays: shadows, one-bounce reflections and
hemisphere AO.

Counterpart of the secondary rays of ``voxelengine_tpu/render/frame.py``
(``:245-293``, ``:378-420``), which XLA fuses around the Pallas K1 in the
jitted frame.  A frame traces up to three *kinds* of them from its primary
trace (:func:`frame_kinds`): the shadow rays toward the light, the mirror
bounce, and ``cfg.ao_samples`` 8-step occlusion rays a pixel reduced to one
AO factor.

On the card each kind is one launch of K1's or K4's secondary entry
(``csrc/secondary.cuh``; ``ops/bigtrace.py::trace_secondary_hbm``,
``ops/trace2.py::trace_secondary_no_table``), which builds the rays, walks
them and keeps what shading reads.  A caller with a tracer of its own (the
z-sharded frame's) takes :func:`secondary_traced`: on the card one launch
builds the kind's rays (``kernels/secondary.py``), the tracer traces them
in one call (AO's samples as one batch) and for AO one launch reduces its
results.  :func:`secondary_plain` is the plain version of both, in eager
torch over any tracer: :func:`secondary_rays_plain`, the tracer (once a
sample for AO, as the JAX frame traces them) and
:func:`secondary_reduce_plain`; the CPU runs these.
"""

from __future__ import annotations

import torch

from voxelengine_tpu_torch.config import DebugView, Environment, RenderConfig
from voxelengine_tpu_torch.core.exact import dot3, fdiv, sqrt_rn
from voxelengine_tpu_torch.kernels.build import SECONDARY_KINDS
from voxelengine_tpu_torch.ops.noise import random_float
from voxelengine_tpu_torch.ops.trace import TraceOut
from voxelengine_tpu_torch.render.shading import reflect

F32 = torch.float32
KINDS = SECONDARY_KINDS  # ("shadow", "reflection", "ao")
AO_STEPS = 8  # each AO ray's step budget


def frame_kinds(cfg: RenderConfig) -> tuple:
    """The kinds a frame of ``cfg`` traces, in the order it traces them:
    shadows in every view (the STEPS view counts their steps), reflections
    and AO in the SHADED view only."""
    shaded = cfg.debug_view is DebugView.SHADED
    wanted = {"shadow": cfg.shadow_rays, "reflection": shaded and cfg.reflections,
              "ao": shaded and cfg.ao_samples > 0}
    return tuple(k for k in KINDS if wanted[k])


def walk_steps(kind: str, cfg: RenderConfig) -> int:
    """A kind's step budget: ``cfg.max_steps``, or 8 for AO."""
    return AO_STEPS if kind == "ao" else cfg.max_steps


def norm3(v: torch.Tensor) -> torch.Tensor:
    """``|v|`` over the last axis, as ``jnp.linalg.norm`` rounds it."""
    return sqrt_rn(dot3(v, v))


def _ao_direction(seed, s: int, normal, frame_number: int) -> torch.Tensor:
    """AO sample ``s``'s directions (the reference's disabled scaffolding
    made to work, ``Renderer.cu:120-165``): the noise hash of the pixel
    seed, sample and frame, normalized, flipped into the hemisphere of the
    shading ``normal`` (the trace's negated)."""
    si = seed + s * 1000 + (frame_number + 1) * 7919
    sd = torch.stack(
        [random_float(si) * 2.0 - 1.0, random_float(si * 10) * 2.0 - 1.0, random_float(si * 100) * 2.0 - 1.0],
        dim=-1,
    )
    sd = sd / norm3(sd)[:, None]
    below = dot3(sd, normal) < 0.0
    return torch.where(below[:, None], reflect(sd, normal), sd)


def secondary_rays_plain(kind: str, out: TraceOut, dirs, px, py, env: Environment, frame_number: int,
                         cfg: RenderConfig):
    """A kind's rays of the primary trace ``out`` in eager torch: ``(origins,
    dirs)``, ``f32[M, 3]`` each, the plain version of
    ``kernels/secondary.py::secondary_build``.  Shadow: from position + L *
    0.01 toward the light L (one broadcast row); reflection: the mirror
    bounce of the raw direction ``dirs`` from position + n * 0.01 (``n``
    the shading normal); AO: ``cfg.ao_samples`` hemisphere directions a
    pixel (seeded by ``px``, ``py`` and the frame), sample-major (ray ``s *
    N + i`` is sample ``s`` of primary ray ``i``), from position + n *
    0.01."""
    normal = -out.normal  # Renderer.cu:212
    if kind == "shadow":
        L = env.light_direction
        return out.position + L * 0.01, L.expand_as(normal)
    if kind == "reflection":
        return out.position + normal * 0.01, reflect(dirs, normal)
    if kind == "ao":
        # int32 seeds wrap as in JAX: int64 here, of which random_float's
        # hash reads the low 32 bits
        seed = py.to(torch.int64) * cfg.width + px.to(torch.int64)
        sd = [_ao_direction(seed, s, normal, frame_number) for s in range(cfg.ao_samples)]
        return (out.position + normal * 0.01).repeat(cfg.ao_samples, 1), torch.cat(sd)
    raise ValueError(f"secondary kind must be one of {KINDS}, got {kind!r}")


def secondary_reduce_plain(kind: str, res: TraceOut, out: TraceOut, cfg: RenderConfig):
    """What shading reads of a kind, from the trace ``res`` of
    :func:`secondary_rays_plain`'s rays, in eager torch.  Shadow ``(hit,
    steps)``, reflection ``(hit, position, normal)``: the trace's own; AO
    the factor ``f32[N]``: each sample's distance falloff on a hit (1 on a
    miss), summed in sample order, over ``cfg.ao_samples``, the plain
    version of ``kernels/secondary.py::secondary_reduce``."""
    if kind == "shadow":
        return res.hit, res.steps
    if kind == "reflection":
        return res.hit, res.position, res.normal
    if kind != "ao":
        raise ValueError(f"secondary kind must be one of {KINDS}, got {kind!r}")
    n = out.position.shape[0]
    occ = torch.zeros(n, dtype=F32, device=out.position.device)
    for s in range(cfg.ao_samples):
        hit, pos = res.hit[s * n:(s + 1) * n], res.position[s * n:(s + 1) * n]
        dist = norm3(pos - out.position)
        falloff = 1.0 - torch.clamp_max(fdiv(1.0, torch.clamp_min(dist * 10.0, 1e-6)), 1.0)
        occ = occ + torch.where(hit, falloff, 1.0)
    return fdiv(occ, float(cfg.ao_samples))


def secondary_plain(kind: str, trace, out: TraceOut, dirs, px, py, env: Environment, frame_number: int,
                    cfg: RenderConfig):
    """One kind of secondary rays of the primary trace ``out`` in eager
    torch, every trace through ``trace(origins, dirs, max_steps) ->
    TraceOut``: the plain version of the secondary entries and of
    :func:`secondary_traced`.  :func:`secondary_rays_plain`, the trace
    (one call a sample for AO), :func:`secondary_reduce_plain`.  Returns
    the kind's results, what shading reads: shadow ``(hit, steps)``,
    reflection ``(hit, position, normal)``, AO the factor ``f32[N]``.
    ``dirs`` are the primary rays' raw directions, ``px``, ``py`` their
    final pixels."""
    origins, rays = secondary_rays_plain(kind, out, dirs, px, py, env, frame_number, cfg)
    steps = walk_steps(kind, cfg)
    if kind != "ao":
        return secondary_reduce_plain(kind, trace(origins, rays, steps), out, cfg)
    n = out.position.shape[0]
    parts = [trace(origins[s * n:(s + 1) * n], rays[s * n:(s + 1) * n], steps) for s in range(cfg.ao_samples)]
    return secondary_reduce_plain(kind, TraceOut(*(torch.cat(f) for f in zip(*parts))), out, cfg)


def _is_cuda(t: torch.Tensor) -> bool:
    """Whether a primary trace on ``t``'s device takes the secondary kernels
    (one place, so a test can route a CPU call as a card call)."""
    return t.is_cuda


def secondary_traced(kind: str, trace, out: TraceOut, dirs, px, py, env: Environment, frame_number: int,
                     cfg: RenderConfig):
    """One kind of secondary rays of the primary trace ``out`` through a
    caller's ``trace(origins, dirs, max_steps) -> TraceOut``.  On the card:
    one launch of ``kernels/secondary.py::secondary_build``, one call of
    the tracer (AO's ``cfg.ao_samples`` samples as one batch, at
    :func:`walk_steps`) and for AO one launch of ``secondary_reduce``; a
    shadow's or a reflection's results are the tracer's own.  On the CPU:
    :func:`secondary_plain`.  The tracer must treat each ray alone (every
    tracer of the package does: a ray's result does not depend on the
    batch it comes in), so both give :func:`secondary_plain`'s results."""
    if not _is_cuda(out.position):
        return secondary_plain(kind, trace, out, dirs, px, py, env, frame_number, cfg)
    from voxelengine_tpu_torch.kernels import secondary as sk

    origins, rays = sk.secondary_build(kind, out.position, out.normal, light=env.light_direction, dirs=dirs.to(F32),
                                       px=px, py=py, width=cfg.width, frame_number=frame_number,
                                       ao_samples=cfg.ao_samples)
    res = TraceOut(*(t.contiguous() for t in trace(origins, rays, walk_steps(kind, cfg))))
    if kind != "ao":
        return secondary_reduce_plain(kind, res, out, cfg)  # the trace's own fields
    return sk.secondary_reduce(out.position, res.hit, res.position, ao_samples=cfg.ao_samples)
