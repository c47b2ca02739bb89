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
them and keeps what shading reads.  :func:`secondary_plain` is their plain
version, in eager torch over any tracer: the CPU runs it, and so does a
caller with a tracer of its own (the z-sharded frame's).
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


def ambient_occlusion(trace, position, normal, px, py, frame_number: int, cfg: RenderConfig) -> torch.Tensor:
    """Hemisphere-sampled AO (the reference's disabled scaffolding made to
    work, ``Renderer.cu:120-165``): ``cfg.ao_samples`` 8-step occlusion
    rays through ``trace(origins, dirs, max_steps)`` with distance falloff,
    seeded per pixel and frame through the noise hash.  ``normal`` is the
    shading's (the trace's negated)."""
    # int32 seeds wrap as in JAX: int64 here, of which random_float's hash
    # reads the low 32 bits
    seed = py.to(torch.int64) * cfg.width + px.to(torch.int64)
    occ = torch.zeros(position.shape[0], dtype=F32, device=position.device)
    for i in range(cfg.ao_samples):
        si = seed + i * 1000 + (frame_number + 1) * 7919
        sd = torch.stack(
            [random_float(si) * 2.0 - 1.0, random_float(si * 10) * 2.0 - 1.0, random_float(si * 100) * 2.0 - 1.0],
            dim=-1,
        )
        sd = sd / norm3(sd)[:, None]
        below = dot3(sd, normal) < 0.0
        sd = torch.where(below[:, None], reflect(sd, normal), sd)
        res = trace(position + normal * 0.01, sd, AO_STEPS)
        dist = norm3(res.position - position)
        falloff = 1.0 - torch.clamp_max(fdiv(1.0, torch.clamp_min(dist * 10.0, 1e-6)), 1.0)
        occ = occ + torch.where(res.hit, falloff, 1.0)
    return fdiv(occ, float(cfg.ao_samples))


def secondary_plain(kind: str, trace, out: TraceOut, dirs, px, py, env: Environment, frame_number: int,
                    cfg: RenderConfig):
    """One kind of secondary rays of the primary trace ``out`` in eager
    torch, every trace through ``trace(origins, dirs, max_steps) ->
    TraceOut``: the plain version of the secondary entries.  Returns the
    kind's results, what shading reads: shadow ``(hit, steps)``, reflection
    ``(hit, position, normal)``, AO the factor ``f32[N]``.  ``dirs`` are
    the primary rays' raw directions, ``px``, ``py`` their final pixels."""
    normal = -out.normal  # Renderer.cu:212
    if kind == "shadow":
        L = env.light_direction
        res = trace(out.position + L * 0.01, L.expand_as(normal), cfg.max_steps)
        return res.hit, res.steps
    if kind == "reflection":
        res = trace(out.position + normal * 0.01, reflect(dirs, normal), cfg.max_steps)
        return res.hit, res.position, res.normal
    if kind == "ao":
        return ambient_occlusion(trace, out.position, normal, px, py, frame_number, cfg)
    raise ValueError(f"secondary kind must be one of {KINDS}, got {kind!r}")
