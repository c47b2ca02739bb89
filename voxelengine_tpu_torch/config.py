"""Runtime configuration for the PyTorch port.

Counterpart of :mod:`voxelengine_tpu.config`.  Same enums, constants and
field names; ``Environment`` holds torch tensors.  Entry points that make
tensors take a ``device`` that defaults to :func:`default_device`, the
card; the CPU is used only when the caller names it.

Left out of :class:`RenderConfig` on purpose: the knobs that only tune the
TPU kernel's VMEM line cache or the XLA staging (``trace_tile``,
``trace_slots``, ``trace_shortlist``, ``staged_trace``, ``stage_iters``,
``tail_frac``, ``stage_schedule``).  The Hopper traversal has no line cache
and the XLA staging has no counterpart, so they have nothing to tune here.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Tuple

import numpy as np
import torch

from voxelengine_tpu_torch.core.exact import fdiv

FLT_EPS_DDA = 1e-6  # VolumeRaytracer.cuh:20
MAX_STEPS = 2048  # VolumeRaytracer.cuh:235


def default_device() -> torch.device:
    """The device entry points use unless the caller names one: the card.
    Nothing is probed; without a card the first allocation there raises."""
    return torch.device("cuda")


class DebugView(enum.Enum):
    """Render modes (``Renderer.cu:215-252``)."""

    SHADED = 0
    DEBUG = 1
    NORMALS = 2
    DEPTH = 3
    STEPS = 4


class Projection(enum.Enum):
    PERSPECTIVE = 0  # Renderer.cu:44-59
    ORTHOGRAPHIC = 1  # Renderer.cu:61-70


@dataclasses.dataclass(frozen=True)
class Environment:
    """Lighting environment (``Renderer.cuh:33-37``): three f32[3] tensors."""

    light_direction: torch.Tensor  # normalized, world space
    light_color: torch.Tensor
    ambient_color: torch.Tensor

    @staticmethod
    def default(device=default_device()) -> "Environment":
        """The VoxelApp demo environment (``main.cu:58-63``)."""
        d = torch.tensor([1.0, 1.0, 1.0], dtype=torch.float32, device=device)
        return Environment(
            light_direction=fdiv(d, float(np.sqrt(np.float32(3.0)))),  # d / |d|
            light_color=torch.tensor([2.0, 2.0, 2.0], dtype=torch.float32, device=device),
            ambient_color=torch.tensor([0.5, 0.5, 0.5], dtype=torch.float32, device=device),
        )


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static per-renderer configuration."""

    width: int = 1280  # main.cu:15
    height: int = 720  # main.cu:16
    fov_degrees: float = 90.0  # main.cu:64
    projection: Projection = Projection.PERSPECTIVE
    ortho_size: Tuple[float, float] = (10.0, 10.0)  # main.cu:65
    checkerboard: bool = True  # Renderer.cu:5
    debug_view: DebugView = DebugView.SHADED
    max_steps: int = MAX_STEPS
    # secondary rays: present in the reference but off by default there
    # (Renderer.cu:102,123); reflections (one mirror bounce, lerped in by
    # reflectivity) go beyond the reference
    shadow_rays: bool = False
    ao_samples: int = 0
    reflections: bool = False
    reflectivity: float = 0.35
    crosshair: bool = True  # Renderer.cu:260-268
    debug_pos_mod: float = 128.0  # Renderer.cu:217-222
    # the line-table traversal's macro skip levels (L1/L2/L3); a renderer
    # can turn them off where render.frame.probe_use_macro sees no skip
    # (results are the same either way)
    trace_use_macro: bool = True
    # order rays as ~32x32 pixel blocks so neighbouring threads share
    # table lines in L1/L2
    tile_order: bool = False
    # staged line-table trace (ops.bigtrace.trace_brickmap_hbm_staged):
    # first-pass step budget (0 = one launch at max_steps) and the tail
    # buffer's divisor; never truncates
    trace_stage_steps: int = 0
    trace_tail_frac: int = 8
