"""Stateful render facade: counterpart of ``voxelengine_tpu/render/graphics.py``
(``GPUDDA::Graphics``, ``Renderer.cuh:39-55``).

    g = Graphics(width=1280, height=720)
    g.set_environment(light_direction, light_color, ambient_color)
    fb = g.render_screen(raytracer, origin, euler)

The framebuffer, environment and ortho zoom live on ``device`` (the card
unless the caller names another), which must be the world's.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from voxelengine_tpu_torch.config import DebugView, Environment, Projection, RenderConfig, default_device
from voxelengine_tpu_torch.core.exact import dot3, sqrt_rn
from voxelengine_tpu_torch.engine.raytracer import VoxelRaytracer3D
from voxelengine_tpu_torch.render.camera import get_directions  # re-export (Renderer.cu:27)
from voxelengine_tpu_torch.render.frame import make_framebuffer, render_frame, to_bgra8

__all__ = ["Graphics", "get_directions"]

F32 = torch.float32


class Graphics:
    """Render state and the per-frame dispatch (``Renderer.cu:278-328``)."""

    def __init__(self, width: int = 1280, height: int = 720, device=default_device(), **cfg_kwargs):
        self._dev = torch.device(device)
        self._cfg = RenderConfig(width=width, height=height, **cfg_kwargs)
        self._env = Environment.default(self._dev)
        self._fb = make_framebuffer(self._cfg, self._dev)
        self._frame = 0
        self._ortho = None  # a [2] tensor once set; cfg.ortho_size until then

    # -- setters (Renderer.cu:278-303) --------------------------------------

    def set_environment(self, light_direction, light_color, ambient_color) -> None:
        d = torch.as_tensor(light_direction, dtype=F32, device=self._dev)
        self._env = Environment(
            light_direction=d / sqrt_rn(dot3(d, d)),
            light_color=torch.as_tensor(light_color, dtype=F32, device=self._dev),
            ambient_color=torch.as_tensor(ambient_color, dtype=F32, device=self._dev),
        )

    def set_fov(self, fov_degrees: float) -> None:
        self._cfg = dataclasses.replace(self._cfg, fov_degrees=float(fov_degrees))

    def set_ortho_window_size(self, size: Tuple[float, float]) -> None:
        # a tensor argument of the frame, as JAX's traced zoom
        self._ortho = torch.tensor([float(size[0]), float(size[1])], dtype=F32).to(self._dev)

    def set_projection(self, projection: Projection) -> None:
        self._cfg = dataclasses.replace(self._cfg, projection=projection)

    def set_debug_view(self, view: DebugView) -> None:
        self._cfg = dataclasses.replace(self._cfg, debug_view=view)

    @property
    def config(self) -> RenderConfig:
        return self._cfg

    @property
    def environment(self) -> Environment:
        return self._env

    # -- per-frame dispatch (Renderer.cu:305-328) ---------------------------

    def render_screen(self, rt: VoxelRaytracer3D, origin, euler) -> torch.Tensor:
        """Render one frame into the persistent framebuffer through the
        raytracer's line table where it has one, and return it (RGB f32);
        then count the frame (``hFrameInfo.FrameNumber++``, ``Renderer.cu:322``)."""
        render_frame(
            rt.world, self._fb, torch.as_tensor(origin, dtype=F32, device=self._dev),
            torch.as_tensor(euler, dtype=F32, device=self._dev), self._env, self._frame, self._cfg,
            lt=rt.line_table, ortho_size=self._ortho,
        )
        self._frame += 1
        return self._fb

    def framebuffer_bgra8(self) -> torch.Tensor:
        """BGRA8888 bytes of the current framebuffer (the display sink's format)."""
        return to_bgra8(self._fb)
