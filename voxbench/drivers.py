"""The entries a cell's window drives, one class each, chosen by the traffic
file's ``entry``:

* ``render_frame``: ``render/frame.py::render_frame`` (the bench's
  offscreen frames), in a closed loop with ``in_flight`` frames dispatched
  ahead;
* ``render_screen_present``: the app's frame, ``render/graphics.py::
  Graphics.render_screen`` through ``VoxelRaytracer3D``, then ``to_bgra8``
  and the copy into the display's host buffer (upstream's ``cudaMemcpy``,
  ``main.cu:167``), one frame at a time;
* ``raytrace``: ``engine/raytracer.py::VoxelRaytracer3D.raytrace`` of a
  batch of rays a call, calls back to back.

Each builds the world its configuration's ``world`` states in
:meth:`setup` (:func:`world_route`, :func:`build_world`), runs one step (a
frame or a call) in :meth:`step`, and keeps what the check compares: copies
of the framebuffer or the presented bytes of chosen frames, the records of
chosen calls.  The program is imported inside the methods.

The world's routes: ``bricks`` ``"compact"`` (W1 to compact indirection)
or ``"dense_slots"`` (W1 to dense slots); with ``line_table`` true the
frames and calls walk K1 through the world's line table, with false K4
(its compact or dense-slot instantiation by the bricks; a call through
K4's record entry), which has no macro levels: ``frame.macro`` must be
``"off"`` there.
"""

from __future__ import annotations

import dataclasses
import time

import torch

from voxbench import scene


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# world.bricks -> the program's builder in core/brickmap.py
BUILDERS = {"compact": "build_brickmap_terrain_compact", "dense_slots": "build_brickmap_terrain"}
MACRO = ("off", "on", "probe")


def world_route(config: dict) -> tuple:
    """``(builder, line_table)`` of the world ``config`` states; a world
    the port cannot trace raises ValueError naming the key, before any
    build."""
    w, macro = config["world"], config["frame"]["macro"]
    if w.get("bricks") not in BUILDERS:
        raise ValueError(f"world.bricks {w.get('bricks')!r}: the port builds {', '.join(map(repr, BUILDERS))}")
    if not isinstance(w.get("line_table"), bool):
        raise ValueError(f"world.line_table {w.get('line_table')!r}: true (K1 through the line table) or false (K4)")
    if macro not in MACRO:
        raise ValueError(f"frame.macro {macro!r}: the port offers {', '.join(map(repr, MACRO))}")
    if not w["line_table"] and macro != "off":
        raise ValueError(f"frame.macro {macro!r} with world.line_table false: K4 has no macro levels and "
                         "probe_use_macro needs a line table; ask for 'off'")
    return BUILDERS[w["bricks"]], w["line_table"]


def build_world(config: dict, dev: torch.device):
    """The brickmap of ``config``'s ``world``, built through W1 by the
    builder its ``bricks`` name."""
    from voxelengine_tpu_torch.core import brickmap

    w = config["world"]
    return getattr(brickmap, world_route(config)[0])(tuple(w["dims"]), w["factor"], octaves=w["octaves"], device=dev)


class Driver:
    """What every entry has: the world, the camera table, the kept outputs."""

    in_flight = 1

    def __init__(self, config: dict, traffic: dict, seed: int, device: torch.device):
        _, self.line_table = world_route(config)
        self.config, self.traffic, self.seed, self.dev = config, traffic, seed, device
        self.world = config["world"]
        self.kept = {}  # step index -> what the check compares
        self.keep_at = set()
        pos, eul, self.phase = scene.camera_table(traffic["camera"], seed)
        self.period = pos.shape[0]
        self.pos_host, self.eul_host = pos, eul
        self.pos = torch.from_numpy(pos).to(device)
        self.eul = torch.from_numpy(eul).to(device)
        self.world_build_s = 0.0

    def camera(self, g: int):
        """Host float32 ``(position, euler)`` of step ``g``."""
        i = (self.phase + g) % self.period
        return self.pos_host[i], self.eul_host[i]

    def _timed_build(self, build):
        sync(self.dev)
        t0 = time.perf_counter()
        out = build()
        sync(self.dev)
        self.world_build_s = time.perf_counter() - t0
        return out

    def _facade(self):
        """``VoxelRaytracer3D(line_table=...)`` holding the built world: its
        frames and calls through K1 with the line table, through K4
        without."""
        from voxelengine_tpu_torch.engine.raytracer import VoxelRaytracer3D

        rt = VoxelRaytracer3D(line_table=self.line_table)
        rt.upload_world(build_world(self.config, self.dev))
        return rt

    def keep_last(self, g: int) -> None:
        """Keep step ``g``'s output, the window's last, for the check."""
        self.kept.setdefault(g, self.last)

    def release(self) -> None:
        """Drop the program's state; the kept outputs stay."""


def _render_config(config: dict, shading: dict, **extra):
    from voxelengine_tpu_torch.config import RenderConfig

    f = config["frame"]
    return RenderConfig(width=f["width"], height=f["height"], fov_degrees=f["fov"], checkerboard=f["checkerboard"],
                        tile_order=f["tile_order"], max_steps=f["max_steps"], shadow_rays=shading["shadows"],
                        ao_samples=shading["ao_samples"], reflections=shading["reflections"], **extra)


class RenderFrame(Driver):
    """``render_frame`` over the W1 world, with its line table or without."""

    def setup(self) -> None:
        from voxelengine_tpu_torch.config import Environment
        from voxelengine_tpu_torch.ops.bigtrace import make_line_table, materialize_brick_lines
        from voxelengine_tpu_torch.render.frame import make_framebuffer, primary_rays, probe_use_macro

        self.in_flight = int(self.traffic["loop"]["in_flight"])

        def build():
            bm = build_world(self.config, self.dev)
            return bm, materialize_brick_lines(bm, make_line_table(bm)) if self.line_table else None

        self.bm, self.lt = self._timed_build(build)
        self.cfg = _render_config(self.config, self.traffic["shading"])
        if self.config["frame"]["macro"] == "probe":
            # probe_use_macro on the first frame's rays: the macro levels
            # only where some skip fires (results are the same either way)
            o, d, *_ = primary_rays(self.cfg, self.pos[self.phase], self.eul[self.phase], 0)
            self.cfg = dataclasses.replace(self.cfg, trace_use_macro=probe_use_macro(self.bm, self.lt, o, d,
                                                                                     self.cfg))
        else:
            self.cfg = dataclasses.replace(self.cfg, trace_use_macro=self.config["frame"]["macro"] == "on")
        self.env = Environment.default(self.dev)
        self.fb = make_framebuffer(self.cfg, self.dev)

    def step(self, g: int, spans) -> None:
        from voxelengine_tpu_torch.render.frame import render_frame

        i = (self.phase + g) % self.period
        with spans("enqueue"):
            render_frame(self.bm, self.fb, self.pos[i], self.eul[i], self.env, g, self.cfg, self.lt)
        if g in self.keep_at:
            self.kept[g] = self.fb.clone()
        self.last = self.fb  # the live framebuffer: after the window nothing writes it

    def release(self) -> None:
        self.bm = self.lt = self.fb = None


class RenderScreenPresent(Driver):
    """The app's frame: ``Graphics.render_screen``, ``to_bgra8``, the copy
    into the display's buffer."""

    def setup(self) -> None:
        from voxelengine_tpu_torch.render.graphics import Graphics

        f, sh = self.config["frame"], self.traffic["shading"]
        self.rt = self._timed_build(self._facade)
        self.g = Graphics(width=f["width"], height=f["height"], device=self.dev, checkerboard=f["checkerboard"],
                          tile_order=f["tile_order"], max_steps=f["max_steps"], shadow_rays=sh["shadows"],
                          ao_samples=sh["ao_samples"], reflections=sh["reflections"],
                          trace_use_macro=f["macro"] == "on")
        self.g.set_fov(f["fov"])
        self.cfg = self.g.config
        # the display's pixels: one host buffer, written every frame, as
        # upstream's cudaMemcpy writes its window's (main.cu:167)
        self.pixels = torch.zeros((f["height"], f["width"], 4), dtype=torch.uint8)

    def step(self, g: int, spans) -> None:
        i = (self.phase + g) % self.period
        with spans("enqueue"):
            self.g.render_screen(self.rt, self.pos[i], self.eul[i])
        with spans("present"):
            self.pixels.copy_(self.g.framebuffer_bgra8())
        if g in self.keep_at:
            self.kept[g] = self.pixels.clone()
        self.last = self.pixels  # after the window nothing writes it

    def release(self) -> None:
        self.rt = self.g = None


class Raytrace(Driver):
    """``VoxelRaytracer3D.raytrace`` of a batch a call, origins in a box
    around the fly-through's position at the call."""

    def setup(self) -> None:
        self.rt = self._timed_build(self._facade)
        self.query = self.traffic["query"]
        self.offsets, self.dirs = scene.query_pool(self.query, self.seed, self.dev)
        self.max_steps = self.config["frame"]["max_steps"]

    def rays(self, g: int):
        """``(origins, dirs)`` of call ``g`` on the device."""
        i = (self.phase + g) % self.period
        b = g % self.offsets.shape[0]
        return self.pos[i] + self.offsets[b], self.dirs[b]

    def step(self, g: int, spans) -> None:
        o, d = self.rays(g)
        with spans("call"):
            res = self.rt.raytrace(o, d, self.max_steps)
        if g in self.keep_at:
            self.kept[g] = res
        self.last = res

    def release(self) -> None:
        self.rt = None


DRIVERS = {"render_frame": RenderFrame, "render_screen_present": RenderScreenPresent, "raytrace": Raytrace}
