"""VoxelApp on the PyTorch port: the interactive 3D engine demo.

Counterpart of the JAX package's ``apps/voxel_app.py`` (the reference's
``VoxelApp/main.cu``), with the same flags and defaults: generate a 1024^3
fBm terrain world, build the factor-32 brickmap, then run a fly-camera
render loop with WASD+QE movement ('b' toggles a x10 boost), presenting
frames through the frame sink and reporting an EMA "Avg FPS" like the
reference's window title (``main.cu:170-194``).  'f' breaks and 'g' places
the voxel under the crosshair.

    python -m voxelengine_tpu_torch.apps.voxel_app --frames 8 --shadows --ao 4 --reflections

Where the work goes (``--device``, default the card):

* default: ``generate_or_load`` (cached under ``.worlds_cache``) of a world
  built by ``build_brickmap_terrain`` (W1 on the card), uploaded with its
  line table; frames and the crosshair ray through K1;
* ``--bench-world full``: the 8192x512x8192 bench world from
  ``.world_cache``, built through W1 when the cache is missing;
  ``--bench-world huge``: the 16384x512x16384 world's cache with its brick
  words relaid into lines on the host (``load_world_host_bricks``);
* ``--dense``: a dense ``generate_world`` grid and ``render_frame_dense``
  (K2);
* ``--xla-trace``: no line table, so frames and the crosshair ray go
  through K4 on the dense-slot world.

Headless: with no tty it runs a scripted fly-through (``--frames N``, 240
by default) and exits; view the live frame in ``frames/latest.ppm``.  The
last line gives the frames' mean time on the host clock, with the device
synchronised at the end.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional

import numpy as np
import torch

from voxelengine_tpu_torch.config import DebugView, Environment, Projection, RenderConfig, default_device
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain, build_brickmap_terrain_compact
from voxelengine_tpu_torch.engine.raytracer import VoxelRaytracer3D
from voxelengine_tpu_torch.io.checkpoint import generate_or_load, line_table_or_build, memo_json
from voxelengine_tpu_torch.ops.bigtrace import materialize_brick_lines
from voxelengine_tpu_torch.render.camera import get_directions_np
from voxelengine_tpu_torch.render.frame import (
    make_framebuffer,
    primary_rays,
    probe_use_macro,
    render_frame,
    render_frame_dense,
    to_bgra8,
)
from voxelengine_tpu_torch.runtime.display import Renderer
from voxelengine_tpu_torch.runtime.input import best_input
from voxelengine_tpu_torch.utils.profiling import FrameTimer, timed


@dataclasses.dataclass
class AppRun:
    """What a run leaves: the engine (None with ``--dense``), the dense grid
    (``--dense`` only), the framebuffer, the frames rendered and their wall
    time in seconds (host clock, device synchronised at the end)."""

    rt: Optional[VoxelRaytracer3D]
    grid: Optional[BitGrid]
    framebuffer: torch.Tensor
    frames: int
    seconds: float


BENCH_DIMS = {"full": (8192, 512, 8192), "huge": (16384, 512, 16384)}
MOUSE_SENS = 0.004  # rad/px, the reference's drag sensitivity (main.cu:155-156)


def build_world(size, factor, octaves, device, cache_dir=".worlds_cache"):
    X, Y, Z = size
    key = f"terrain_{X}x{Y}x{Z}_f{factor}_o{octaves}"
    return generate_or_load(cache_dir, key, lambda: build_brickmap_terrain(size, factor, octaves=octaves,
                                                                           device=device), device=device)


def bench_world(which: str, device):
    """The bench world ``which`` and its line table with brick lines, from
    ``.world_cache`` (``full`` built through W1 when missing)."""
    from voxelengine_tpu_torch.io.checkpoint import load_world_host_bricks
    from voxelengine_tpu_torch.ops.bigtrace import host_brick_lines

    dims = BENCH_DIMS[which]
    key = f"terrain_{dims[0]}x{dims[1]}x{dims[2]}_f32_o32_v1"
    if which == "huge":
        bm, bricks_host = load_world_host_bricks(f".world_cache/{key}.npz", device)
        lt = line_table_or_build(".world_cache", key + "_lt1", bm)
        lt = dataclasses.replace(lt, brick_lines=torch.from_numpy(host_brick_lines(bricks_host)).to(device))
    else:
        bm = generate_or_load(".world_cache", key, lambda: build_brickmap_terrain_compact(dims, 32, device=device),
                              device=device)
        lt = materialize_brick_lines(bm, line_table_or_build(".world_cache", key + "_lt1", bm))
    return bm, lt, key


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, nargs=3, default=[1024, 1024, 1024])
    ap.add_argument("--factor", type=int, default=32)  # main.cu:21
    ap.add_argument("--width", type=int, default=1280)  # main.cu:15
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--octaves", type=int, default=32)
    ap.add_argument("--frames", type=int, default=None,
                    help="frame cap (default: 240 scripted/headless, unlimited interactive)")
    ap.add_argument("--debug-view", action="store_true")
    ap.add_argument("--outdir", default="frames")
    ap.add_argument("--record", action="store_true", help="save numbered frames")
    ap.add_argument("--png", action="store_true", help="write PNGs instead of PPMs (native encoder)")
    ap.add_argument("--dense", action="store_true",
                    help="dense-grid world through K2 (render_frame_dense; worlds <= ~160^3)")
    ap.add_argument("--ortho", action="store_true",
                    help="orthographic projection (the reference's #define ORTHO); scroll zooms")
    ap.add_argument("--xla-trace", action="store_true",
                    help="no line table: frames and the crosshair ray go through K4 on the dense-slot world "
                         "(the JAX app's XLA traversal; the name is kept)")
    ap.add_argument("--bench-world", choices=["full", "huge"],
                    help="fly the bench world from .world_cache (full = 8k x 512 x 8k, built through W1 when "
                         "missing; huge = 16k x 512 x 16k via host-side brick->line relayout)")
    ap.add_argument("--speed", type=float, default=None,
                    help="fly speed in voxels/keypress (default 2; bench worlds 16)")
    ap.add_argument("--macro", choices=["on", "off", "auto"], default="on",
                    help="L1-L3 macro-skip spans in K1.  'auto' runs the probe-informed selection "
                         "(disk-memoized per scene).  Traversal results are the same either way")
    ap.add_argument("--shadows", action="store_true",
                    help="shadow rays toward the light (Renderer.cu:102); secondary rays ride the primaries' "
                         "traversal")
    ap.add_argument("--ao", type=int, default=0, metavar="N",
                    help="N hemisphere AO samples/pixel (Renderer.cu:120-165, reference ships samples=0)")
    ap.add_argument("--reflections", action="store_true",
                    help="one-bounce mirror reflections (beyond the reference)")
    ap.add_argument("--present-every", type=int, default=1,
                    help="read back + present every Nth frame (the loop stays on the device between presents)")
    ap.add_argument("--device", default=None, help="torch device (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> AppRun:
    """Run the app (``argv``: its command-line flags)."""
    args = parse_args(argv)
    dev = torch.device(args.device) if args.device else default_device()
    sync = dev if dev.type == "cuda" else None

    bench_dims, key = None, None
    grid, rt = None, None
    if args.bench_world:
        bench_dims = BENCH_DIMS[args.bench_world]
        with timed("Voxel generation + buffer generation time", device=sync):
            bm, lt, key = bench_world(args.bench_world, dev)
        rt = VoxelRaytracer3D()
        rt.upload_world_lines(bm, lt)
    elif args.dense:
        from voxelengine_tpu_torch.worldgen.terrain import generate_world

        with timed("Voxel generation time", device=sync):
            grid = generate_world(tuple(args.size), octaves=args.octaves, device=dev)
    else:
        with timed("Voxel generation + buffer generation time", device=sync):  # main.cu:26,32
            bm = build_world(tuple(args.size), args.factor, args.octaves, dev)
        rt = VoxelRaytracer3D(line_table=not args.xla_trace)
        rt.upload_world(bm)

    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        debug_view=DebugView.DEBUG if args.debug_view else DebugView.SHADED,
        checkerboard=True,
        projection=Projection.ORTHOGRAPHIC if args.ortho else Projection.PERSPECTIVE,
        tile_order=not args.xla_trace and not args.dense,
        shadow_rays=args.shadows and not args.dense,
        ao_samples=0 if args.dense else args.ao,
        reflections=args.reflections and not args.dense,
    )
    if args.dense and (args.shadows or args.ao or args.reflections):
        print("--shadows/--ao/--reflections ignored: the dense-grid path has no secondary trace (use the "
              "brickmap path)", file=sys.stderr)
    env = Environment.default(dev)  # main.cu:58-63

    renderer = Renderer("voxelengine_tpu_torch")
    mode = (4 | 8 if args.png else 1 | 2) if args.record else (8 if args.png else 2)
    renderer.init(args.width, args.height, 1.0, outdir=args.outdir, mode=mode)

    if bench_dims:  # on the bench hill, looking across the valley (bench.py camera)
        cam_pos = np.array([bench_dims[0] / 2, 380.0, bench_dims[2] / 2], np.float32)
        euler = np.array([-0.25, 0.75, 0.0], np.float32)
    else:
        cam_pos = np.array([256.0, 256.0, 256.0], np.float32)  # main.cu:52
        euler = np.array([0.3, 0.8, 0.0], np.float32)
    fly_speed = args.speed if args.speed is not None else (16.0 if bench_dims else 2.0)
    if args.macro != "on" and (rt is None or rt.line_table is None):
        print(f"--macro {args.macro} ignored: no line-table path active (--dense / --xla-trace do not use "
              "macro spans)", file=sys.stderr)
    elif args.macro == "off":
        cfg = dataclasses.replace(cfg, trace_use_macro=False)
    elif args.macro == "auto":  # disk-memoized probe (the same results either way)
        wk = key or f"terrain_{args.size[0]}x{args.size[1]}x{args.size[2]}_f{args.factor}_o{args.octaves}"
        # every probe input is in the key (memo_json contract)
        mk = (f"{wk}_appmacro_torch_v1_{cfg.width}x{cfg.height}_ms{cfg.max_steps}"
              f"_cam{'_'.join(str(float(v)) for v in cam_pos)}_e{'_'.join(str(float(e)) for e in euler)}")
        po, pd, *_ = primary_rays(cfg, torch.from_numpy(cam_pos).to(dev), torch.from_numpy(euler).to(dev), 1)
        use = bool(memo_json(".world_cache", mk, lambda: probe_use_macro(rt.world, rt.line_table, po, pd, cfg)))
        print(f"macro probe: use_macro={use}", file=sys.stderr)
        cfg = dataclasses.replace(cfg, trace_use_macro=use)

    fb = make_framebuffer(cfg, dev)
    timer = FrameTimer()
    interactive = sys.stdin.isatty()
    # interactive sessions run until 'quit' unless --frames is given;
    # headless runs default to a 240-frame fly-through
    nframes = args.frames if args.frames is not None else (None if interactive else 240)
    src = best_input(scripted=None if interactive else
                     [["w"] if i % 3 else ["w", "right"] for i in range(nframes)])

    state = dict(frame=0, running=True, boost=1.0)  # 'b' toggles the reference's LShift x10 (main.cu:110-144)
    ortho_zoom = np.asarray(cfg.ortho_size, np.float32)
    world_max = np.array(rt.world.world_dims) - 1 if rt is not None else None

    def crosshair_edit(place: bool):
        """Trace the crosshair ray (``rt.raytrace``: K1 with the macro levels
        off, or K4) and break the hit voxel or place one on its face."""
        fwd, _, _ = get_directions_np(euler)
        res = rt.raytrace(cam_pos[None], fwd[None], cfg.max_steps)
        if not bool(res.valid[0]):
            return
        p, n = res.hit_point[0].cpu().numpy(), res.normal[0].cpu().numpy()
        # the normal points into the hit voxel: +0.5n lands in it (break),
        # -0.5n in the face-adjacent air voxel (place)
        v = np.clip((p - 0.5 * n if place else p + 0.5 * n).astype(int), 0, world_max)
        rt.edit_voxels(*(torch.tensor([int(c)], device=dev) for c in v), place)

    def on_frame(data):
        nonlocal fb
        speed = fly_speed * state["boost"]
        for ev in src.poll():
            fwd, _, right = get_directions_np(euler)  # fwd is the look direction
            if ev.key == "quit":
                state["running"] = False
            elif ev.key == "w":
                cam_pos[:] += fwd * speed
            elif ev.key == "s":
                cam_pos[:] -= fwd * speed
            elif ev.key == "a":
                cam_pos[:] -= right * speed
            elif ev.key == "d":
                cam_pos[:] += right * speed
            elif ev.key == "q":
                cam_pos[1] -= speed
            elif ev.key == "e":
                cam_pos[1] += speed
            elif ev.key == "left":
                euler[1] += 0.04
            elif ev.key == "right":
                euler[1] -= 0.04
            elif ev.key == "up":
                euler[0] -= 0.04
            elif ev.key == "down":
                euler[0] += 0.04
            elif ev.key.startswith("drag:"):  # mouse-look analog (main.cu:149-161)
                dx, dy = (float(v) for v in ev.key[5:].split(","))
                euler[1] -= dx * MOUSE_SENS
                euler[0] -= dy * MOUSE_SENS
            elif ev.key == "b":
                state["boost"] = 10.0 if state["boost"] == 1.0 else 1.0
            elif ev.key.startswith("scroll:"):  # ortho window zoom +-10 (main.cu:94-107)
                ortho_zoom[:] = np.maximum(ortho_zoom - float(ev.key[7:]) * 10.0, 1.0)
            elif ev.key in ("f", "g") and rt is not None and rt.world.dense_slots:
                # edits need dense-slot worlds; the compact bench worlds ignore the key
                crosshair_edit(ev.key == "g")

        origin, eul = torch.from_numpy(cam_pos).to(dev), torch.from_numpy(euler).to(dev)
        osz = torch.from_numpy(ortho_zoom.copy()).to(dev) if args.ortho else None
        if args.dense:
            fb = render_frame_dense(grid, fb, origin, eul, env, state["frame"], cfg, ortho_size=osz)
        else:
            fb = render_frame(rt.world, fb, origin, eul, env, state["frame"], cfg, rt.line_table, ortho_size=osz)
        if state["frame"] % args.present_every == 0:
            data.pixels[...] = to_bgra8(fb).cpu().numpy()
        else:
            data.present = False  # stale staging buffer: no readback, no re-encode
        state["frame"] += 1
        ema = timer.tick()
        if state["frame"] % 10 == 0:
            print(f"[{state['frame']}] Avg FPS: {timer.fps:.1f} ({ema:.2f} ms)")

    renderer.add_render_event_callback(on_frame)
    t0 = time.perf_counter()
    try:
        while state["running"] and (nframes is None or state["frame"] < nframes):
            renderer.render()
        if sync is not None:
            torch.cuda.synchronize(sync)
    finally:
        try:
            renderer.close()
        finally:
            if hasattr(src, "close"):
                src.close()  # restore the tty even if the sink close raises
    secs = time.perf_counter() - t0
    print(f"presented {renderer.frames_presented} frames")
    if state["frame"]:
        print(f"{state['frame']} frames in {secs:.3f} s ({secs * 1e3 / state['frame']:.2f} ms/frame, host clock, "
              f"device synchronised at the end) on {torch.cuda.get_device_name(dev) if sync else dev}")
    return AppRun(rt, grid, fb, state["frame"], secs)


if __name__ == "__main__":
    main()
