"""Where the bench frame's time goes: ray setup, trace, shading and composite.

Counterpart of ``experiments/bench_frame_breakdown.py``.  Three nested
pipelines on one world, with the same rays and configuration, over chained
frames with the bench drift (``euler + 1e-5 * i``, frame number ``i``):

  S0   ``render/frame.py::primary_rays`` alone
  S1   S0, then ``ops/bigtrace.py::trace_brickmap_hbm`` (K1)
  S1s  S1, then the shading's secondary traces (``render/frame.py::
       _secondary_inputs``: shadow, reflection and AO rays; nothing for a
       primary frame)
  S2   ``render/frame.py::render_frame`` (S1s, shading, composite)

so trace = S1 - S0, secondary = S1s - S1, shade + composite = S2 - S1s
(and S2 - S1 the whole shading stage).  For each stage: ms a
frame by CUDA events, as the median, least and largest of ``--batches``
batches of ``--frames`` frames, and the host's enqueue time a frame (the
host clock until the batch's last call returns); the CUDA kernels a frame and their device
ms a frame, from ``torch.profiler`` (``utils/profiling.py::
kernel_profile``, two more batches: its warm-up and the recorded one, taken again where a profile records no
device activity); and the device-busy share, device ms
over the median ms.  Shadings: ``primary`` (the bench frame) and ``shaded``
(shadows, AO 4, reflections: S2 adds their traces to the shading).

    python -m voxelengine_tpu_torch.experiments.bench_frame_breakdown [--world full] [--batches 5] [--frames 8]

Prints a line per stage and shading and one JSON line of everything.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys

import torch

from voxelengine_tpu_torch.experiments.scene import Scene, bench_scene, ms_timer, spread
from voxelengine_tpu_torch.ops.bigtrace import trace_brickmap_hbm
from voxelengine_tpu_torch.render.frame import _secondary_inputs, make_framebuffer, primary_rays, render_frame

SHADINGS = {"primary": {}, "shaded": dict(shadow_rays=True, ao_samples=4, reflections=True)}
STAGES = ("S0", "S1", "S1s", "S2")
WARM = 3  # untimed frames before each stage's batches


def stages(scene: Scene, cfg) -> dict:
    """``stage -> fn(i)``: frame ``i`` of each nested pipeline."""
    bm, lt, _, origin, euler, env, dev = scene
    drift = torch.tensor(1e-5, dtype=torch.float32, device=dev)
    fb = make_framebuffer(cfg, dev)

    def s0(i):
        return primary_rays(cfg, origin, euler + drift * i, i)

    def s1(i):
        o, d = primary_rays(cfg, origin, euler + drift * i, i)[:2]
        return trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=cfg.trace_use_macro)

    def s1s(i):
        o, d, px, py, _ = primary_rays(cfg, origin, euler + drift * i, i)
        out = trace_brickmap_hbm(bm, lt, o, d, cfg.max_steps, use_macro=cfg.trace_use_macro)
        return _secondary_inputs(bm, lt, out, d, px, py, env, i, cfg)

    def s2(i):
        return render_frame(bm, fb, origin, euler + drift * i, env, i, cfg, lt)

    return {"S0": s0, "S1": s1, "S1s": s1s, "S2": s2}


def measure(scene: Scene, shading: str, batches: int = 5, frames: int = 8) -> dict:
    """One shading's stages: ``{stage: {...}, "trace_ms", "secondary_ms",
    "shade_ms", "shade_composite_ms"}`` (differences of the medians;
    ``shade_composite_ms`` is S2 - S1, the secondary traces included)."""
    from voxelengine_tpu_torch.utils.profiling import kernel_profile

    cfg = dataclasses.replace(scene.cfg, **SHADINGS[shading])
    timed = ms_timer(scene.device, enqueue=True)
    out = {}
    for name, fn in stages(scene, cfg).items():
        for i in range(WARM):
            fn(i)
        first, ms, host = WARM, [], []
        for _ in range(batches):
            t, h = timed(lambda f=first: [fn(i) for i in range(f, f + frames)])
            ms.append(t / frames)
            host.append(h / frames)
            first += frames
        rec = spread(ms)
        rec["batches_ms"], rec["host_ms"] = ms, spread(host)["median"]
        if scene.device.type == "cuda":
            frame_no = itertools.count(first)  # kernel_profile's warm-up and recorded calls, a profile each try
            names, dev_ms = kernel_profile(lambda: fn(next(frame_no)), frames)
            if names is not None:
                rec["kernels_per_frame"] = len(names) / frames
                rec["device_ms_per_frame"] = sum(dev_ms) / frames
                rec["busy_share"] = rec["device_ms_per_frame"] / rec["median"]
        out[name] = rec
    out["trace_ms"] = out["S1"]["median"] - out["S0"]["median"]
    out["secondary_ms"] = out["S1s"]["median"] - out["S1"]["median"]
    out["shade_ms"] = out["S2"]["median"] - out["S1s"]["median"]
    out["shade_composite_ms"] = out["S2"]["median"] - out["S1"]["median"]
    return out


def report(shading: str, res: dict, card: str) -> list:
    """The lines :func:`main` prints for one shading."""
    lines = []
    for st in STAGES:
        r = res[st]
        extra = ", kernels and device ms a frame: not measured (torch.profiler recorded no device activity)"
        if "kernels_per_frame" in r:
            extra = (f", {r['kernels_per_frame']} CUDA kernels and {r['device_ms_per_frame']} device ms a frame, "
                     f"busy share {r['busy_share']}")
        lines.append(f"{shading} {st}: {r['median']} ms/frame (median of {r['n']} batches, {r['min']} - "
                     f"{r['max']}; the host enqueues a frame in {r['host_ms']} ms){extra}, on {card}")
    lines.append(f"{shading}: ray setup (S0) {res['S0']['median']} ms, trace (S1 - S0) {res['trace_ms']} ms, "
                 f"secondary traces (S1s - S1) {res['secondary_ms']} ms, shade + composite (S2 - S1s) "
                 f"{res['shade_ms']} ms; S2 - S1 {res['shade_composite_ms']} ms, on {card}")
    return lines


def main(argv=None) -> int:
    from voxelengine_tpu_torch.bench import device_line

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", default="full", choices=("small", "full"))
    ap.add_argument("--batches", type=int, default=5)
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--cache-dir", default=".world_cache")
    ap.add_argument("--device", default=None, help="default: the card")
    a = ap.parse_args(argv)
    scene = bench_scene(a.world, a.device, a.cache_dir)
    card = device_line(scene.device)
    results = {}
    for shading in SHADINGS:
        results[shading] = measure(scene, shading, a.batches, a.frames)
        for line in report(shading, results[shading], card):
            print(line, flush=True)
    print(json.dumps({"world": a.world, "device": card, "breakdown": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
