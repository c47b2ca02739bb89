"""A full 1080p demo image of a bench world, as a PNG.

Counterpart of ``experiments/render_demo.py``: both checkerboard fields
(frames 0 and 1) of the ``full`` or ``huge`` bench world composited into
one 1920x1080 image, what the reference's interlaced presentation shows
after two frames (``Renderer.cu:186-194``), encoded by
``runtime/display.py::_encode_png``.  ``huge`` keeps its raw bricks on the
host and uploads their brick lines (``bench.py``'s 16k flow).  Knobs:
``DEMO_SHADOWS=1`` (shadow rays), ``DEMO_AO=N`` (N AO samples),
``DEMO_REFLECT=1`` (one-bounce reflections); each adds a suffix to the
default name.

    python -m voxelengine_tpu_torch.experiments.render_demo [full|huge] [out.png]

Writes under ``experiments_out/`` unless given a path (never ``docs/``),
and prints the PNG's size and SHA-256, and how many pixels differ from the
JAX reference's TPU render of the same name in ``docs/`` where there is one
(information: a TPU image, not a gate).
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import struct
import sys
import zlib
from pathlib import Path

import numpy as np
import torch

from voxelengine_tpu_torch.experiments.scene import OUT_DIR, Scene, bench_scene
from voxelengine_tpu_torch.render.frame import make_framebuffer, render_frame
from voxelengine_tpu_torch.runtime.display import _encode_png

DOCS = Path(__file__).resolve().parents[2] / "docs"


def render(scene: Scene, shadows: bool = False, ao: int = 0, reflect: bool = False) -> np.ndarray:
    """Both checkerboard fields as one ``uint8 [H, W, 3]`` image (the
    framebuffer clipped to [0, 1], times 255, truncated)."""
    bm, lt, cfg, origin, euler, env, dev = scene
    cfg = dataclasses.replace(cfg, shadow_rays=shadows, ao_samples=ao, reflections=reflect)
    fb = make_framebuffer(cfg, dev)
    for i in range(2):
        render_frame(bm, fb, origin, euler, env, i, cfg, lt)
    return (fb.clamp(0.0, 1.0) * 255.0).to(torch.uint8).cpu().numpy()


def name(world: str, shadows: bool, ao: int, reflect: bool) -> str:
    suffix = ("_shadows" if shadows else "") + (f"_ao{ao}" if ao else "") + ("_refl" if reflect else "")
    return f"demo_{'16k' if world == 'huge' else '8k'}_terrain_1080p{suffix}.png"


def decode_png(data: bytes) -> np.ndarray:
    """``uint8 [H, W, 3]`` of an 8-bit RGB PNG whose rows all use filter 0
    (as ``_encode_png`` writes them); raises ``ValueError`` otherwise."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, head = 8, [], None
    while pos < len(data):
        (n,), typ = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if typ == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif typ == b"IDAT":
            idat.append(body)
    if head is None or head[2:] != (8, 2, 0, 0, 0):
        raise ValueError(f"only 8-bit RGB PNGs without interlace, got {head}")
    w, h = head[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(h, 1 + 3 * w)
    if rows[:, 0].any():
        raise ValueError("only rows with filter 0")
    return rows[:, 1:].reshape(h, w, 3)


def main(argv=None) -> int:
    from voxelengine_tpu_torch.bench import device_line

    argv = sys.argv[1:] if argv is None else argv
    world = argv[0] if argv else "full"
    if world not in ("full", "huge"):
        raise SystemExit(f"render_demo: world must be full or huge, got {world!r}")
    shadows = os.environ.get("DEMO_SHADOWS", "0") == "1"
    ao = int(os.environ.get("DEMO_AO", "0"))
    reflect = os.environ.get("DEMO_REFLECT", "0") == "1"
    out = Path(argv[1] if len(argv) > 1 else Path(OUT_DIR) / name(world, shadows, ao, reflect))
    if DOCS in out.resolve().parents:
        raise SystemExit("render_demo: the docs/ images are the JAX reference's; write elsewhere")
    scene = bench_scene(world)
    png = _encode_png(render(scene, shadows, ao, reflect))
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_bytes(png)
    print(f"wrote {out} ({len(png)} bytes, sha256 {hashlib.sha256(png).hexdigest()}) on {device_line(scene.device)}")
    ref = DOCS / name(world, shadows, ao, reflect)
    if ref.exists():
        a, b = decode_png(png), decode_png(ref.read_bytes())
        print(f"pixels differing from {ref.name} (the JAX reference's TPU render, information only): "
              f"{int((a != b).any(-1).sum())} of {a.shape[0] * a.shape[1]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
