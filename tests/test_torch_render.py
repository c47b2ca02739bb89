"""The PyTorch port's camera, shading and frame path against the JAX package,
and the slice as a whole (``render_frame`` on a 64^3 world with
checkerboarding and ``tile_order``).

As in ``test_torch_trace.py``, the JAX side runs in a subprocess whose
XLA:CPU has neither FMA contraction nor the algebraic simplifier, so that
both packages round every op of the expressions as written.  Without the
simplifier's rewrite of ``px / W`` into ``px * (1/W)``, rays and frames
are bit-equal at a width that is not a power of two too.  One difference
remains and is stated where it is tested: ``sin``/``cos``/``tan`` are each
library's own, so the camera basis is held to 2 ulp (it comes out
bit-equal on this CPU).
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.config import Environment, Projection, RenderConfig
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.ops.bigtrace import make_line_table
from voxelengine_tpu_torch.render import camera, frame, shading

ROOT = Path(__file__).resolve().parent.parent
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")
EULERS = np.array([[-0.25, 0.75, 0.0], [-0.5, 0.8, 0.0], [0.3, -1.2, 0.0], [0.0, 0.0, 0.0]], np.float32)
ORIGIN = np.array([32.0, 48.0, 32.0], np.float32)
# name: (width, height, checkerboard, tile_order, projection, frame numbers)
FRAMES = {
    "cb_tile_64": (64, 64, True, True, "PERSPECTIVE", (1, 2)),
    "full_64": (64, 64, False, False, "PERSPECTIVE", (0,)),
    "ortho_64": (64, 64, True, False, "ORTHOGRAPHIC", (3,)),
    "cb_tile_96": (96, 64, True, True, "PERSPECTIVE", (1,)),
}


def _world():
    rng = np.random.default_rng(0xC0FFEE)
    dense = rng.random((64, 64, 64)) < 0.01
    dense[:, 0:4, :] = rng.random((64, 4, 64)) < 0.5
    return dense


def _jax_reference():
    """JAX side (runs in the subprocess, module doc)."""
    import dataclasses

    import jax

    from voxelengine_tpu.config import Environment as JEnv
    from voxelengine_tpu.config import Projection as JProj
    from voxelengine_tpu.config import RenderConfig as JCfg
    from voxelengine_tpu.core.bitgrid import BitGrid
    from voxelengine_tpu.core.brickmap import build_brickmap
    from voxelengine_tpu.core.layout import Layout
    from voxelengine_tpu.render import camera as jcam
    from voxelengine_tpu.render import shading as jsh
    from voxelengine_tpu.render.frame import make_framebuffer, primary_rays, render_frame

    out = {}
    bm = build_brickmap(BitGrid.from_dense(_world()), 8, coarse_layout=Layout.LINEAR)
    for k in BM_KEYS:
        v = getattr(bm, k)
        out[f"bm/{k}"] = np.asarray(getattr(v, "value", v))
    for i, e in enumerate(EULERS):
        for k, v in zip(("fwd", "up", "right"), jax.jit(jcam.get_directions)(jnp.asarray(e))):
            out[f"basis{i}/{k}"] = np.asarray(v)

    env = JEnv.default()
    for name, (W, H, cb, to, proj, frames) in FRAMES.items():
        cfg = JCfg(width=W, height=H, checkerboard=cb, tile_order=to, projection=JProj[proj],
                   staged_trace=False, max_steps=256)
        fb = make_framebuffer(cfg)
        for fn in frames:
            e = jnp.asarray(EULERS[1])
            rays = jax.jit(primary_rays, static_argnums=0)(cfg, jnp.asarray(ORIGIN), e, jnp.int32(fn))
            for k, v in zip(("origins", "dirs", "px", "py", "py_r"), rays):
                out[f"{name}/{fn}/{k}"] = np.asarray(v)
            px, py = rays[2], rays[3]
            out[f"{name}/{fn}/u"] = np.asarray(jax.jit(lambda p: p.astype(jnp.float32) / jnp.float32(W))(px))
            out[f"{name}/{fn}/v"] = np.asarray(jax.jit(lambda p: p.astype(jnp.float32) / jnp.float32(H))(py))
            fb = render_frame(bm, fb, jnp.asarray(ORIGIN), e, env, jnp.int32(fn), cfg)
            out[f"{name}/{fn}/frame"] = np.asarray(fb)
        # the frame from the non-tiled ray order must be the same image
        if to:
            cfg2 = dataclasses.replace(cfg, tile_order=False)
            fb2 = make_framebuffer(cfg2)
            for fn in frames:
                fb2 = render_frame(bm, fb2, jnp.asarray(ORIGIN), jnp.asarray(EULERS[1]), env, jnp.int32(fn), cfg2)
            out[f"{name}/untiled"] = np.asarray(fb2)

    rng = np.random.default_rng(5)
    n = 2000
    normal = np.zeros((n, 3), np.float32)
    normal[np.arange(n), rng.integers(0, 3, n)] = rng.choice([-1.0, 1.0], n)
    pos = (rng.random((n, 3)) * 64).astype(np.float32)
    cam = np.array([30.5, 41.25, 12.0], np.float32)
    out["shade/normal"], out["shade/pos"], out["shade/cam"] = normal, pos, cam
    c = jax.jit(jsh.calculate_color)(jnp.asarray(cam), jnp.asarray(normal), jnp.asarray(pos), env)
    out["shade/color"] = np.asarray(c)
    out["shade/tonemap"] = np.asarray(jax.jit(jsh.tonemap)(c))
    i = rng.normal(size=(n, 3)).astype(np.float32)
    out["shade/i"] = i
    out["shade/reflect"] = np.asarray(jax.jit(jsh.reflect)(jnp.asarray(i), jnp.asarray(normal)))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run this file's JAX side in a subprocess with XLA:CPU's FMA
    contraction and algebraic simplifier off (module doc)."""
    path = tmp_path_factory.mktemp("jax_ref") / "render_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.run(
        [sys.executable, __file__, str(path)], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=600,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _cfg(name):
    W, H, cb, to, proj, _ = FRAMES[name]
    return RenderConfig(width=W, height=H, checkerboard=cb, tile_order=to,
                        projection=Projection[proj], max_steps=256)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("i", range(len(EULERS)))
def test_camera_basis_within_2_ulp(ref, i):
    got = camera.get_directions(_t(EULERS[i]))
    for k, g in zip(("fwd", "up", "right"), got):
        want = ref[f"basis{i}/{k}"]
        ulp = np.spacing(np.maximum(np.abs(want), np.float32(1e-30)).astype(np.float32))
        assert (np.abs(g.numpy() - want) <= 2 * ulp).all(), k


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_primary_rays(ref, name):
    """Pixel coordinates, directions and origins bit-equal, also when
    computed from JAX's own u, v."""
    cfg = _cfg(name)
    for fn in FRAMES[name][5]:
        p = f"{name}/{fn}"
        o, d, px, py, py_r = frame.primary_rays(cfg, _t(ORIGIN), _t(EULERS[1]), fn)
        for k, v in (("px", px), ("py", py), ("py_r", py_r)):
            np.testing.assert_array_equal(v.numpy(), ref[f"{p}/{k}"], err_msg=k)
        fwd, up, right = camera.get_directions(_t(EULERS[1]))
        u, v = _t(ref[f"{p}/u"]), _t(ref[f"{p}/v"])
        if cfg.projection is Projection.PERSPECTIVE:
            dj = camera.ray_direction(fwd, up, right, cfg.width, cfg.height, u, v, cfg.fov_degrees)
            np.testing.assert_array_equal(dj.numpy(), ref[f"{p}/dirs"])
        else:
            oj = camera.ray_origin_ortho(fwd, up, right, cfg.width, cfg.height, u, v, _t(ORIGIN), cfg.ortho_size)
            np.testing.assert_array_equal(oj.numpy(), ref[f"{p}/origins"])
        np.testing.assert_array_equal(d.numpy(), ref[f"{p}/dirs"])
        np.testing.assert_array_equal(o.numpy(), ref[f"{p}/origins"])


def test_shading_bit_equal(ref):
    env = Environment.default(device="cpu")
    normal, pos, cam = (_t(ref[f"shade/{k}"]) for k in ("normal", "pos", "cam"))
    c = shading.calculate_color(cam, normal, pos, env)
    np.testing.assert_array_equal(c.numpy(), ref["shade/color"])
    np.testing.assert_array_equal(shading.tonemap(c).numpy(), ref["shade/tonemap"])
    np.testing.assert_array_equal(shading.reflect(_t(ref["shade/i"]), normal).numpy(), ref["shade/reflect"])


@pytest.mark.parametrize("name", ["cb_tile_64", "full_64", "ortho_64"])
def test_render_frame_bit_equal(ref, name):
    """The slice end to end: chained frames through the line-table entry
    (the plain trace on the CPU) equal JAX's ``render_frame`` exactly."""
    bm = brickmap_from_numpy({k: ref[f"bm/{k}"] for k in BM_KEYS}, device="cpu")
    lt = make_line_table(bm)
    cfg = _cfg(name)
    fb = frame.make_framebuffer(cfg, device="cpu")
    for fn in FRAMES[name][5]:
        out = frame.render_frame(bm, fb, _t(ORIGIN), _t(EULERS[1]), Environment.default(device="cpu"), fn, cfg, lt=lt)
        assert out is fb  # updated in place
        np.testing.assert_array_equal(fb.numpy(), ref[f"{name}/{fn}/frame"])
    if cfg.tile_order:
        np.testing.assert_array_equal(fb.numpy(), ref[f"{name}/untiled"])


def test_render_frame_non_power_of_two_width(ref):
    """96x64: the frame equals JAX's exactly, and the port renders JAX's
    frame exactly from JAX's rays as well."""
    name = "cb_tile_96"
    bm = brickmap_from_numpy({k: ref[f"bm/{k}"] for k in BM_KEYS}, device="cpu")
    cfg, env = _cfg(name), Environment.default(device="cpu")
    p = f"{name}/1"
    fb = frame.render_frame(bm, frame.make_framebuffer(cfg, device="cpu"), _t(ORIGIN), _t(EULERS[1]), env, 1, cfg)
    want = ref[f"{p}/frame"]
    np.testing.assert_array_equal(fb.numpy(), want)

    # JAX's own rays through the port's trace, shading and composite
    o, dj = _t(ref[f"{p}/origins"]), _t(ref[f"{p}/dirs"])
    px, py, py_r = (_t(ref[f"{p}/{k}"]).long() for k in ("px", "py", "py_r"))
    color, write = frame.shade_pixels(bm, o, dj, px, py, py_r, _t(ORIGIN), env, 1, cfg)
    fb2 = frame.composite_frame(frame.make_framebuffer(cfg, device="cpu"), color, write, cfg, 1)
    np.testing.assert_array_equal(fb2.numpy(), want)


def test_composite_frame_bit_equal_to_jax(rng):
    from voxelengine_tpu.config import RenderConfig as JCfg
    from voxelengine_tpu.render import frame as jframe

    for cb, to, fn in ((True, True, 1), (True, True, 2), (True, False, 3), (False, True, 0)):
        W, H = 64, 60
        rows = H // 2 if cb else H
        color = rng.random((rows * W, 3)).astype(np.float32)
        write = rng.random(rows * W) < 0.8
        fb = rng.random((H, W, 3)).astype(np.float32)
        jc = JCfg(width=W, height=H, checkerboard=cb, tile_order=to)
        tc = RenderConfig(width=W, height=H, checkerboard=cb, tile_order=to)
        want = np.asarray(jframe.composite_frame(jnp.asarray(fb), jnp.asarray(color), jnp.asarray(write), jc, fn))
        got = frame.composite_frame(_t(fb), _t(color), _t(write), tc, fn)
        np.testing.assert_array_equal(got.numpy(), want)
        assert frame.block_geometry(tc) == jframe.block_geometry(jc)


def test_to_bgra8_bit_equal(rng):
    from voxelengine_tpu.render import frame as jframe

    fb = (rng.random((8, 12, 3)) * 1.4 - 0.2).astype(np.float32)
    np.testing.assert_array_equal(frame.to_bgra8(_t(fb)).numpy(), np.asarray(jframe.to_bgra8(jnp.asarray(fb))))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
