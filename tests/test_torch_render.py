"""The PyTorch port's camera, shading and frame path against the JAX package,
and the slice as a whole (``render_frame`` on a 64^3 world with
checkerboarding and ``tile_order``).

As in ``test_torch_trace.py``, the JAX side runs in a subprocess whose
XLA:CPU has neither FMA contraction nor the algebraic simplifier, so that
both packages round every op of the expressions as written.  Without the
simplifier's rewrite of ``px / W`` into ``px * (1/W)``, rays and frames
are bit-equal at a width that is not a power of two too.  XLA:CPU's
``sin``, ``cos`` and ``tan`` are glibc's ``sinf``, ``cosf`` and ``tanf``,
which the port computes in ``core/libm.py``: the camera basis is bit-equal
too, on a sweep of angles and at JAX's own cameras, where the frames' hit,
steps and pixels are counted against JAX's.
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
# JAX's own cameras: tests/test_parallel.py's, the bench's (bench.py:192);
# the JAX side adds the bench's drift euler + float32(1e-5) * i, i = 1..6
# (bench.py:324)
JAX_CAMERAS = np.array([[0.9, 0.3, 0.0], [-0.25, 0.75, 0.0]], np.float32)
N_DRIFT = 6
# name: (width, height, checkerboard, tile_order, projection, frame numbers)
FRAMES = {
    "cb_tile_64": (64, 64, True, True, "PERSPECTIVE", (1, 2)),
    "full_64": (64, 64, False, False, "PERSPECTIVE", (0,)),
    "ortho_64": (64, 64, True, False, "ORTHOGRAPHIC", (3,)),
    "cb_tile_96": (96, 64, True, True, "PERSPECTIVE", (1,)),
}


def _trig_sweep():
    """Angles for the trig functions against JAX's jitted ones: a grid over
    [-3.3, 3.3] and random |x| up to 1e4."""
    rng = np.random.default_rng(9)
    big = (rng.random(20_000) * 2e4 - 1e4).astype(np.float32)
    return np.concatenate([np.linspace(-3.3, 3.3, 200_001, dtype=np.float32), big])


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
    from voxelengine_tpu.ops.trace import trace_brickmap
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

    x = jnp.asarray(_trig_sweep())
    for k, f in (("sin", jnp.sin), ("cos", jnp.cos), ("tan", jnp.tan)):
        out[f"trig/{k}"] = np.asarray(jax.jit(f)(x))

    env = JEnv.default()
    # the frames at JAX's own cameras: the primary trace's hit and steps and
    # the frame (cb_tile_64, frame 1, a fresh framebuffer)
    W, H, cb, to, proj, _ = FRAMES["cb_tile_64"]
    cfg = JCfg(width=W, height=H, checkerboard=cb, tile_order=to, projection=JProj[proj], staged_trace=False,
               max_steps=256)
    bench = jnp.asarray(JAX_CAMERAS[1])
    cams = [jnp.asarray(e) for e in JAX_CAMERAS] + [bench + jnp.float32(1e-5) * i for i in range(1, N_DRIFT + 1)]
    trace = jax.jit(lambda o, d: trace_brickmap(bm, o, d, cfg.max_steps))
    for j, e in enumerate(cams):
        out[f"cam{j}/euler"] = np.asarray(e)
        out[f"cam{j}/basis"] = np.stack([np.asarray(v) for v in jax.jit(jcam.get_directions)(e)])
        o, d = jax.jit(primary_rays, static_argnums=0)(cfg, jnp.asarray(ORIGIN), e, jnp.int32(1))[:2]
        res = trace(o, d)
        out[f"cam{j}/hit"], out[f"cam{j}/steps"] = np.asarray(res.hit), np.asarray(res.steps)
        out[f"cam{j}/frame"] = np.asarray(render_frame(bm, make_framebuffer(cfg), jnp.asarray(ORIGIN), e, env,
                                                       jnp.int32(1), cfg))

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
    """The basis is bit-equal (0 ulp) to JAX's."""
    got = camera.get_directions(_t(EULERS[i]))
    for k, g in zip(("fwd", "up", "right"), got):
        np.testing.assert_array_equal(g.numpy(), ref[f"basis{i}/{k}"], err_msg=k)


@pytest.mark.parametrize("fn", ["sin", "cos", "tan"])
def test_trig_bit_equal_to_jax(ref, fn):
    """``core/libm.py`` against JAX's jitted ``jnp.sin``, ``jnp.cos`` and
    ``jnp.tan`` on 220,001 angles: 0 diffs."""
    from voxelengine_tpu_torch.core import libm

    f = {"sin": libm.sinf, "cos": libm.cosf, "tan": libm.tanf}[fn]
    got = f(_t(_trig_sweep())).numpy()
    assert int((got.view(np.int32) != ref[f"trig/{fn}"].view(np.int32)).sum()) == 0


@pytest.mark.parametrize("j", range(len(JAX_CAMERAS) + N_DRIFT))
def test_frames_at_jax_cameras_count_zero_diffs(ref, j):
    """At tests/test_parallel.py's camera, the bench's and the bench's six
    drifted ones: the basis, and the counts of hit, steps and pixel diffs
    of the primary trace and the frame against JAX's, all 0."""
    from voxelengine_tpu_torch.ops.trace import trace_brickmap

    bm = brickmap_from_numpy({k: ref[f"bm/{k}"] for k in BM_KEYS}, device="cpu")
    cfg = _cfg("cb_tile_64")
    e = _t(ref[f"cam{j}/euler"])
    basis = torch.stack(camera.get_directions(e)).numpy()
    np.testing.assert_array_equal(basis, ref[f"cam{j}/basis"])
    o, d = frame.primary_rays(cfg, _t(ORIGIN), e, 1)[:2]
    res = trace_brickmap(bm, o, d, cfg.max_steps)
    fb = frame.render_frame(bm, frame.make_framebuffer(cfg, device="cpu"), _t(ORIGIN), e,
                            Environment.default(device="cpu"), 1, cfg)
    counts = {
        "hit": int((res.hit.numpy() != ref[f"cam{j}/hit"]).sum()),
        "steps": int((res.steps.numpy() != ref[f"cam{j}/steps"]).sum()),
        "pixels": int((fb.numpy() != ref[f"cam{j}/frame"]).any(-1).sum()),
    }
    assert counts == {"hit": 0, "steps": 0, "pixels": 0}
    assert 0 < int(res.hit.sum()) < res.hit.numel()  # the camera sees the world and the sky


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
