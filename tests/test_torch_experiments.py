"""The port's measurement scripts (``voxelengine_tpu_torch/experiments/``)
on the CPU at a tiny size, and the two helpers ported last.

The scripts time the card; here their logic runs on a 128x64x128 terrain
at 4 octaves (the bench harness test's world) at 64x48: the frame
breakdown's three nested stages and their differences, the shard
projection's rays (each rank's pixels are the sharded frames' own, and the
ranks' shares tile the frame), the block-cyclic check on 2 gloo ranks at
256x128 (0 byte diffs against one device), the demo's two fields and its
PNG coder.  The block geometry at 1920x1080 is held to JAX's, and
``np_pack_bits`` and ``aabb_contains`` bit-equal to JAX's.
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.config import RenderConfig
from voxelengine_tpu_torch.experiments import bench_frame_breakdown as b1
from voxelengine_tpu_torch.experiments import bench_shard_projection as b2
from voxelengine_tpu_torch.experiments import render_demo as b4
from voxelengine_tpu_torch.experiments import verify_cyclic_1080p as b3
from voxelengine_tpu_torch.experiments.scene import bench_scene
from voxelengine_tpu_torch.render.frame import block_geometry, primary_rays

TINY = dict(world="small", device="cpu", width=64, height=48, dims=(128, 64, 128), octaves=4, camera_y=50.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    return bench_scene(cache_dir=str(tmp_path_factory.mktemp("world_cache")), **TINY)


def test_scene_is_the_bench_harness_scene(scene):
    assert scene.cfg.checkerboard and scene.cfg.tile_order and scene.device.type == "cpu"
    np.testing.assert_array_equal(scene.origin.numpy(), [64.0, 50.0, 64.0])
    np.testing.assert_array_equal(scene.euler.numpy(), np.float32([-0.25, 0.75, 0.0]))
    assert scene.lt.brick_lines is not None


@pytest.mark.parametrize("shading", sorted(b1.SHADINGS))
def test_frame_breakdown_stages(scene, shading):
    """Each stage has its batches' spread; trace, the secondary traces and
    shade + composite are the differences of the medians; S1 returns the
    frame's trace, S1s its secondary results (none for a primary frame) and
    S2 the frame's framebuffer."""
    res = b1.measure(scene, shading, batches=2, frames=1)
    for st in b1.STAGES:
        r = res[st]
        assert r["n"] == 2 and len(r["batches_ms"]) == 2 and r["min"] <= r["median"] <= r["max"]
        assert "kernels_per_frame" not in r  # the profiler's counts are the card's
    assert res["trace_ms"] == res["S1"]["median"] - res["S0"]["median"]
    assert res["shade_composite_ms"] == res["S2"]["median"] - res["S1"]["median"]
    assert res["secondary_ms"] == res["S1s"]["median"] - res["S1"]["median"]
    assert res["shade_ms"] == res["S2"]["median"] - res["S1s"]["median"]
    fns = b1.stages(scene, dataclasses.replace(scene.cfg, **b1.SHADINGS[shading]))
    out = fns["S1"](0)
    assert out.hit.shape == (64 * 48 // 2,) and 0 < int(out.hit.sum())
    shadow, reflection, ao = fns["S1s"](0)
    assert (shadow is None) == (shading == "primary") and (ao is None) == (shading == "primary")
    if shading == "shaded":
        assert shadow[0].shape == out.hit.shape and reflection[1].shape == out.position.shape
    assert fns["S2"](0).shape == (48, 64, 3)
    assert len(b1.report(shading, res, "cpu")) == len(b1.STAGES) + 1


@pytest.mark.parametrize("layout, n", [("rows", 2), ("rows", 4), ("cyclic", 2)])  # 64x48: 2 pixel blocks
def test_shard_rays_tile_the_frame(scene, layout, n):
    """The ranks' rays, halo rows left out, are the frame's rays, each once
    (as directions of the same pixels: the frame's own set)."""
    o, d = primary_rays(scene.cfg, scene.origin, scene.euler, b2.FRAME_NUMBER)[:2]
    rays = [b2.shard_rays(scene, layout, n, r) for r in range(n)]
    per_rank = o.shape[0] // n
    halo = scene.cfg.width if layout == "rows" else (block_geometry(scene.cfg)[2] // n) * block_geometry(scene.cfg)[0]
    main = torch.cat([rd[:per_rank] for _, rd in rays])
    assert all(rd.shape[0] == per_rank + halo for _, rd in rays)

    def rows(t):
        a = t.numpy().view(np.int32)
        return a[np.lexsort(a.T)]

    np.testing.assert_array_equal(rows(main), rows(d))


def test_shard_projection_record(scene):
    res = b2.project(scene, ns=(2, 5), repeats=1, frames=1)
    assert res["rows"][5] == {"refused": "24 pre-remap rows do not divide 5 ranks"}
    assert res["cyclic"][5] == {"refused": "2 pixel blocks do not divide 5 ranks"}
    one = res["1"]
    assert one["frame_ms"] == one["k1_ms"][0] + one["rest_ms"]
    for layout in b2.LAYOUTS:
        r = res[layout][2]
        assert len(r["k1_ms"]) == 2 and r["imbalance"] >= 1.0
        assert r["frame_ms"] == max(r["k1_ms"]) + r["rest_ms"]
        assert sum(r["rays"]) >= one["rays"][0]


def test_block_geometry_at_1080p_is_jaxs():
    from voxelengine_tpu.config import RenderConfig as JCfg
    from voxelengine_tpu.render.frame import block_geometry as jgeom

    for cb in (True, False):
        cfg = RenderConfig(width=1920, height=1080, checkerboard=cb)
        assert tuple(block_geometry(cfg)) == tuple(jgeom(JCfg(width=1920, height=1080, checkerboard=cb)))
    assert tuple(block_geometry(RenderConfig(width=1920, height=1080, checkerboard=True))) == b3.GEOMETRY_1080P


def test_cyclic_frames_byte_equal_on_two_ranks(tmp_path):
    """The check's logic: 2 gloo ranks on the CPU, a 128x64x128 world at 2
    octaves, 256x128 (16 blocks of 32x32, 8 a rank), both parities."""
    rec = b3.run(device="cpu", ranks=2, dims=(128, 64, 128), octaves=2, width=256, height=128,
                 workdir=str(tmp_path), timeout=300)
    assert rec["ok"] and rec["byte_diffs"] == [0, 0]
    assert rec["geometry"] == [32, 32, 16] and rec["blocks_per_rank"] == [8, 8]
    assert all(0.0 < z < 1.0 for z in rec["nonzero"])


def test_demo_render_and_png(scene):
    img = b4.render(scene)
    assert img.dtype == np.uint8 and img.shape == (48, 64, 3) and 0 < int(img.max())
    np.testing.assert_array_equal(b4.decode_png(b4._encode_png(img)), img)
    assert b4.name("huge", True, 4, True) == "demo_16k_terrain_1080p_shadows_ao4_refl.png"
    ref = b4.DOCS / b4.name("full", False, 0, False)
    assert b4.decode_png(ref.read_bytes()).shape == (1080, 1920, 3)
    with pytest.raises(ValueError):
        b4.decode_png(b"not a png")


def test_render_demo_refuses_docs(tmp_path):
    with pytest.raises(SystemExit, match="docs"):
        b4.main(["full", str(b4.DOCS / "x.png")])


def test_np_pack_bits_bit_equal_to_jax(rng):
    from voxelengine_tpu.core.bitgrid import np_pack_bits as jax_np_pack_bits
    from voxelengine_tpu_torch.core.bitgrid import np_pack_bits, pack_bits

    bits = rng.random((4, 96)) < 0.4
    got = np_pack_bits(bits)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jax_np_pack_bits(bits))
    np.testing.assert_array_equal(got.view(np.int32), pack_bits(torch.from_numpy(bits)).reshape(-1).numpy())


def test_aabb_contains_bit_equal_to_jax(rng):
    import jax.numpy as jnp

    from voxelengine_tpu.ops.aabb import aabb_contains as jax_contains
    from voxelengine_tpu_torch.ops.aabb import aabb_contains

    pos = (rng.random((500, 3)) * 12 - 2).astype(np.float32)
    pos[:20] = np.float32([0.0, 8.0, 3.0])  # on the box's faces: inclusive
    bmin, bmax = np.float32([0.0, 0.0, 0.0]), np.float32([8.0, 8.0, 8.0])
    got = aabb_contains(torch.from_numpy(pos), torch.from_numpy(bmin), torch.from_numpy(bmax))
    want = np.asarray(jax_contains(jnp.asarray(pos), jnp.asarray(bmin), jnp.asarray(bmax)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:20].all() and not got.all()
