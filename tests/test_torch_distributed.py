"""The port's z-sharded world (``voxelengine_tpu_torch/parallel/
distributed.py``) on 4 gloo ranks against the JAX package on a 4-device CPU
mesh, with the JAX package's test shapes (``tests/test_distributed.py``: a
64^3 world at factor 8, 1,024 rays): ``shard_world_z``, the migration trace
(random and axis-aligned rays), ``make_zsharded_hbm``'s tables, the
replicated walk through K1's plain version (random world, geometry in one
slab, the corner graze on a slab boundary) and the z-sharded frames, bit
for bit; the two frames with secondary rays at JAX's own tolerances against
the single-device frames.  Also: the port's sharded results against its
own single-device traces and frames, one round of the plain slab walk
(``ops/trace.py::run_slab``) against JAX's ``_run_loop(slab=)`` state, a
ray entering on the grid's far z face (traced by the port as the whole grid
traces it), and K4-slab's host build (``csrc/zslab.cuh`` through
``dda_host.cpp``, g++) against the plain slab walk: where each ray pauses,
its state after every round and the final results.

The JAX side runs once, in a subprocess with 4 virtual CPU devices whose
XLA:CPU neither contracts FMAs nor runs the algebraic simplifier
(``tests/test_torch_render.py`` module doc), Pallas in interpret mode; the
port's side runs once, in 4 ranks (``parallel/mesh.py::run_ranks``) of
``parallel/cases.py::run_cases``, while the JAX side runs.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import build_brickmap
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.kernels import bmtrace, build
from voxelengine_tpu_torch.ops.trace import (
    SLAB_CELL_Z,
    _dims,
    _edge_pad,
    _init_state,
    _ray_setup,
    kernel_result,
    run_slab,
    trace_brickmap,
    unpack_slab_state,
)
from voxelengine_tpu_torch.parallel import distributed
from voxelengine_tpu_torch.parallel.cases import render_config, run_cases
from voxelengine_tpu_torch.parallel.mesh import run_ranks

ROOT = Path(__file__).resolve().parent.parent
N = 4  # ranks, and JAX devices
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")
STATE_KEYS = ("active", "in_fine", "hit", "imm", "hit_imm", "steps", "ccell", "ctmax", "centry_t", "fcell", "ftmax",
              "fstart", "fpos", "fpad", "fsteps", "cnorm", "fnorm", "pos_out", "norm_out", "start_c", "d", "tdelta",
              "step_sign", "cpad", "start_normal")
FIELDS = ("hit", "position", "normal", "steps")
# tests/test_distributed.py's frames: (RenderConfig fields, origin, euler, frame numbers)
# (its second camera, (-0.6, 0.4, 0), is one where torch's and XLA's sin
# differ by an ulp, held to 2 ulp in tests/test_torch_render.py; the
# frames here take the first camera's angles)
CAM_A = ([96.0, 80.0, 96.0], [-0.6, 0.7, 0.0])
CAM_B = ([32.0, 48.0, 32.0], [-0.6, 0.7, 0.0])
FRAMES = {
    "migration": (dict(width=128, height=64, checkerboard=True), CAM_A, (0, 1)),
    "zw_primary": (dict(width=64, height=32, checkerboard=True), CAM_B, (0,)),
    "secondary": (dict(width=32, height=16, checkerboard=False, shadow_rays=True, ao_samples=2), CAM_B, (0,)),
    "reflections": (dict(width=32, height=16, checkerboard=False, reflections=True), CAM_B, (0,)),
}
# which path renders each frame: migration (False) or the replicated walk
# (True); the JAX side renders the replicated walk's secondary frame only
# in its own test (Pallas' interpret mode there costs ~30 s), and the
# port's is held to JAX's migration frame at JAX's tolerance
ZW = {"migration": (False,), "zw_primary": (True,), "secondary": (False, True), "reflections": (False,)}
JAX_ZW = {"migration": (False,), "zw_primary": (True,), "secondary": (False,), "reflections": (False,)}
CORNERS = [
    # +diagonal: grazes (32,32,31) in slab 1, enters (32,32,32) in slab 2
    ([23.5, 23.5, 23.5], [1.0, 1.0, 1.0], (32, 32, 31), (32, 32, 32)),
    # -diagonal: grazes (31,31,32) in slab 2, enters (31,31,31) in slab 1
    ([40.5, 40.5, 40.5], [-1.0, -1.0, -1.0], (31, 31, 32), (31, 31, 31)),
]


def _world_and_rays(rng, n=1024):
    """``tests/test_distributed.py::_world_and_rays`` in numpy."""
    dense = rng.random((64, 64, 64)) < 0.01
    dense[:, :5, :] = rng.random((64, 5, 64)) < 0.5
    origins = (rng.random((n, 3)) * 120 - 30).astype(np.float32)
    t = (rng.random((n, 3)) * 64).astype(np.float32)
    d = t - origins
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dense, origins, d.astype(np.float32)


def _inputs():
    """Every input of both sides, from numpy seeds."""
    rng = np.random.default_rng(0xC0FFEE)
    dense, o, d = _world_and_rays(rng)
    n = 256
    xs = (rng.random(n) * 60 + 2).astype(np.float32)
    ys = (rng.random(n) * 20 + 2).astype(np.float32)
    ao = np.stack([xs, ys, np.full(n, 63.5, np.float32)], -1)
    ad = np.tile(np.asarray([[0.0, 0.0, -1.0]], np.float32), (n, 1))
    slab = np.zeros((64, 64, 64), bool)
    slab[16:24, :, :] = rng.random((8, 64, 64)) < 0.1  # geometry in one z-slab only
    corners = []
    for _, _, grazed, entered in CORNERS:
        c = np.zeros((64, 64, 64), bool)
        for x, y, z in (grazed, entered):
            c[z, y, x] = True
        corners.append(c)
    return dict(dense=dense, o=o, d=d, ao=ao, ad=ad, slab=slab, corners=corners)


def _corner_rays(inp, i):
    """Corner case ``i``'s ray first, then the random batch's rays to the
    batch's size (one shape for every replicated-walk trace)."""
    co, cd, _, _ = CORNERS[i]
    return (np.concatenate([np.asarray([co], np.float32), inp["o"][1:]]),
            np.concatenate([np.asarray([cd], np.float32), inp["d"][1:]]))


def _jax_reference():
    """JAX side (runs in the subprocess, module doc)."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from voxelengine_tpu.config import Environment, RenderConfig
    from voxelengine_tpu.core.bitgrid import BitGrid as JGrid
    from voxelengine_tpu.core.brickmap import build_brickmap as jbuild
    from voxelengine_tpu.core.layout import Layout as JLayout
    from voxelengine_tpu.ops.trace import _init_state as j_init, _run_loop
    from voxelengine_tpu.parallel import distributed as jd
    from voxelengine_tpu.render.frame import make_framebuffer

    mesh = Mesh(np.asarray(jax.devices()[:N]), ("shards",))
    inp = _inputs()
    out = {}

    def world(dense, name):
        bm = jbuild(JGrid.from_dense(dense), 8, coarse_layout=JLayout.LINEAR)
        for k in BM_KEYS:
            v = getattr(bm, k)
            out[f"{name}/bm/{k}"] = np.asarray(getattr(v, "value", v))
        return bm

    def put(key, res):
        for f in FIELDS:
            out[f"{key}/{f}"] = np.asarray(getattr(res, f))

    bm = world(inp["dense"], "w1")
    o, d = jnp.asarray(inp["o"]), jnp.asarray(inp["d"])
    meta, bricks, slab_gz = jd.shard_world_z(bm, N)
    out["shard/meta"], out["shard/bricks"], out["shard/slab_gz"] = np.asarray(meta), np.asarray(bricks), slab_gz
    put("zsharded", jd.trace_brickmap_zsharded(bm, o, d, mesh))
    put("axis", jd.trace_brickmap_zsharded(bm, jnp.asarray(inp["ao"]), jnp.asarray(inp["ad"]), mesh))

    # one round of the slab walk on each slab: the rays it owns from their entry cell
    spec = bm.grid_dims + (bm.factor, bm.coarse_layout, bm.brick_layout)
    gz = bm.grid_dims[2]

    @jax.jit
    def one_round(meta_k, bricks_k, k, o, d):  # rays as arguments: XLA would fold constants differently
        bm_local = jd._slab_bm(spec, meta_k, bricks_k, slab_gz)
        st = j_init(bm_local, o, d, full_gz=gz)
        owned = jnp.clip(st.ccell[:, 2] // slab_gz, 0, N - 1) == k
        return _run_loop(bm_local, st._replace(active=st.active & owned), 2048, 2 * 2048 + 8,
                         slab=(k * slab_gz, gz))

    for k in range(N):
        st = one_round(meta[k], bricks[k], jnp.int32(k), o, d)
        for f in STATE_KEYS:
            out[f"round{k}/{f}"] = np.asarray(getattr(st, f))

    zw = jd.make_zsharded_hbm(bm, N)
    for f in ("brick_lines", "region_lines", "macro", "macro2"):
        out[f"tables/{f}"] = np.asarray(getattr(zw, f + "_stack"))
    lines = zw.brick_lines_stack.shape[1]

    def replicated(key, zw_k, o_k, d_k):
        # zero brick lines past the slabs' own change nothing and let every
        # world share one compile of the interpreted kernel
        pad = lines - zw_k.brick_lines_stack.shape[1]
        zw_k = dataclasses.replace(zw_k, brick_lines_stack=jnp.pad(zw_k.brick_lines_stack, ((0, 0), (0, pad), (0, 0))))
        put(key, jd.trace_brickmap_hbm_zsharded(zw_k, o_k, d_k, mesh, 512, tile=256, num_slots=4))

    replicated("hbm_random", zw, o, d)
    replicated("hbm_slab", jd.make_zsharded_hbm(world(inp["slab"], "slab"), N), o, d)
    for i in range(len(CORNERS)):
        co, cd = _corner_rays(inp, i)
        replicated(f"corner{i}", jd.make_zsharded_hbm(world(inp["corners"][i], f"corner{i}"), N), jnp.asarray(co),
                   jnp.asarray(cd))
    zw = jax.device_put(zw, NamedSharding(mesh, P("shards")))

    env = Environment.default()
    for name, (fields, (origin, euler), frames) in FRAMES.items():
        cfg = RenderConfig(staged_trace=False, **fields)
        for use_zw in JAX_ZW[name]:
            fb = make_framebuffer(cfg)
            for fn in frames:
                fb = jd.render_frame_zsharded(bm, fb, jnp.asarray(origin, jnp.float32),
                                              jnp.asarray(euler, jnp.float32), env, jnp.int32(fn), cfg, mesh,
                                              zw=zw if use_zw else None)
                out[f"frame/{name}/{int(use_zw)}/{fn}"] = np.asarray(fb)
    return out


def _cases(ref):
    """The port's side: the same entries, as ``run_cases`` cases."""
    inp = _inputs()
    worlds = {w: {k: ref[f"{w}/bm/{k}"] for k in BM_KEYS} for w in ("w1", "slab", "corner0", "corner1")}
    cases = [
        ("zsharded", "zsharded", dict(world="w1", origins=inp["o"], rays=inp["d"], max_steps=2048)),
        ("axis", "zsharded", dict(world="w1", origins=inp["ao"], rays=inp["ad"], max_steps=2048)),
        ("tables", "hbm_tables", dict(world="w1")),
        ("hbm_random", "hbm_zsharded", dict(world="w1", origins=inp["o"], rays=inp["d"], max_steps=512)),
        ("hbm_slab", "hbm_zsharded", dict(world="slab", origins=inp["o"], rays=inp["d"], max_steps=512)),
    ]
    for i in range(len(CORNERS)):
        co, cd = _corner_rays(inp, i)
        cases.append((f"corner{i}", "hbm_zsharded", dict(world=f"corner{i}", origins=co, rays=cd, max_steps=512)))
    for name, (fields, (origin, euler), frames) in FRAMES.items():
        for use_zw in ZW[name]:
            cases.append((f"frame/{name}/{int(use_zw)}", "frame_zsharded",
                          dict(world="w1", cfg=fields, origin=origin, euler=euler, frames=frames, zw=use_zw)))
    return worlds, cases


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both(tmp_path_factory):
    """``(jax, ranks, worlds)``: the JAX side's arrays, each rank's results
    of the port's side, run at the same time (module doc), and the port's
    worlds."""
    path = tmp_path_factory.mktemp("jax_ref") / "distributed_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu",
        XLA_FLAGS=f"--xla_force_host_platform_device_count={N} --xla_cpu_max_isa=AVX "
                  "--xla_disable_hlo_passes=algsimp",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.Popen([sys.executable, __file__, str(path)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    # the worlds are the port's own builds of the same numpy occupancy
    inp = _inputs()
    port_worlds = {
        "w1": inp["dense"], "slab": inp["slab"], "corner0": inp["corners"][0], "corner1": inp["corners"][1],
    }
    ref_worlds = {}
    for w, dense in port_worlds.items():
        bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(dense)), 8, coarse_layout=Layout.LINEAR)
        ref_worlds.update({f"{w}/bm/{k}": _field(getattr(bm, k)) for k in BM_KEYS})
    worlds, cases = _cases(ref_worlds)
    try:
        ranks = run_ranks(run_cases, N, "gloo", "cpu", worlds, cases, timeout=600)
    finally:
        log, _ = proc.communicate(timeout=900)
    assert proc.returncode == 0, log
    with np.load(path) as z:
        jax_ref = {k: z[k] for k in z.files}
    for r in ranks[1:]:  # every rank ends with the same results
        for k, v in ranks[0].items():
            if not k.endswith("/moved"):
                np.testing.assert_array_equal(r[k], v, err_msg=k)
    return jax_ref, ranks, ref_worlds


def _field(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(getattr(v, "value", v))


def _bm(ref, world):
    return brickmap_from_numpy({k: ref[f"{world}/bm/{k}"] for k in BM_KEYS}, device="cpu")


def _same(got, want, key, fields=FIELDS):
    for f in fields:
        np.testing.assert_array_equal(got[f"{key}/{f}"], want[f"{key}/{f}"], err_msg=f"{key}/{f}")


def test_worlds_are_the_jax_packages(both):
    jax_ref, _, port = both
    for w in ("w1", "slab", "corner0", "corner1"):
        for k in BM_KEYS:
            want = jax_ref[f"{w}/bm/{k}"]
            np.testing.assert_array_equal(port[f"{w}/bm/{k}"], want.view(np.int32) if want.dtype == np.uint32 else want,
                                          err_msg=f"{w}/{k}")


def test_shard_world_z_matches_jax(both):
    jax_ref, _, _ = both
    meta, bricks, slab_gz = distributed.shard_world_z(_bm(jax_ref, "w1"), N)
    assert slab_gz == int(jax_ref["shard/slab_gz"]) == 2
    np.testing.assert_array_equal(meta.numpy(), jax_ref["shard/meta"])
    np.testing.assert_array_equal(bricks.numpy(), jax_ref["shard/bricks"].view(np.int32))


@pytest.mark.parametrize("key", ["zsharded", "axis"])
def test_migration_trace_bit_equal_to_jax_and_single_device(both, key):
    """Random rays and axis-aligned rays through every slab: the port's
    migration equals JAX's 4-device trace and the port's single-device
    ``trace_brickmap`` on every field, and rays really migrated."""
    jax_ref, ranks, _ = both
    port = ranks[0]
    _same(port, jax_ref, key)
    inp = _inputs()
    o, d = (inp["o"], inp["d"]) if key == "zsharded" else (inp["ao"], inp["ad"])
    single = trace_brickmap(_bm(jax_ref, "w1"), torch.from_numpy(o), torch.from_numpy(d))
    for f, v in zip(FIELDS, single):
        np.testing.assert_array_equal(port[f"{key}/{f}"], v.numpy(), err_msg=f)
    assert sum(r[f"{key}/moved"].sum() for r in ranks) > 0 and port[f"{key}/hit"].any()


def test_make_zsharded_hbm_tables_bit_equal_to_jax(both):
    """Each rank's own row, gathered, equals JAX's stacked tables; so does
    the port's stacked form."""
    jax_ref, ranks, _ = both
    port = ranks[0]
    stacked = distributed.make_zsharded_hbm(_bm(jax_ref, "w1"), N)
    for f in ("brick_lines", "region_lines", "macro", "macro2"):
        np.testing.assert_array_equal(port[f"tables/{f}"], jax_ref[f"tables/{f}"], err_msg=f)
        np.testing.assert_array_equal(getattr(stacked, f + "_stack").numpy(), jax_ref[f"tables/{f}"], err_msg=f)


@pytest.mark.parametrize("key", ["hbm_random", "hbm_slab", "corner0", "corner1"])
def test_replicated_walk_bit_equal_to_jax(both, key):
    """K1's replicated walk (its plain macro walk here) equals JAX's on
    every field, steps included (the steps delta is the same walk's)."""
    jax_ref, ranks, _ = both
    port = ranks[0]
    _same(port, jax_ref, key)
    assert port[f"{key}/hit"].any()


def test_replicated_walk_against_single_device(both):
    """Hits, positions and normals equal the port's single-device K1 plain
    walk; steps never exceed it, and are equal when the geometry lies in
    one slab."""
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, trace_brickmap_lt

    jax_ref, ranks, _ = both
    port = ranks[0]
    inp = _inputs()
    o, d = torch.from_numpy(inp["o"]), torch.from_numpy(inp["d"])
    for key, world in (("hbm_random", "w1"), ("hbm_slab", "slab")):
        bm = _bm(jax_ref, world)
        ref = trace_brickmap_lt(bm, make_line_table(bm), o, d, 512)
        hit = ref.hit.numpy()
        np.testing.assert_array_equal(port[f"{key}/hit"], hit)
        np.testing.assert_array_equal(port[f"{key}/position"][hit], ref.position.numpy()[hit])
        np.testing.assert_array_equal(port[f"{key}/normal"][hit], ref.normal.numpy()[hit])
        assert (port[f"{key}/steps"] <= ref.steps.numpy()).all()
        if key == "hbm_slab":
            np.testing.assert_array_equal(port[f"{key}/steps"], ref.steps.numpy())
    for i in range(len(CORNERS)):
        np.testing.assert_array_equal(port[f"corner{i}/position"][0], [32.0, 32.0, 32.0])


@pytest.mark.parametrize("name,use_zw", [(n, z) for n in FRAMES for z in ZW[n]])
def test_zsharded_frames_against_jax(both, name, use_zw):
    """Bit for bit, but for the replicated walk's frame with shadow and AO
    rays: it is held to JAX's migration frame (JAX's single-device frame to
    1e-6) at 3e-2, the tolerance of JAX's own test of that frame."""
    jax_ref, ranks, _ = both
    port = ranks[0]
    for fn in FRAMES[name][2]:
        key = f"frame/{name}/{int(use_zw)}/{fn}"
        if use_zw in JAX_ZW[name]:
            np.testing.assert_array_equal(port[key], jax_ref[key], err_msg=key)
        else:
            np.testing.assert_allclose(port[key], jax_ref[f"frame/{name}/0/{fn}"], rtol=0, atol=3e-2, err_msg=key)


@pytest.mark.parametrize("name,use_zw", [(n, z) for n in FRAMES for z in ZW[n]])
def test_zsharded_frames_against_single_device(both, name, use_zw):
    """The z-sharded frames against the port's single-device
    ``render_frame`` (with a line table for the replicated walk), at JAX's
    tolerances (``tests/test_distributed.py:243-341``): exact for primary
    rays, 1e-6 for the migration frames, 3e-2 for the replicated walk's AO
    (its per-slab step budget on 8-step AO rays)."""
    from voxelengine_tpu_torch.config import Environment
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table
    from voxelengine_tpu_torch.render.frame import make_framebuffer, render_frame

    jax_ref, ranks, _ = both
    port = ranks[0]
    fields, (origin, euler), frames = FRAMES[name]
    cfg = render_config(fields)
    bm = _bm(jax_ref, "w1")
    env = Environment.default(device="cpu")
    fb = make_framebuffer(cfg, device="cpu")
    for fn in frames:
        render_frame(bm, fb, torch.tensor(origin), torch.tensor(euler), env, fn, cfg,
                     lt=make_line_table(bm) if use_zw else None)
        got = port[f"frame/{name}/{int(use_zw)}/{fn}"]
        if use_zw and name == "secondary":
            np.testing.assert_allclose(got, fb.numpy(), rtol=0, atol=3e-2)
        elif use_zw:
            np.testing.assert_array_equal(got, fb.numpy())
        else:
            np.testing.assert_allclose(got, fb.numpy(), rtol=0, atol=1e-6)


def test_one_slab_round_matches_jax_run_loop(both):
    """One round of ``run_slab`` on each slab (its rays from their entry
    cell) leaves JAX's ``_run_loop(slab=)`` state, every field."""
    jax_ref, _, _ = both
    bm = _bm(jax_ref, "w1")
    meta, bricks, slab_gz = distributed.shard_world_z(bm, N)
    spec = bm.grid_dims + (bm.factor, bm.coarse_layout, bm.brick_layout)
    inp = _inputs()
    o, d = torch.from_numpy(inp["o"]), torch.from_numpy(inp["d"])
    gz = bm.grid_dims[2]
    paused = 0
    for k in range(N):
        local = distributed._slab_bm(spec, meta[k], bricks[k], slab_gz)
        st = _init_state(local, o, d, full_gz=gz)
        st["active"] = st["active"] & (torch.clamp(st["ccell"][:, 2] // slab_gz, 0, N - 1) == k)
        rows, status, *_ = run_slab(local, st, 2048, k * slab_gz, gz)
        st = unpack_slab_state(rows)
        for f in STATE_KEYS:
            np.testing.assert_array_equal(st[f].numpy(), jax_ref[f"round{k}/{f}"], err_msg=f"slab {k} {f}")
        paused += int(status.sum())
    assert paused > 0


def _far_face_world():
    """Rays entering a 64-chunk-deep grid (2x2x64 chunks at factor 8, half
    the top voxel layer and all of the bottom one solid) through its far z
    face, heading down."""
    rng = np.random.default_rng(5)
    dense = np.zeros((512, 16, 16), bool)  # [z, y, x]: a 2x2x64-chunk grid at factor 8
    dense[-1] = rng.random((16, 16)) < 0.5  # half the top voxel layer
    dense[0] = True  # the bottom layer, under every slab
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(dense)), 8, coarse_layout=Layout.LINEAR)
    n = 64
    o = torch.from_numpy(np.stack([rng.random(n) * 14 + 1, rng.random(n) * 14 + 1, np.full(n, 600.0)], -1)
                         .astype(np.float32))
    d = torch.tensor([[0.0, 0.0, -1.0]]).expand(n, 3).contiguous()
    return bm, o, d


def test_far_face_entry_traced_as_the_whole_grid():
    """Rays entering a 64-chunk-deep grid through its far z face heading
    down start in the edge pad cell z == gz (the clip's gz - 1e-6 rounds
    to gz).  The last slab traces them as the whole grid does (JAX's
    migration pauses them everywhere and reports a miss); plain walk, one
    process, hand-offs simulated by running the slabs in order."""
    bm, o, d = _far_face_world()
    n = o.shape[0]
    want = trace_brickmap(bm, o, d)
    assert (_init_state(bm, o, d)["ccell"][:, 2] == 64).all() and want.hit.all()
    gz, slabs = 64, 4
    meta, bricks, slab_gz = distributed.shard_world_z(bm, slabs)
    spec = bm.grid_dims + (bm.factor, bm.coarse_layout, bm.brick_layout)
    st0 = _init_state(distributed._slab_bm(spec, meta[0], bricks[0], slab_gz), o, d, full_gz=gz)
    src, idx = st0, torch.arange(n)
    flags, steps = torch.zeros(n, dtype=torch.int32), torch.zeros(n, dtype=torch.int32)
    pos, nrm = torch.zeros(n, 3), torch.zeros(n, 3)
    for k in reversed(range(slabs)):  # downward rays: the top slab first
        rows, status, *res = run_slab(distributed._slab_bm(spec, meta[k], bricks[k], slab_gz), src, 2048,
                                      k * slab_gz, gz)
        done = status == 0
        for acc, r in zip((flags, pos, nrm, steps), res):
            acc[idx[done]] = r[done]
        assert (rows[~done, SLAB_CELL_Z] < k * slab_gz).all()  # paused at the slab's floor, for the slab below
        src, idx = rows[~done], idx[~done]
    assert idx.numel() == 0
    got = kernel_result(flags, pos, nrm, steps, st0["start_c"], st0["start_normal"], bm.factor)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (got.position[:, 2] < 8).any() and (got.position[:, 2] > 500).any()  # hits on both layers


# ------------------------------------------------- K4-slab's host build


def _host_round(lib, local_meta, local_bricks, grid, z0, slab_gz, factor, layout, max_steps, rays=None, rows=None):
    """One round of K4-slab's host build over a slab.  Rows of rays that
    are done stay as allocated (zeros): the round writes paused rows only."""
    m = (rays[0] if rays is not None else rows).shape[0]
    rows_out = torch.zeros((m, bmtrace.STATE_WORDS), dtype=torch.int32)
    status = torch.zeros((m,), dtype=torch.int32)
    outs = build.ray_outputs(m, "cpu")
    ptrs = [t.data_ptr() for t in rays] + [None] if rays is not None else [None] * 4 + [rows.data_ptr()]
    wpb = (factor**3 + 31) // 32
    rc = lib.vx_zslab_host(*ptrs, local_meta.data_ptr(), local_bricks.data_ptr(), m, *grid, z0, slab_gz, factor, wpb,
                           max_steps, layout.value, 3 * max_steps + 64, None, rows_out.data_ptr(), status.data_ptr(),
                           *(o.data_ptr() for o in outs))
    assert rc == 0
    return rows_out, status, outs


def _slab_rounds(bm, o, d, slabs, max_steps):
    """The migration of rays ``o``, ``d`` over ``bm`` cut into ``slabs``
    z-slabs, round by round, through K4-slab's host build and the plain
    slab walk side by side, hand-offs simulated in
    one process: each round both pause the same rays at the same coarse
    cell, tMax, entry time and step count, and finish the others with the
    same results.  Returns the final results and the paused rays of each
    round."""
    lib = build.load_dda_host()
    meta, bricks, slab_gz = distributed.shard_world_z(bm, slabs)
    spec = bm.grid_dims + (bm.factor, bm.coarse_layout, bm.brick_layout)
    grid = bm.grid_dims
    gz = grid[2]
    n = o.shape[0]
    dd, start_c, start_normal, active = _ray_setup(grid, bm.factor, o, d)
    pad = _edge_pad(start_c.to(torch.int32), _dims(grid, torch.int32, "cpu"), dd)
    st0 = _init_state(distributed._slab_bm(spec, meta[0], bricks[0], slab_gz), o, d, full_gz=gz)
    owner = torch.clamp(st0["ccell"][:, 2] // slab_gz, 0, slabs - 1)
    flags = torch.zeros(n, dtype=torch.int32)
    pos, nrm, steps = torch.zeros(n, 3), torch.zeros(n, 3), torch.zeros(n, dtype=torch.int32)
    pending = {k: torch.nonzero(active & (owner == k)).squeeze(1) for k in range(slabs)}
    rows = {k: None for k in range(slabs)}
    plain = {k: {key: v[pending[k]] for key, v in st0.items()} for k in range(slabs)}
    paused_per_round = []
    for rnd in range(slabs):
        moved = {k: ([], [], []) for k in range(slabs)}
        paused_per_round.append(0)
        for k in range(slabs):
            idx = pending[k]
            local = distributed._slab_bm(spec, meta[k], bricks[k], slab_gz)
            args = (lib, meta[k], bricks[k], grid, k * slab_gz, slab_gz, bm.factor, bm.brick_layout, max_steps)
            if rnd == 0:
                sel = (start_c[idx].contiguous(), dd[idx].contiguous(), active[idx].to(torch.int32),
                       pad[idx].contiguous())
                rows_out, status, outs = _host_round(*args, rays=sel)
            else:
                rows_out, status, outs = _host_round(*args, rows=rows[k])
            p_rows, p_status, *p_res = run_slab(local, plain[k], max_steps, k * slab_gz, gz)
            assert torch.equal(status, p_status), f"round {rnd} slab {k}: pause points differ"
            paused = status == 1
            paused_per_round[-1] += int(paused.sum())
            # a paused ray's state: coarse cell, tMax, entry time, steps
            ps = unpack_slab_state(p_rows)
            cc = ps["ccell"]
            assert torch.equal(rows_out[paused, bmtrace.STATE_CELL], cc[paused])
            assert torch.equal(rows_out[paused, bmtrace.STATE_TMAX].view(torch.float32), ps["ctmax"][paused])
            assert torch.equal(rows_out[paused, bmtrace.STATE_TLAST].view(torch.float32), ps["centry_t"][paused])
            assert torch.equal(rows_out[paused, bmtrace.STATE_STEPS], ps["steps"][paused])
            # a done ray's result, and no state row written for it
            done = ~paused
            assert not rows_out[done].any(), f"round {rnd} slab {k}: a done ray's row was written"
            kr = kernel_result(*outs, start_c[idx], start_normal[idx], bm.factor)
            pr = kernel_result(*p_res, start_c[idx], start_normal[idx], bm.factor)
            for g, w in zip(kr, pr):
                assert torch.equal(g[done], w[done]), f"round {rnd} slab {k}"
            flags[idx[done]], pos[idx[done]], nrm[idx[done]], steps[idx[done]] = (
                outs[0][done], outs[1][done], outs[2][done], outs[3][done])
            for j in torch.nonzero(paused).squeeze(1).tolist():
                t = int(torch.clamp(cc[j, 2] // slab_gz, 0, slabs - 1))
                moved[t][0].append(int(idx[j]))
                moved[t][1].append(rows_out[j])
                moved[t][2].append(p_rows[j])
        for k in range(slabs):
            ids, rs, prs = moved[k]
            pending[k] = torch.tensor(ids, dtype=torch.long)
            rows[k] = torch.stack(rs) if rs else torch.zeros((0, bmtrace.STATE_WORDS), dtype=torch.int32)
            plain[k] = torch.stack(prs) if prs else p_rows[:0]
    assert all(p.numel() == 0 for p in pending.values())
    return kernel_result(flags, pos, nrm, steps, start_c, start_normal, bm.factor), paused_per_round


def _assert_whole_grid(got, bm, o, d, max_steps=2048):
    want = trace_brickmap(bm, o, d, max_steps)
    for f, g, w in zip(FIELDS, got, want):
        assert torch.equal(g, w), f
    return want


def _random_rays_and_axis_rays():
    inp = _inputs()
    o = torch.cat([torch.from_numpy(inp["o"]), torch.from_numpy(inp["ao"])])
    d = torch.cat([torch.from_numpy(inp["d"]), torch.from_numpy(inp["ad"])])
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(inp["dense"])), 8, coarse_layout=Layout.LINEAR)
    return bm, o, d


@pytest.mark.parametrize("max_steps", [2048, 24])
def test_k4_slab_host_build_matches_plain_slab_walk(max_steps):
    """Round by round over 4 slabs: the host build of K4-slab and the plain
    walk pause the same rays at the same coarse cell, tMax, entry time and
    step count, and finish the others with the same results; the final
    results equal the single-device trace.  ``max_steps=24`` cuts rays by
    their budget."""
    bm, o, d = _random_rays_and_axis_rays()
    got, paused = _slab_rounds(bm, o, d, N, max_steps)
    assert sum(paused) > 0
    want = _assert_whole_grid(got, bm, o, d, max_steps)
    if max_steps == 24:
        assert ((want.steps == 24) & ~want.hit).any()


def test_k4_slab_host_build_pauses_at_every_slab_boundary():
    """Rays along +z and -z through empty columns of a 4-slab grid pause at
    each of its 3 inner boundaries, one round after another, and finish in
    the last slab they enter: the pause is asked after every coarse step in
    z, here the only steps there are."""
    dense = np.zeros((64, 64, 64), bool)  # [z, y, x]
    dense[:, :4, :] = True  # a floor, under the rays
    dense[-2:, 40:, :32] = True  # a block at the far end of some upward rays
    dense[:2, 40:, 32:] = True  # and of some downward rays
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(dense)), 8, coarse_layout=Layout.LINEAR)
    rng = np.random.default_rng(11)
    n = 64
    xy = rng.random((n, 2)) * [24.0, 52.0] + [4.0, 8.0]  # x in [4, 28), above the floor
    xy[n // 2:, 0] += 32.0  # the downward rays' x in [36, 60)
    up = np.concatenate([xy[: n // 2], np.full((n // 2, 1), -5.0)], 1)
    down = np.concatenate([xy[n // 2:], np.full((n // 2, 1), 70.0)], 1)
    o = torch.from_numpy(np.concatenate([up, down]).astype(np.float32))
    d = torch.from_numpy(np.concatenate([np.tile([[0.0, 0.0, 1.0]], (n // 2, 1)),
                                         np.tile([[0.0, 0.0, -1.0]], (n // 2, 1))]).astype(np.float32))
    got, paused = _slab_rounds(bm, o, d, N, 2048)
    assert paused == [n, n, n, 0]
    want = _assert_whole_grid(got, bm, o, d)
    assert want.hit.any() and not want.hit.all()


def test_k4_slab_host_build_on_slabs_one_chunk_deep():
    """A 64x64x32 world at factor 8 in 4 slabs of one chunk row each:
    random and axis rays through it, every round against the plain walk,
    the results the whole grid's."""
    inp = _inputs()
    dense = inp["dense"][:32]
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(np.ascontiguousarray(dense))), 8,
                        coarse_layout=Layout.LINEAR)
    assert bm.grid_dims == (8, 8, 4)
    o = torch.cat([torch.from_numpy(inp["o"]), torch.from_numpy(inp["ao"]) * torch.tensor([1.0, 1.0, 0.5])])
    d = torch.cat([torch.from_numpy(inp["d"]), torch.from_numpy(inp["ad"])])
    got, paused = _slab_rounds(bm, o, d, 4, 2048)
    assert paused[0] > 0 and paused[2] > 0
    _assert_whole_grid(got, bm, o, d)


def test_k4_slab_host_build_traces_the_far_face_pad_cell():
    """The far-face rays of ``test_far_face_entry_traced_as_the_whole_grid``
    (starting in the edge pad cell z == gz, which the last slab owns)
    through K4-slab's host build: every round equals the plain walk and the
    results equal the whole grid's, hits on both layers."""
    bm, o, d = _far_face_world()
    got, paused = _slab_rounds(bm, o, d, 4, 2048)
    assert paused[0] > 0
    _assert_whole_grid(got, bm, o, d)
    assert (got.position[:, 2] < 8).any() and (got.position[:, 2] > 500).any()


def test_k4_slab_host_build_follows_an_edit():
    """An edit of a dense-slot world between two traces: the rounds after
    the edit read the edited slabs' meta and bricks, so they equal the plain
    walk of the edited world, whose results differ from the first trace's."""
    from voxelengine_tpu_torch.core.brickmap import apply_edits

    inp = _inputs()
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(inp["slab"])), 8, coarse_layout=Layout.LINEAR)
    o, d = torch.from_numpy(inp["o"]), torch.from_numpy(inp["d"])
    before, _ = _slab_rounds(bm, o, d, N, 2048)
    # fill a 16^3 block of empty space in slab 2 (z 32..47): new occupied chunks
    g = torch.arange(16)
    x, y, z = (t.reshape(-1) for t in torch.meshgrid(g + 24, g + 24, g + 32, indexing="ij"))
    apply_edits(bm, x, y, z, torch.ones_like(x, dtype=torch.bool))
    after, _ = _slab_rounds(bm, o, d, N, 2048)
    _assert_whole_grid(after, bm, o, d)
    assert not torch.equal(after.hit, before.hit)


def test_dryrun_multichip_on_two_cpu_ranks():
    """``dryrun_multichip``: every multi-device entry once on 2 ranks, the
    replicated walk's hits equal to the migration's."""
    from voxelengine_tpu_torch import entry

    for rec in entry.dryrun_multichip(2, "cpu"):
        assert rec["rows"] == (16, 64, 3) and rec["cyclic"] == (16, 64, 3) and rec["zsharded_frame"] == (16, 32, 3)


def test_bmtrace_slab_refuses_cpu_tensors_and_bad_slabs():
    z = torch.zeros
    rays = (z(4, 3), z(4, 3), z(4, dtype=torch.int32), z(4, 3, dtype=torch.int32))
    kw = dict(grid_dims=(4, 4, 8), slab_gz=2, factor=8, max_steps=16, brick_layout=Layout.TILED_LINEAR)
    before = bmtrace.slab_launches
    with pytest.raises(ValueError, match="CUDA"):
        bmtrace.bmtrace_slab(z(32, dtype=torch.int32), z(32, 16, dtype=torch.int32), z0=0, rays=rays, **kw)
    with pytest.raises(ValueError, match="outside"):
        bmtrace.bmtrace_slab(z(32, dtype=torch.int32), z(32, 16, dtype=torch.int32), z0=7, rays=rays, **kw)
    with pytest.raises(ValueError, match="not both"):
        bmtrace.bmtrace_slab(z(32, dtype=torch.int32), z(32, 16, dtype=torch.int32), z0=0, **kw)
    assert bmtrace.slab_launches == before


def test_zslab_launcher_signature_is_the_host_entrys():
    assert build.HOST_ENTRIES["vx_zslab_host"] == build.SIGNATURES["vx_zslab"]
    assert len(build.SIGNATURES["vx_zslab"]) == 25
    assert isinstance(build.load_dda_host().vx_zslab_host, ctypes._CFuncPtr)


# ------------------------------------------------------------ card lane


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_k4_slab_on_card_matches_plain_slab_walk(cuda_device):
    """K4-slab's round 0 on each slab of the 64^3 world, launched on the
    card, against the plain slab walk: pause points, paused cells and
    steps, and the results of the rays that are done."""
    inp = _inputs()
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(inp["dense"]).to(cuda_device)), 8,
                        coarse_layout=Layout.LINEAR)
    o, d = torch.from_numpy(inp["o"]).to(cuda_device), torch.from_numpy(inp["d"]).to(cuda_device)
    meta, bricks, slab_gz = distributed.shard_world_z(bm, N)
    spec = bm.grid_dims + (bm.factor, bm.coarse_layout, bm.brick_layout)
    gz = bm.grid_dims[2]
    dd, start_c, start_normal, active = _ray_setup(bm.grid_dims, bm.factor, o, d)
    pad = _edge_pad(start_c.to(torch.int32), _dims(bm.grid_dims, torch.int32, cuda_device), dd)
    owner = torch.clamp(start_c.to(torch.int32)[:, 2] // slab_gz, 0, N - 1)
    before = bmtrace.slab_launches
    for k in range(N):
        idx = torch.nonzero(active & (owner == k)).squeeze(1)
        rows, status, *res = bmtrace.bmtrace_slab(
            meta[k], bricks[k], grid_dims=bm.grid_dims, z0=k * slab_gz, slab_gz=slab_gz, factor=bm.factor,
            max_steps=2048, brick_layout=bm.brick_layout,
            rays=(start_c[idx].contiguous(), dd[idx].contiguous(), active[idx].to(torch.int32), pad[idx].contiguous()))
        local = distributed._slab_bm(spec, meta[k], bricks[k], slab_gz)
        p_rows, p_status, *p_res = run_slab(local, _init_state(local, o[idx], d[idx], full_gz=gz), 2048,
                                            k * slab_gz, gz)
        assert torch.equal(status, p_status)
        paused = status == 1
        st = unpack_slab_state(p_rows)
        assert torch.equal(rows[paused, bmtrace.STATE_CELL], st["ccell"][paused])
        assert torch.equal(rows[paused, bmtrace.STATE_STEPS], st["steps"][paused])
        got = kernel_result(*res, start_c[idx], start_normal[idx], bm.factor)
        want = kernel_result(*p_res, start_c[idx], start_normal[idx], bm.factor)
        for g, w in zip(got, want):
            assert torch.equal(g[~paused], w[~paused])
    assert bmtrace.slab_launches == before + N


@pytest.mark.cuda
def test_k4_slab_resumed_round_on_card_matches_plain_slab_walk(cuda_device):
    """K4-slab over the 4 slabs of the 64^3 world with geometry in one
    slab, round 0 then a handed-on round: statuses, paused rows and done
    rays' results == the plain slab walk's, and the launches counted."""
    inp = _inputs()
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(inp["slab"]).to(cuda_device)), 8,
                        coarse_layout=Layout.LINEAR)
    o, d = torch.from_numpy(inp["o"]).to(cuda_device), torch.from_numpy(inp["d"]).to(cuda_device)
    meta, bricks, slab_gz = distributed.shard_world_z(bm, N)
    spec = bm.grid_dims + (bm.factor, bm.coarse_layout, bm.brick_layout)
    gz = bm.grid_dims[2]
    dd, start_c, start_normal, active = _ray_setup(bm.grid_dims, bm.factor, o, d)
    pad = _edge_pad(start_c.to(torch.int32), _dims(bm.grid_dims, torch.int32, cuda_device), dd)
    owner = torch.clamp(start_c.to(torch.int32)[:, 2] // slab_gz, 0, N - 1)
    before = bmtrace.slab_launches
    launched = 0
    for k in range(N):
        idx = torch.nonzero(active & (owner == k)).squeeze(1)
        kw = dict(grid_dims=bm.grid_dims, z0=k * slab_gz, slab_gz=slab_gz, factor=bm.factor, max_steps=2048,
                  brick_layout=bm.brick_layout)
        local = distributed._slab_bm(spec, meta[k], bricks[k], slab_gz)
        rays = (start_c[idx].contiguous(), dd[idx].contiguous(), active[idx].to(torch.int32), pad[idx].contiguous())
        rows, status, *res = bmtrace.bmtrace_slab(meta[k], bricks[k], rays=rays, **kw)
        p_rows, p_status, *p_res = run_slab(local, _init_state(local, o[idx], d[idx], full_gz=gz), 2048,
                                            k * slab_gz, gz)
        launched += idx.numel() > 0
        paused = status == 1
        assert torch.equal(status, p_status)
        st = unpack_slab_state(p_rows)
        assert torch.equal(rows[paused, bmtrace.STATE_CELL], st["ccell"][paused])
        assert torch.equal(rows[paused, bmtrace.STATE_STEPS], st["steps"][paused])
        got = kernel_result(*res, start_c[idx], start_normal[idx], bm.factor)
        want = kernel_result(*p_res, start_c[idx], start_normal[idx], bm.factor)
        for g, w in zip(got, want):
            assert torch.equal(g[~paused], w[~paused])
        # the paused rays resumed from the kernel's rows in this slab again:
        # each pauses at once, where it stood
        if bool(paused.any()):
            again = bmtrace.bmtrace_slab(meta[k], bricks[k], rows=rows[paused].contiguous(), **kw)
            launched += 1
            assert bool((again[1] == 1).all())
            assert torch.equal(again[0][:, :34], rows[paused][:, :34])  # word 34, the iterations, restarts
    assert bmtrace.slab_launches == before + launched


@pytest.mark.cuda
def test_migration_and_replicated_walk_on_two_ranks_sharing_the_card(cuda_device):
    """Two gloo ranks on the one card: the migration (K4-slab) and the
    replicated walk (K1) equal the single-device walks on every field
    (hits, normals and positions for the replicated walk)."""
    from voxelengine_tpu_torch.ops.bigtrace import make_line_table, trace_brickmap_lt

    inp = _inputs()
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(inp["dense"])), 8, coarse_layout=Layout.LINEAR)
    worlds = {"w1": {k: _field(getattr(bm, k)) for k in BM_KEYS}}
    cases = [
        ("zsharded", "zsharded", dict(world="w1", origins=inp["o"], rays=inp["d"], max_steps=2048)),
        ("axis", "zsharded", dict(world="w1", origins=inp["ao"], rays=inp["ad"], max_steps=2048)),
        ("hbm", "hbm_zsharded", dict(world="w1", origins=inp["o"], rays=inp["d"], max_steps=512)),
    ]
    got = run_ranks(run_cases, 2, "gloo", "cuda", worlds, cases, timeout=300)[0]
    for key, (o, d) in (("zsharded", (inp["o"], inp["d"])), ("axis", (inp["ao"], inp["ad"]))):
        want = trace_brickmap(bm, torch.from_numpy(o), torch.from_numpy(d))
        for f, w in zip(FIELDS, want):
            np.testing.assert_array_equal(got[f"{key}/{f}"], w.numpy(), err_msg=f"{key}/{f}")
    want = trace_brickmap_lt(bm, make_line_table(bm), torch.from_numpy(inp["o"]), torch.from_numpy(inp["d"]), 512)
    h = want.hit.numpy()
    np.testing.assert_array_equal(got["hbm/hit"], h)
    np.testing.assert_array_equal(got["hbm/position"][h], want.position.numpy()[h])
    np.testing.assert_array_equal(got["hbm/normal"][h], want.normal.numpy()[h])


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
