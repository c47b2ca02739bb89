"""The PyTorch port's traversal against the JAX package.

Inputs are made from numpy seeds; worlds are built by the JAX package and
handed over as numpy arrays (``io/interop.py``), so both packages trace the
same world with the same rays.

The JAX side runs in a subprocess with two XLA:CPU rewrites switched off.
Each moves a float by an ulp, while the port and the Hopper kernel round
every op of the expressions as written:

* FMA contraction (``--xla_cpu_max_isa=AVX``: no FMA instructions).
  XLA:CPU otherwise fuses ``a*b + c`` (the normalize reduction, the
  ``start + t*d`` entry points) into one FMA.
* The algebraic simplifier (``--xla_disable_hlo_passes=algsimp``).  Inside
  one jitted trace it rewrites ``1 / (v / n)`` into ``n / v`` and
  ``a / (v / n)`` likewise, so ``tdelta`` and ``tMax`` are not computed
  from the normalized direction ``d`` but from the raw ray and its norm;
  it also turns ``x / c`` into ``x * (1/c)``.  The port computes both
  from ``d`` with IEEE division, as the reference's CUDA does.

An ulp in either moves a box-entry point, and through its truncation to
a cell, a step count.  With both off, hits, steps, normals and positions
are bit-equal on every case, including a factor that is not a power of
two.

The kernel's step logic (``csrc/dda.cuh``) is compiled here by g++ with
``-ffp-contract=off`` and held bit-for-bit against the plain torch trace.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.ops.aabb import ray_aabb
from voxelengine_tpu_torch.ops.bigtrace import brick_lines_view, make_line_table, trace_brickmap_hbm, trace_brickmap_lt
from voxelengine_tpu_torch.ops.trace import _edge_pad, _normalize, _ray_setup, trace_brickmap

ROOT = Path(__file__).resolve().parent.parent
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")

# name: (world dims, factor, coarse layout, brick layout, fill, ray count,
#        origin spread, max_steps)
CASES = {
    "coarse_linear": ((64, 64, 64), 8, "LINEAR", "TILED_LINEAR", 0.02, 256, 2.0, 256),
    "coarse_tiled": ((64, 64, 64), 8, "TILED_LINEAR", "TILED_LINEAR", 0.02, 192, 2.0, 200),
    "coarse_morton": ((64, 64, 64), 8, "TILED_MORTON", "TILED_LINEAR", 0.02, 192, 2.0, 200),
    "brick_linear": ((64, 64, 64), 8, "LINEAR", "LINEAR", 0.02, 192, 2.0, 200),
    "brick_morton": ((64, 64, 64), 8, "LINEAR", "TILED_MORTON", 0.02, 192, 2.0, 200),
    "factor16": ((64, 64, 64), 16, "LINEAR", "TILED_LINEAR", 0.01, 192, 2.0, 256),
    # 9 x 5 x 11 chunks: the line table pads every axis
    "ragged_grid": ((72, 40, 88), 8, "LINEAR", "TILED_LINEAR", 0.02, 256, 2.0, 256),
    # mostly from far outside the world, many missing it entirely
    "from_outside": ((64, 64, 64), 8, "LINEAR", "TILED_LINEAR", 0.02, 256, 5.0, 256),
    # floor only, grazing rays: long walks, many cut by the step budget
    "budget": ((64, 64, 64), 8, "LINEAR", "TILED_LINEAR", 0.0, 128, None, 10),
    # a partial tail word per brick and a divisor that is not a power of two
    "factor5": ((60, 60, 60), 5, "LINEAR", "LINEAR", 0.02, 192, 2.0, 256),
}


def _case_inputs(i, spec):
    """Dense world [z, y, x] and rays of one case, from a numpy seed."""
    (X, Y, Z), _, _, _, fill, n, spread, _ = spec
    rng = np.random.default_rng(1000 + i)
    dense = rng.random((Z, Y, X)) < fill
    dense[:, 0:4, :] = rng.random((Z, 4, X)) < 0.5
    if spread is None:  # grazing rays above the floor
        origins = np.tile(np.asarray([[1.0, 30.0, 1.0]], np.float32), (n, 1))
        ang = np.linspace(0, 2 * np.pi, n, endpoint=False)
        rays = np.stack([np.cos(ang), np.full(n, -0.01), np.sin(ang)], axis=1).astype(np.float32)
        return dense, origins, rays
    w = np.asarray([X, Y, Z], np.float32)
    origins = (rng.random((n, 3)) * w * spread - w * (spread - 1) / 2).astype(np.float32)
    targets = (rng.random((n, 3)) * w).astype(np.float32)
    rays = targets - origins
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    # degenerate and axis-aligned rays: a start inside a solid voxel, and
    # directions with exact zero components
    z, y, x = np.nonzero(dense)
    origins[0] = [x[0] + 0.5, y[0] + 0.5, z[0] + 0.5]
    rays[0] = [1.0, 0.0, 0.0]
    rays[1] = [0.0, -1.0, 0.0]
    rays[2] = [0.0, 0.0, 1.0]
    return dense, origins, rays.astype(np.float32)


def _jax_reference():
    """JAX side of every case (runs in the subprocess, module doc)."""
    import jax
    import jax.numpy as jnp

    from voxelengine_tpu.core.bitgrid import BitGrid
    from voxelengine_tpu.core.brickmap import build_brickmap, build_brickmap_terrain_compact
    from voxelengine_tpu.core.layout import Layout as JL
    from voxelengine_tpu.ops.aabb import ray_aabb as j_aabb
    from voxelengine_tpu.ops.trace import _normalize as j_norm
    from voxelengine_tpu.ops.trace import trace_brickmap as j_trace

    out = {}

    def put_bm(name, bm):
        for k in BM_KEYS:
            v = getattr(bm, k)
            out[f"{name}/{k}"] = np.asarray(getattr(v, "value", v))

    for i, (name, spec) in enumerate(CASES.items()):
        _, f, cl, bl = spec[:4]
        dense, o, d = _case_inputs(i, spec)
        grid_layout = JL.LINEAR if f % 8 else JL.TILED_LINEAR
        bm = build_brickmap(
            BitGrid.from_dense(dense, layout=grid_layout), f,
            coarse_layout=JL[cl], brick_layout=JL[bl],
        )
        put_bm(name, bm)
        out[f"{name}/origins"], out[f"{name}/rays"] = o, d
        r = j_trace(bm, jnp.asarray(o), jnp.asarray(d), spec[7])
        for k in ("hit", "position", "normal", "steps"):
            out[f"{name}/{k}"] = np.asarray(getattr(r, k))

    # the main path's world kind: compact terrain at factor 32
    bm = build_brickmap_terrain_compact((128, 64, 128), 32, octaves=3)
    put_bm("terrain", bm)
    rng = np.random.default_rng(7)
    w = np.asarray([128, 64, 128], np.float32)
    o = (rng.random((256, 3)) * w * 1.5 - w * 0.25).astype(np.float32)
    d = (rng.random((256, 3)) * w).astype(np.float32) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    r = j_trace(bm, jnp.asarray(o), jnp.asarray(d), 512)
    out["terrain/origins"], out["terrain/rays"] = o, d
    for k in ("hit", "position", "normal", "steps"):
        out[f"terrain/{k}"] = np.asarray(getattr(r, k))

    rng = np.random.default_rng(11)
    v = (rng.random((2000, 3)) * 200 - 100).astype(np.float32)
    out["normalize/in"] = v
    out["normalize/out"] = np.asarray(jax.jit(j_norm)(jnp.asarray(v)))
    s = (rng.random((1000, 3)) * 20 - 10).astype(np.float32)
    dd = rng.normal(size=(1000, 3)).astype(np.float32)
    dd[::7, 0] = 0.0  # zero components take the FLT_EPSILON substitution
    out["aabb/start"], out["aabb/dir"] = s, dd
    for k, val in zip(("hit", "tmin", "point", "normal"),
                      jax.jit(j_aabb)(jnp.asarray(s), jnp.asarray(dd),
                                      jnp.zeros(3, jnp.float32), jnp.full(3, 5.0, jnp.float32))):
        out[f"aabb/{k}"] = np.asarray(val)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run this file's JAX side in a subprocess with XLA:CPU's FMA
    contraction and algebraic simplifier off (module doc)."""
    path = tmp_path_factory.mktemp("jax_ref") / "trace_ref.npz"
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


def _bm(ref, name):
    return brickmap_from_numpy({k: ref[f"{name}/{k}"] for k in BM_KEYS}, device="cpu")


def _assert_trace_equal(got, ref, name):
    hit = ref[f"{name}/hit"]
    np.testing.assert_array_equal(got.hit.numpy(), hit)
    np.testing.assert_array_equal(got.steps.numpy(), ref[f"{name}/steps"])
    np.testing.assert_array_equal(got.normal.numpy()[hit], ref[f"{name}/normal"][hit])
    np.testing.assert_array_equal(got.position.numpy()[hit], ref[f"{name}/position"][hit])


def test_normalize_bit_equal_to_jax_reduction(ref):
    got = _normalize(torch.from_numpy(ref["normalize/in"])).numpy()
    np.testing.assert_array_equal(got, ref["normalize/out"])


def test_ray_aabb_bit_equal(ref):
    hit, tmin, point, normal = ray_aabb(
        torch.from_numpy(ref["aabb/start"]), torch.from_numpy(ref["aabb/dir"]),
        torch.zeros(3), torch.full((3,), 5.0),
    )
    for k, v in zip(("hit", "tmin", "point", "normal"), (hit, tmin, point, normal)):
        np.testing.assert_array_equal(v.numpy(), ref[f"aabb/{k}"], err_msg=k)


@pytest.mark.parametrize("name", sorted(CASES) + ["terrain"])
def test_trace_brickmap_matches_jax(ref, name):
    """Hits, steps, normals and positions on hits bit-equal (module doc)."""
    max_steps = CASES[name][7] if name in CASES else 512
    got = trace_brickmap(
        _bm(ref, name), torch.from_numpy(ref[f"{name}/origins"]),
        torch.from_numpy(ref[f"{name}/rays"]), max_steps,
    )
    _assert_trace_equal(got, ref, name)
    if name == "budget":
        cut = got.steps.numpy() == max_steps
        assert cut.sum() >= 16 and not got.hit.numpy()[cut].any()


def test_trace_brickmap_hbm_on_cpu_is_the_plain_trace(ref):
    bm = _bm(ref, "terrain")
    o, d = torch.from_numpy(ref["terrain/origins"]), torch.from_numpy(ref["terrain/rays"])
    a = trace_brickmap_hbm(bm, make_line_table(bm), o, d, 512)
    b = trace_brickmap(bm, o, d, 512)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _host_trace(bm, origins, rays, max_steps, use_macro=False):
    """The line-table trace through the g++ build of csrc/dda.cuh."""
    from voxelengine_tpu_torch.kernels import build

    lib = build.load_dda_host()
    lt = make_line_table(bm)
    d, start_c, start_normal, active = _ray_setup(bm.grid_dims, bm.factor, origins, rays)
    pad = _edge_pad(start_c.to(torch.int32), torch.tensor(bm.grid_dims, dtype=torch.int32), d)
    start_c, d, pad = start_c.contiguous(), d.contiguous(), pad.contiguous()
    active = active.to(torch.int32).contiguous()
    bl = brick_lines_view(bm).contiguous()
    n = origins.shape[0]
    flags = torch.empty(n, dtype=torch.int32)
    pos, nrm = torch.empty(n, 3), torch.empty(n, 3)
    steps = torch.empty(n, dtype=torch.int32)
    (gx, gy, gz), (rx, ry, rz) = bm.grid_dims, lt.region_dims
    lib.vx_trace_host(
        start_c.data_ptr(), d.data_ptr(), active.data_ptr(), pad.data_ptr(),
        lt.region_lines.data_ptr(), bl.data_ptr(), lt.macro.data_ptr(), lt.macro2.data_ptr(), n, gx, gy, gz,
        rx, ry, rz, bm.factor, bm.words_per_brick, max_steps, bm.brick_layout.value, 3 * max_steps + 64,
        int(use_macro), flags.data_ptr(), pos.data_ptr(), nrm.data_ptr(), steps.data_ptr(), None,
    )
    imm = ((flags & 2) == 2)[:, None]
    pos = torch.where(imm, start_c * float(bm.factor), pos)
    nrm = torch.where(imm, start_normal, nrm)
    return (flags & 1) == 1, pos, nrm, steps


@pytest.fixture(scope="module")
def host_build():
    import shutil

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler for the host build of csrc/dda.cuh")


@pytest.mark.parametrize("name", sorted(CASES) + ["terrain"])
def test_host_build_of_kernel_step_matches_plain_trace(ref, host_build, name):
    """csrc/dda.cuh compiled for the host == the plain torch trace, bit for
    bit (positions included), on every world kind and layout."""
    spec = CASES.get(name)
    max_steps = spec[7] if spec else 512
    bm = _bm(ref, name)
    o, d = torch.from_numpy(ref[f"{name}/origins"]), torch.from_numpy(ref[f"{name}/rays"])
    want = trace_brickmap(bm, o, d, max_steps)
    hit, pos, nrm, steps = _host_trace(bm, o, d, max_steps)
    assert torch.equal(hit, want.hit)
    assert torch.equal(steps, want.steps)
    assert torch.equal(pos[hit], want.position[hit])
    assert torch.equal(nrm[hit], want.normal[hit])


@pytest.mark.parametrize("name", sorted(CASES) + ["terrain"])
def test_host_build_macro_route_matches_plain_macro_walk(ref, host_build, name):
    """The macro-on route of the line-table cases: csrc/dda.cuh with its
    macro skip levels, built for the host, == the plain macro walk, bit for
    bit; and on these worlds both equal the chunk-by-chunk walk (a macro
    skip re-seeds tMax, so an ulp could part them: none does here)."""
    spec = CASES.get(name)
    max_steps = spec[7] if spec else 512
    bm = _bm(ref, name)
    o, d = torch.from_numpy(ref[f"{name}/origins"]), torch.from_numpy(ref[f"{name}/rays"])
    want = trace_brickmap_lt(bm, make_line_table(bm), o, d, max_steps)
    assert all(torch.equal(a, b) for a, b in zip(trace_brickmap_hbm(bm, make_line_table(bm), o, d, max_steps), want))
    hit, pos, nrm, steps = _host_trace(bm, o, d, max_steps, use_macro=True)
    assert torch.equal(hit, want.hit) and torch.equal(steps, want.steps)
    assert torch.equal(pos[hit], want.position[hit]) and torch.equal(nrm[hit], want.normal[hit])
    _assert_trace_equal(want, ref, name)


def test_kernel_wrapper_refuses_cpu_tensors():
    from voxelengine_tpu_torch.kernels import bigtrace

    z3, zi = torch.zeros(4, 3), torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bigtrace.bigtrace(
            z3, z3, zi, zi.new_zeros(4, 3), torch.zeros(8, 128, dtype=torch.int32),
            torch.zeros(8, 128, dtype=torch.int32), grid_dims=(8, 8, 8), region_dims=(1, 1, 1),
            factor=8, wpb=16, max_steps=16, brick_layout=Layout.TILED_LINEAR,
        )


def _port_world(spec, i, device):
    """Case ``i``'s world built by the port alone (dense slots, any coarse
    layout), with its rays: no JAX, so the card lane runs without it."""
    from voxelengine_tpu_torch.core.brickmap import BrickMap, _slab_to_chunks, choose_layout, pack_meta
    from voxelengine_tpu_torch.core.layout import sample_index

    (X, Y, Z), f, cl, bl = spec[:4]
    dense, o, d = _case_inputs(i, spec)
    dense = torch.from_numpy(dense).to(device)
    gx, gy, gz = X // f, Y // f, Z // f
    bl = choose_layout((f, f, f), Layout[bl])
    parts = [_slab_to_chunks(dense[z0:z0 + f], f, gy, gx, bl) for z0 in range(0, Z, f)]
    occ, bmn, bmx, words = (torch.cat(p) for p in zip(*parts))
    meta = pack_meta(occ, bmn.clamp_min(0), bmx.clamp_min(0))
    cl = choose_layout((gx, gy, gz), Layout[cl])
    cz, cy, cx = torch.meshgrid(*(torch.arange(n, device=device) for n in (gz, gy, gx)), indexing="ij")
    order = torch.empty_like(cx.reshape(-1))
    order[sample_index(cx, cy, cz, gx, gy, cl).reshape(-1)] = torch.arange(order.numel(), device=device)
    bm = BrickMap(
        meta=meta[order], brick_idx=torch.arange(order.numel(), dtype=torch.int32, device=device),
        bricks=words[order], grid_dims=(gx, gy, gz), factor=f,
        coarse_layout=cl, brick_layout=bl, dense_slots=True,
    )
    return bm, torch.from_numpy(o).to(device), torch.from_numpy(d).to(device)


def test_port_world_matches_the_jax_build(ref):
    """The card lane's port-built worlds are the JAX package's worlds."""
    for i, (name, spec) in enumerate(CASES.items()):
        bm, _, _ = _port_world(spec, i, "cpu")
        want = _bm(ref, name)
        assert bm.coarse_layout is want.coarse_layout and bm.brick_layout is want.brick_layout
        for k in ("meta", "brick_idx", "bricks"):
            assert torch.equal(getattr(bm, k), getattr(want, k)), (name, k)


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_bigtrace_kernel_matches_plain_trace_on_card(cuda_device, name):
    """K1 on the card == its plain versions on the card, bit for bit: the
    chunk-by-chunk trace with the macro levels off, the macro walk with them on."""
    from voxelengine_tpu_torch.kernels import bigtrace

    spec = CASES[name]
    bm, o, d = _port_world(spec, list(CASES).index(name), cuda_device)
    lt = make_line_table(bm)
    before = bigtrace.launches
    for got, want in (
        (trace_brickmap_hbm(bm, lt, o, d, spec[7], use_macro=False), trace_brickmap(bm, o, d, spec[7])),
        (trace_brickmap_hbm(bm, lt, o, d, spec[7]), trace_brickmap_lt(bm, lt, o, d, spec[7])),
    ):
        assert torch.equal(got.hit, want.hit)
        assert torch.equal(got.steps, want.steps)
        assert torch.equal(got.position[got.hit], want.position[want.hit])
        assert torch.equal(got.normal[got.hit], want.normal[want.hit])
    torch.cuda.synchronize()
    assert bigtrace.launches == before + 2


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
