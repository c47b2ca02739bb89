"""W1, the terrain slab kernel, and its noise (``csrc/noise.cuh``,
``csrc/terrain.cuh``) on the CPU, through their host build (g++
``-ffp-contract=off``, ``csrc/terrain_host.cpp``): against
``native/golden_noise.json`` and the port's torch noise bit for bit, against
the JAX package's noise at ``tests/test_torch_noise.py``'s tolerance, and
the slab reduction and the compact build routed through it against JAX's
``_slab_to_chunks`` and ``build_brickmap_terrain_compact`` bit for bit.
The card lane holds W1 and its noise probe against the plain torch versions
on the card.

As in ``test_torch_trace.py``, the JAX side runs in a subprocess whose
XLA:CPU contracts no FMAs.  Worlds are small (at most 128x64x128, 8
octaves); inputs are made from numpy seeds.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact, terrain_slab_chunks_plain
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import terrain as W
from voxelengine_tpu_torch.ops import noise as TN
from voxelengine_tpu_torch.worldgen.terrain import solid_at, terrain_density

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = json.loads((ROOT / "native" / "golden_noise.json").read_text())
OCTAVES = 8
# slab cases: name -> (world dims, factor, brick layout); f 5 and 6 leave
# tail bits in the last word of a brick
SLAB_CASES = {
    "f4_linear": ((32, 16, 32), 4, "LINEAR"),
    "f5_linear_tail": ((40, 20, 40), 5, "LINEAR"),
    "f6_linear_tail": ((48, 24, 48), 6, "LINEAR"),
    "f8_tiled": ((64, 32, 64), 8, "TILED_LINEAR"),
    "f8_morton": ((64, 32, 64), 8, "TILED_MORTON"),
    "f8_linear": ((64, 32, 64), 8, "LINEAR"),
    "f32_tiled": ((128, 64, 128), 32, "TILED_LINEAR"),
    "f32_morton": ((128, 64, 128), 32, "TILED_MORTON"),
}
# compact builds: name -> (world dims, factor, brick layout)
BUILD_CASES = {
    "f32_tiled": ((128, 64, 128), 32, "TILED_LINEAR"),
    "f8_morton": ((64, 64, 64), 8, "TILED_MORTON"),
}


def _slab_z0s(dims, f):
    return (0, dims[2] - f)


def _points():
    """Random float points, voxel coords and uint32 seeds."""
    rng = np.random.default_rng(90)
    pos = (rng.random((300, 3)) * 200 - 100).astype(np.float32)
    vox = np.stack([rng.integers(0, 8192, 300), rng.integers(0, 512, 300), rng.integers(0, 8192, 300)], -1)
    seeds = rng.integers(0, 2**32, 300, dtype=np.uint32)
    return pos, vox.astype(np.int32), seeds


def _jax_reference():
    """JAX side (runs in the subprocess, module doc)."""
    import jax
    import jax.numpy as jnp

    from voxelengine_tpu.core.brickmap import _slab_to_chunks
    from voxelengine_tpu.core.brickmap import build_brickmap_terrain_compact as j_build
    from voxelengine_tpu.core.layout import Layout as JL
    from voxelengine_tpu.ops import noise as JN
    from voxelengine_tpu.worldgen.terrain import solid_at as j_solid
    from voxelengine_tpu.worldgen.terrain import terrain_density as j_density

    out = {}
    for name, (dims, f, lay) in SLAB_CASES.items():
        X, Y, _ = dims

        @jax.jit
        def do_slab(z0, X=X, Y=Y, f=f, lay=lay):
            z = z0 + jnp.arange(f)[:, None, None]
            slab = j_solid(jnp.arange(X)[None, None, :], jnp.arange(Y)[None, :, None], z, 0x71889283, OCTAVES)
            return _slab_to_chunks(slab, f, Y // f, X // f, JL[lay])

        for z0 in _slab_z0s(dims, f):
            for k, v in zip(("occ", "bmin", "bmax", "words"), do_slab(jnp.int32(z0))):
                out[f"slab/{name}/{z0}/{k}"] = np.asarray(v)
    for name, (dims, f, lay) in BUILD_CASES.items():
        bm = j_build(dims, f, octaves=OCTAVES, brick_layout=JL[lay])
        for k in ("meta", "brick_idx", "bricks"):
            out[f"build/{name}/{k}"] = np.asarray(getattr(bm, k))
    pos, vox, _ = _points()
    out["perlin"] = np.asarray(JN.perlin_noise(jnp.asarray(pos), 1.0, -5))
    for oc in (8, 32):
        out[f"repeater_perlin/{oc}"] = np.asarray(JN.repeater_perlin(jnp.asarray(pos), 1.0, 0, oc, 2.0, 0.5))
    out["terrain_t/8"] = np.asarray(j_density(*(jnp.asarray(vox[:, k]) for k in range(3)), octaves=8))
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "terrain_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def host():
    import shutil

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler for the host build of W1's logic")
    from voxelengine_tpu_torch.kernels import build

    return build.load_host("terrain_host")


def _noise(lib, kind, points, scale=1.0, seed=0, octaves=0, lacunarity=2.0, decay=0.5):
    """The noise probe's host build on ``points`` (a numpy array)."""
    points = np.ascontiguousarray(points)
    n = points.shape[0]
    fout, uout = np.zeros(n, np.float32), np.zeros(n, np.uint32)
    assert lib.vx_noise_points_host(W.NOISE_KINDS[kind][0], n, points.ctypes.data, scale, seed, octaves, lacunarity, decay,
                                    fout.ctypes.data, uout.ctypes.data) == 0
    return uout if kind in ("hash", "solid") else fout


def _host_slab(lib, z0, dims, f, layout, octaves):
    """W1's host build: ``(occ, bmin, bmax, words)`` as ``_slab_to_chunks``."""
    X, Y, _ = dims
    gx, gy, wpb = X // f, Y // f, -(-f**3 // 32)
    n = gx * gy
    occ = torch.empty(n, dtype=torch.uint8)
    bmin, bmax = torch.empty(n, 3, dtype=torch.int32), torch.empty(n, 3, dtype=torch.int32)
    words = torch.empty(n, wpb, dtype=torch.int32)
    assert lib.vx_terrain_slab_host(z0, f, gx, gy, wpb, layout.value, octaves, occ.data_ptr(), bmin.data_ptr(),
                                    bmax.data_ptr(), words.data_ptr()) == 0
    return occ.view(torch.bool), bmin, bmax, words


def _golden_inputs():
    seeds = np.array([0, 1, 42, 0x71889283, 0xFFFFFFFF, 123456789], np.uint32)
    coords = np.array([[0.1, 0.2, 0.3], [1.5, 2.5, 3.5], [10, 20, 30], [0.005, 0, 0], [100.7, 3.3, 77.77]], np.float32)
    a = np.arange(4) * 37
    z, y, x = np.meshgrid(a, a, a, indexing="ij")
    lattice = np.stack([x.ravel(), y.ravel(), z.ravel()], -1).astype(np.int32)
    return {
        "hash": (seeds, {}), "random_float": (seeds, {}), "perlin": (coords, dict(seed=1040580316)),
        "repeater_perlin": (coords, dict(octaves=32)), "terrain_t": (lattice, dict(octaves=32)),
    }


@pytest.mark.parametrize("kind", ["hash", "random_float", "perlin", "repeater_perlin", "terrain_t"])
def test_host_noise_matches_golden(host, kind):
    """``noise.cuh``, built by g++, == ``native/golden_noise.json`` bit for
    bit (the octave loop at 32 octaves included)."""
    points, kw = _golden_inputs()[kind]
    got = _noise(host, kind, points, **kw)
    np.testing.assert_array_equal(got, np.array(GOLDEN[kind], got.dtype))


@pytest.mark.parametrize("kind,octaves", [("hash", 0), ("random_float", 0), ("perlin", 0), ("repeater_perlin", 8),
                                          ("repeater_perlin", 32), ("terrain_t", 8), ("terrain_t", 32),
                                          ("solid", 8)])
def test_host_noise_matches_torch_noise(host, kind, octaves):
    """``noise.cuh``, built by g++, == the port's torch noise bit for bit
    (float bit patterns) on random points."""
    pos, vox, seeds = _points()
    v = torch.from_numpy(vox.astype(np.int64))
    want = {
        "hash": lambda: TN.hash_u32(torch.from_numpy(seeds.astype(np.int64))).numpy().astype(np.uint32),
        "random_float": lambda: TN.random_float(torch.from_numpy(seeds.astype(np.int64))).numpy(),
        "perlin": lambda: TN.perlin_noise(torch.from_numpy(pos), 1.0, -5).numpy(),
        "repeater_perlin": lambda: TN.repeater_perlin(torch.from_numpy(pos), 1.0, 0, octaves, 2.0, 0.5).numpy(),
        "terrain_t": lambda: terrain_density(v[:, 0], v[:, 1], v[:, 2], octaves=octaves).numpy(),
        "solid": lambda: solid_at(v[:, 0], v[:, 1], v[:, 2], octaves=octaves).numpy().astype(np.uint32),
    }[kind]()
    points = {"hash": seeds, "random_float": seeds, "perlin": pos, "repeater_perlin": pos}.get(kind, vox)
    got = _noise(host, kind, points, seed=-5 if kind == "perlin" else 0, octaves=octaves)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("key,rtol,atol", [("perlin", 0, 0), ("repeater_perlin/8", 3e-6, 3e-7),
                                           ("repeater_perlin/32", 3e-6, 3e-7), ("terrain_t/8", 3e-6, 1e-4)])
def test_host_noise_matches_jax(ref, host, key, rtol, atol):
    """``noise.cuh``, built by g++, == the JAX package's noise: perlin bit
    for bit, the octave sums at ``tests/test_torch_noise.py``'s tolerance."""
    pos, vox, _ = _points()
    kind, _, oc = key.partition("/")
    got = _noise(host, kind, vox if kind == "terrain_t" else pos, seed=-5 if kind == "perlin" else 0,
                 octaves=int(oc or 0))
    np.testing.assert_allclose(got, ref[key], rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", sorted(SLAB_CASES))
def test_host_slab_reduction_matches_jax(ref, host, name):
    """W1's reduction, built by g++, == JAX's ``_slab_to_chunks`` of its
    ``solid_at`` slab and the port's plain version, bit for bit, on the
    first and last slabs: occupancy, bounds (0 and -1 for empty chunks) and
    words (tail bits 0)."""
    dims, f, lay = SLAB_CASES[name]
    for z0 in _slab_z0s(dims, f):
        got = _host_slab(host, z0, dims, f, Layout[lay], OCTAVES)
        plain = terrain_slab_chunks_plain(z0, dims, f, Layout[lay], OCTAVES, device="cpu")
        for k, a, p in zip(("occ", "bmin", "bmax", "words"), got, plain):
            want = ref[f"slab/{name}/{z0}/{k}"]
            np.testing.assert_array_equal(a.numpy(), want.view(np.int32) if want.dtype == np.uint32 else want,
                                          err_msg=f"{k} z0={z0}")
            assert torch.equal(a, p), k
    occ = got[0]
    assert bool(occ.any()) or name.startswith("f32")  # a world's top slab may be empty at factor 32
    if f**3 % 32:
        assert not (got[3][:, -1] >> (f**3 % 32)).any()


@pytest.mark.parametrize("name", sorted(BUILD_CASES))
def test_compact_build_through_host_reduction_matches_jax(ref, host, name):
    """The compact build with every slab's chunks from W1's host build ==
    JAX's ``build_brickmap_terrain_compact``: ``meta``, ``brick_idx`` and
    ``bricks`` bit-equal."""
    dims, f, lay = BUILD_CASES[name]

    def chunks(z0, dims, f, layout, octaves, seed, device):
        return _host_slab(host, z0, dims, f, layout, octaves)

    bm = build_brickmap_terrain_compact(dims, f, octaves=OCTAVES, brick_layout=Layout[lay], device="cpu",
                                        chunks_fn=chunks)
    np.testing.assert_array_equal(bm.meta.numpy(), ref[f"build/{name}/meta"])
    np.testing.assert_array_equal(bm.brick_idx.numpy(), ref[f"build/{name}/brick_idx"])
    np.testing.assert_array_equal(bm.bricks.numpy(), ref[f"build/{name}/bricks"].view(np.int32))
    idx = bm.brick_idx.numpy()
    assert (idx == -1).any() and (idx > 0).any()
    assert (idx == 0).any() or f == 32  # all-full chunks share slot 0 (none at 32^3 in so low a world)


def test_compact_build_on_the_cpu_takes_the_plain_path():
    """On the CPU the compact build reduces plain slabs and never reaches
    W1's wrapper, which refuses CPU devices."""
    before = W.launches
    bm = build_brickmap_terrain_compact((32, 16, 32), 8, octaves=2, device="cpu")
    assert W.launches == before and bm.meta.device.type == "cpu"
    with pytest.raises(ValueError, match="CUDA"):
        W.terrain_slab(0, (32, 16, 32), 8, Layout.TILED_LINEAR, 2, "cpu")
    with pytest.raises(ValueError, match="CUDA"):
        W.noise_points("perlin", torch.zeros(4, 3))


@pytest.mark.parametrize("dims,factor,layout,match", [
    ((64, 64, 60), 8, "TILED_LINEAR", "multiples"),
    ((40, 40, 40), 40, "LINEAR", "multiples"),
    ((60, 60, 60), 12, "TILED_MORTON", "divisible by 8"),
])
def test_terrain_slab_refuses_bad_shapes(dims, factor, layout, match):
    with pytest.raises(ValueError, match=match):
        W.slab_shape(dims, factor, Layout[layout])


# ------------------------------------------------------------ card lane


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(SLAB_CASES))
def test_w1_matches_plain_on_card(cuda_device, name):
    """W1 on the card == the plain slab reduction on the card, one launch a
    slab, and the compact build through W1 == the plain path's."""
    dims, f, lay = SLAB_CASES[name]
    for z0 in _slab_z0s(dims, f):
        before = W.launches
        got = W.terrain_slab(z0, dims, f, Layout[lay], OCTAVES, cuda_device)
        want = terrain_slab_chunks_plain(z0, dims, f, Layout[lay], OCTAVES, device=cuda_device)
        torch.cuda.synchronize()
        assert W.launches == before + 1
        for k, a, b in zip(("occ", "bmin", "bmax", "words"), got, want):
            assert torch.equal(a, b), k
    a = build_brickmap_terrain_compact(dims, f, octaves=OCTAVES, brick_layout=Layout[lay], device=cuda_device)
    b = build_brickmap_terrain_compact(dims, f, octaves=OCTAVES, brick_layout=Layout[lay], device=cuda_device,
                                       chunks_fn=terrain_slab_chunks_plain)
    for k in ("meta", "brick_idx", "bricks"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind,octaves", [("hash", 0), ("random_float", 0), ("perlin", 0), ("repeater_perlin", 32),
                                          ("terrain_t", 32), ("solid", 8)])
def test_w1_noise_on_card(cuda_device, kind, octaves):
    """The noise probe on the card == the plain torch noise on the card, bit
    for bit, and the golden values where they exist."""
    pos, vox, seeds = _points()
    s = torch.from_numpy(seeds.view(np.int32)).to(cuda_device)
    p, v = torch.from_numpy(pos).to(cuda_device), torch.from_numpy(vox).to(cuda_device)
    vl = v.long()
    got, want = {
        "hash": lambda: (W.noise_points("hash", s), TN.hash_u32(s)),
        "random_float": lambda: (W.noise_points("random_float", s), TN.random_float(s)),
        "perlin": lambda: (W.noise_points("perlin", p, seed=-5), TN.perlin_noise(p, 1.0, -5)),
        "repeater_perlin": lambda: (W.noise_points("repeater_perlin", p, octaves=octaves),
                                    TN.repeater_perlin(p, 1.0, 0, octaves, 2.0, 0.5)),
        "terrain_t": lambda: (W.noise_points("terrain_t", v, octaves=octaves),
                              terrain_density(vl[:, 0], vl[:, 1], vl[:, 2], octaves=octaves)),
        "solid": lambda: (W.noise_points("solid", v, octaves=octaves),
                          solid_at(vl[:, 0], vl[:, 1], vl[:, 2], octaves=octaves)),
    }[kind]()
    if got.dtype == torch.float32:
        got, want = got.view(torch.int32), want.view(torch.int32)
    assert torch.equal(got, want)
    if kind in GOLDEN:
        points, kw = _golden_inputs()[kind]
        t = torch.from_numpy(points.view(np.int32) if points.dtype == np.uint32 else points).to(cuda_device)
        g = W.noise_points(kind, t, **kw).cpu().numpy()
        np.testing.assert_array_equal(g, np.array(GOLDEN[kind], g.dtype))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
