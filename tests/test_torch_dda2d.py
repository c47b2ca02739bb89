"""The port's 2D path (``ops/dda2d.py``) and its demo against the JAX
package: the depth-1 grid and the factor-deep compact brickmap are the same
tables; ``trace_grid_2d`` and ``trace_brickmap_2d`` give the same hits,
positions, normals and steps on ``tests/test_dda2d.py``'s world and radial
fan; the demo writes the same PPM bytes.  Tolerance: bit-equal throughout.

The JAX side runs once, in a subprocess whose XLA:CPU neither contracts
FMAs nor runs the algebraic simplifier (``tests/test_torch_render.py``
module doc).  Calls routed as card calls reach K2's and K1's launchers,
here pointed at the g++ build of the kernels' per-ray code.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.ops import dda2d
from voxelengine_tpu_torch.ops.trace import trace_brickmap, trace_grid

ROOT = Path(__file__).resolve().parent.parent
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")
FANS = {"fan256": ((32.0, 32.0), 256), "fan_off_centre": ((20.25, 41.5), 1000)}
DEMO_ARGS = ["--world", "64", "--rays", "1000"]


def _world(n=64):
    """``tests/test_dda2d.py``'s world, from its fixture's seed."""
    rng = np.random.default_rng(0xC0FFEE)
    dense = rng.random((n, n)) < 0.05
    dense[n // 2 - 6 : n // 2 + 6, n // 2 - 6 : n // 2 + 6] = False
    dense[0, :] = dense[-1, :] = True
    dense[:, 0] = dense[:, -1] = True
    return dense


def _jax_reference(out_dir):
    """JAX side (runs in the subprocess, module doc)."""
    import runpy

    from voxelengine_tpu.ops import dda2d as J

    out = {}
    dense = _world()
    g = J.grid2d_from_dense(dense)
    bm = J.brickmap2d_from_dense(dense, 8)
    out["grid/words"] = np.asarray(g.words)
    out["grid/dims"] = np.asarray(g.dims)
    out["grid/layout"] = np.asarray(g.layout.value)
    for k in BM_KEYS:
        v = getattr(bm, k)
        out[f"bm/{k}"] = np.asarray(getattr(v, "value", v))
    for name, (center, count) in FANS.items():
        o, r = J.radial_rays(center, count)
        out[f"{name}/origins"], out[f"{name}/rays"] = o, r
        for kind, res in (("grid", J.trace_grid_2d(g, o, r)), ("bm", J.trace_brickmap_2d(bm, o, r))):
            for f in ("hit", "position", "normal", "steps"):
                out[f"{name}/{kind}/{f}"] = np.asarray(getattr(res, f))
    ppm = os.path.join(out_dir, "jax_dda2d.ppm")
    sys.argv = ["dda2d_demo.py", *DEMO_ARGS, "--out", ppm]
    runpy.run_path(str(ROOT / "apps" / "dda2d_demo.py"), run_name="__main__")
    out["demo/ppm"] = np.frombuffer(open(ppm, "rb").read(), np.uint8)
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ref")
    path = d / "dda2d_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _tables():
    dense = torch.from_numpy(_world())
    return dda2d.grid2d_from_dense(dense), dda2d.brickmap2d_from_dense(dense, 8)


def _bits(a):
    """Integer words as their 32-bit patterns (JAX keeps some as uint32)."""
    a = np.asarray(a)
    return a.astype(np.int64) & 0xFFFFFFFF if a.dtype.kind in "iu" else a


def test_2d_tables_bit_equal(ref):
    g, bm = _tables()
    np.testing.assert_array_equal(_bits(g.words.numpy()), _bits(ref["grid/words"]))
    assert g.dims == tuple(ref["grid/dims"]) and g.layout.value == int(ref["grid/layout"])
    for k in BM_KEYS:
        v = getattr(bm, k)
        got = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(getattr(v, "value", v))
        np.testing.assert_array_equal(_bits(got), _bits(ref[f"bm/{k}"]), err_msg=k)


def test_radial_rays_equal(ref):
    for name, (center, count) in FANS.items():
        o, r = dda2d.radial_rays(center, count)
        np.testing.assert_array_equal(o, ref[f"{name}/origins"])
        np.testing.assert_array_equal(r, ref[f"{name}/rays"])


def _check(ref, name, kind, out):
    for f in ("hit", "position", "normal", "steps"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), ref[f"{name}/{kind}/{f}"], err_msg=f"{name} {kind} {f}")


@pytest.mark.parametrize("name", sorted(FANS))
def test_trace_grid_2d_bit_equal(ref, name):
    g, _ = _tables()
    _check(ref, name, "grid", dda2d.trace_grid_2d(g, ref[f"{name}/origins"], ref[f"{name}/rays"]))


@pytest.mark.parametrize("name", sorted(FANS))
def test_trace_brickmap_2d_bit_equal(ref, name):
    _, bm = _tables()
    _check(ref, name, "bm", dda2d.trace_brickmap_2d(bm, ref[f"{name}/origins"], ref[f"{name}/rays"]))


@pytest.fixture()
def host_kernels(monkeypatch):
    """Route CPU tensors as card tensors into the kernel wrappers, whose
    launchers call the g++ build of the kernels' per-ray code (the same
    arguments, minus the stream; K1's also minus its work counter and
    grid)."""
    import shutil

    from voxelengine_tpu_torch.kernels import build

    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler for the host build of csrc/dda.cuh")
    lib = build.load_dda_host()
    kernels = SimpleNamespace(vx_bigtrace_rays=lambda *a: lib.vx_bigtrace_rays_host(*a[:-2]),
                              vx_trace_grid=lib.vx_trace_grid_full_host)
    monkeypatch.setattr(dda2d, "_is_cuda", lambda t: True)
    monkeypatch.setattr(build, "require_cuda", lambda kernel, dev: None)
    monkeypatch.setattr(build, "load_kernel", lambda name: kernels)
    monkeypatch.setattr(build, "launch", lambda kernel, fn, *args, dev: fn(*args))


@pytest.mark.parametrize("name", sorted(FANS))
def test_card_route_reaches_k2_and_k1(ref, host_kernels, name):
    """A card call goes to K2 (single level) and K1 (two levels, one
    launch each), never to the plain walk; the results are JAX's."""
    from voxelengine_tpu_torch.kernels import bigtrace, gridtrace
    from voxelengine_tpu_torch.ops import trace

    def no_plain(*a, **k):
        raise AssertionError("the plain walk ran on a card call")

    g, bm = _tables()
    o, r = ref[f"{name}/origins"], ref[f"{name}/rays"]
    k1, k2 = bigtrace.launches, gridtrace.launches
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dda2d, "trace_grid", no_plain)
        mp.setattr(dda2d, "trace_brickmap", no_plain)
        mp.setattr(trace, "trace_brickmap", no_plain)
        a = dda2d.trace_grid_2d(g, o, r)
        b = dda2d.trace_brickmap_2d(bm, o, r)
    assert (bigtrace.launches - k1, gridtrace.launches - k2) == (1, 1)
    _check(ref, name, "grid", a)
    _check(ref, name, "bm", b)


def test_two_level_matches_single_level_on_fan(ref):
    """``tests/test_dda2d.py``'s property on the port: same hits; positions
    within 2e-3 except at most 4 corner-degenerate rays; z never stepped."""
    g, bm = _tables()
    o, r = ref["fan256/origins"], ref["fan256/rays"]
    a, b = dda2d.trace_grid_2d(g, o, r), dda2d.trace_brickmap_2d(bm, o, r)
    assert torch.equal(a.hit, b.hit) and bool(a.hit.all())
    diff = (a.position[:, :2] - b.position[:, :2]).abs().amax(dim=1)
    assert int((diff > 2e-3).sum()) <= 4
    assert bool((a.position[:, 2] == 0.5).all())


def test_demo_ppm_byte_equal(ref, tmp_path):
    from voxelengine_tpu_torch.apps import dda2d_demo

    out = tmp_path / "dda2d.ppm"
    dda2d_demo.main([*DEMO_ARGS, "--out", str(out), "--device", "cpu"])
    got = np.frombuffer(out.read_bytes(), np.uint8)
    np.testing.assert_array_equal(got, ref["demo/ppm"])


# ---------------------------------------------------------------------------
# card lane
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_k1_and_k2_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    dev = torch.device("cuda")
    dense = torch.from_numpy(_world()).to(dev)
    g, bm = dda2d.grid2d_from_dense(dense), dda2d.brickmap2d_from_dense(dense, 8)
    for center, count in FANS.values():
        o, r = dda2d.radial_rays(center, count)
        o3, r3 = dda2d._lift(o, r, dev)
        for got, want in ((dda2d.trace_grid_2d(g, o, r), trace_grid(g, o3, r3)),
                          (dda2d.trace_brickmap_2d(bm, o, r), trace_brickmap(bm, o3, r3))):
            for x, y in zip(got, want):
                assert torch.equal(x, y)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference(os.path.dirname(sys.argv[1])))
