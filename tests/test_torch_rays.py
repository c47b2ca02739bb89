"""The ray-setup kernel (``csrc/rays.cu``): its per-ray logic
``csrc/rays.cuh``, built by g++ as its host twin (``camera_host.cpp``),
against the port's plain ``primary_rays`` and ``_rays_for_pixels`` and
against JAX's ``primary_rays``, bit for bit.

The host twin runs behind the card's route: ``render/frame.py`` and
``parallel/sharded.py`` are told that CPU rays are on the card, and the
wrapper (``kernels/rays.py``) launches the host entries in place of the
kernel's launchers, so the route, the wrapper's arguments and the per-ray
code are all held against the plain version.  The cases: tile order with
and without a block permutation, both frame parities, odd heights (the
dropped row ``py == H``), widths whose pixel blocks are one pixel wide,
an untiled frame, no checkerboard, orthographic windows as a pair and as a
tensor, the ``pixels`` entry on a 4-rank layout's bands and blocks, and
one 1920x1080 bench frame.  The JAX side runs once, in a subprocess whose
XLA:CPU neither contracts FMAs nor runs the algebraic simplifier
(``tests/test_torch_render.py`` module doc).  On the card: the kernel
against its plain version.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.config import Projection, RenderConfig
from voxelengine_tpu_torch.kernels import build
from voxelengine_tpu_torch.kernels import rays as rays_kernel
from voxelengine_tpu_torch.parallel import sharded
from voxelengine_tpu_torch.parallel.mesh import Mesh
from voxelengine_tpu_torch.render import frame

ROOT = Path(__file__).resolve().parent.parent
BENCH_EULER = np.array([-0.25, 0.75, 0.0], np.float32)  # bench.py:192
# the bench camera, the demo's (apps/voxel_app.py:198), tests/test_parallel.py's
JAX_CAMERAS = np.array([BENCH_EULER, [0.3, 0.8, 0.0], [0.9, 0.3, 0.0]], np.float32)
ORIGIN = np.array([32.0, 48.0, 32.0], np.float32)
ORTHO = (6.0, 4.5)
# name: (width, height, checkerboard, tile_order, projection, frame numbers)
FRAMES = {
    "cb_tile_64x48": (64, 48, True, True, "PERSPECTIVE", (1, 2)),
    "cb_tile_odd_65x37": (65, 37, True, True, "PERSPECTIVE", (1, 2)),  # 13x18 blocks, py == H
    "cb_tile_97x54": (97, 54, True, True, "PERSPECTIVE", (1, 2)),  # blocks one pixel wide
    "cb_tile_97x74": (97, 74, True, True, "PERSPECTIVE", (1,)),  # 1x1 blocks: untiled
    "tile_64x48": (64, 48, False, True, "PERSPECTIVE", (0,)),
    "untiled_65x37": (65, 37, False, False, "PERSPECTIVE", (0,)),
    "cb_untiled_64x48": (64, 48, True, False, "PERSPECTIVE", (3,)),
    "ortho_64x48": (64, 48, True, True, "ORTHOGRAPHIC", (1, 2)),
    "ortho_odd_65x37": (65, 37, True, False, "ORTHOGRAPHIC", (1,)),
}
BENCH = (1920, 1080, True, True, "PERSPECTIVE", (1, 2))
KEYS = ("origins", "dirs", "px", "py", "py_r")


def _cfg(spec):
    W, H, cb, to, proj, _ = spec
    return RenderConfig(width=W, height=H, checkerboard=cb, tile_order=to, projection=Projection[proj],
                        ortho_size=ORTHO)


def _t(a):
    return torch.from_numpy(np.array(a))


def _perm(cfg, seed):
    """A block permutation from random per-ray steps
    (:func:`frame.block_permutation_from_steps`)."""
    bw, bh, nb = frame.block_geometry(cfg)
    steps = torch.from_numpy(np.random.default_rng(seed).integers(0, 50, nb * bw * bh))
    return frame.block_permutation_from_steps(steps, cfg)


def _jax_reference():
    """JAX side (runs in the subprocess, module doc): ``primary_rays`` at
    :data:`JAX_CAMERAS` for every frame of :data:`FRAMES`."""
    import jax
    import jax.numpy as jnp

    from voxelengine_tpu.config import Projection as JProj
    from voxelengine_tpu.config import RenderConfig as JCfg
    from voxelengine_tpu.render.frame import primary_rays

    out = {}
    for name, (W, H, cb, to, proj, frames) in FRAMES.items():
        cfg = JCfg(width=W, height=H, checkerboard=cb, tile_order=to, projection=JProj[proj], ortho_size=ORTHO)
        fn = jax.jit(primary_rays, static_argnums=0)
        for j, e in enumerate(JAX_CAMERAS):
            for f in frames:
                rays = fn(cfg, jnp.asarray(ORIGIN), jnp.asarray(e), jnp.int32(f))
                for k, v in zip(KEYS, rays):
                    out[f"{name}/{j}/{f}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run this file's JAX side in a subprocess with XLA:CPU's FMA
    contraction and algebraic simplifier off (module doc)."""
    path = tmp_path_factory.mktemp("jax_ref") / "rays_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _HostKernels:
    """The ``rays`` library's launchers as its host entries (the same
    arguments, less the stream, which :func:`_host_route`'s ``launch``
    drops)."""

    def __init__(self):
        lib = build.load_host("camera_host")
        self.vx_rays_frame, self.vx_rays_pixels = lib.vx_rays_frame_host, lib.vx_rays_pixels_host


@pytest.fixture
def host_route(monkeypatch):
    """CPU rays take the card's route, through the host twin: returns the
    list of the launches made, by launcher name."""
    seen = []
    kernels = _HostKernels()

    def launch(kernel, fn, *args, dev):
        seen.append(kernel)
        assert fn(*args) == 0

    monkeypatch.setattr(frame, "_is_cuda", lambda t: True)
    monkeypatch.setattr(sharded, "_is_cuda", lambda t: True)
    monkeypatch.setattr(build, "require_cuda", lambda kernel, dev: None)
    monkeypatch.setattr(build, "load_kernel", lambda name: kernels)
    monkeypatch.setattr(build, "launch", launch)
    return seen


def _equal(got, want, what):
    for k, g, w in zip(KEYS, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k)
        assert torch.equal(g.reshape(-1).view(torch.int32 if g.dtype == torch.float32 else g.dtype),
                           w.reshape(-1).view(torch.int32 if w.dtype == torch.float32 else w.dtype)), (what, k)


def _check_frame(cfg, euler, fn, block_perm=None, ortho_size=None):
    """The kernel route (host twin) against the plain version: every output
    bit-equal, one launch, and the broadcast row the plain version gives
    (origins in perspective, directions in orthographic) at row stride 0."""
    want = frame.primary_rays_plain(cfg, _t(ORIGIN), euler, fn, block_perm, ortho_size)
    before = rays_kernel.launches
    got = frame.primary_rays(cfg, _t(ORIGIN), euler, fn, block_perm, ortho_size)
    assert rays_kernel.launches == before + 1
    _equal(got, want, (cfg, fn))
    broadcast = got[1] if cfg.projection is Projection.ORTHOGRAPHIC else got[0]
    assert broadcast.stride() == (0, 1)
    return got


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_host_twin_equals_plain_primary_rays(host_route, name):
    cfg = _cfg(FRAMES[name])
    for fn in FRAMES[name][5]:
        for j, e in enumerate(JAX_CAMERAS):
            _check_frame(cfg, _t(e + np.float32(1e-5) * fn), fn)
    assert set(host_route) == {"rays_frame"}


@pytest.mark.parametrize("name", ["cb_tile_64x48", "cb_tile_odd_65x37", "cb_tile_97x54", "tile_64x48"])
def test_host_twin_block_permutation(host_route, name):
    """A permutation from ``block_permutation_from_steps``, as a tensor and
    as a list; also the same frame composed through ``_unblock``."""
    cfg = _cfg(FRAMES[name])
    perm = _perm(cfg, 7)
    for fn in FRAMES[name][5]:
        _check_frame(cfg, _t(BENCH_EULER), fn, perm)
    _check_frame(cfg, _t(BENCH_EULER), 1, perm.tolist())
    _, _, px, py, py_r = frame.primary_rays(cfg, _t(ORIGIN), _t(BENCH_EULER), 1, perm)
    rows = cfg.height // 2 if cfg.checkerboard else cfg.height
    img = frame._unblock(torch.stack([px, py_r], -1), cfg, perm)
    assert torch.equal(img[..., 0], torch.arange(cfg.width).expand(rows, -1))
    assert torch.equal(img[..., 1], torch.arange(rows)[:, None].expand(-1, cfg.width))


def test_host_twin_ortho_tensor_window(host_route):
    """The interactive zoom's ``[2]`` tensor window (float64 here: the
    route rounds it to float32 as the plain version does)."""
    for name in ("ortho_64x48", "ortho_odd_65x37"):
        cfg = _cfg(FRAMES[name])
        for osz in (torch.tensor([7.25, 3.1]), torch.tensor([200.0, 120.0], dtype=torch.float64)):
            _check_frame(cfg, _t(BENCH_EULER), 1, ortho_size=osz)
    cfg = dataclasses.replace(_cfg(FRAMES["ortho_64x48"]), ortho_size=(11.5, 2.0))
    _check_frame(cfg, _t(BENCH_EULER), 2)


def test_host_twin_bench_frame(host_route):
    """The bench frame, 1920x1080 with checkerboarding and tile order (30x32
    blocks), both parities, at the bench camera with its drift."""
    cfg = _cfg(BENCH)
    for fn in BENCH[5]:
        got = _check_frame(cfg, _t(BENCH_EULER + np.float32(1e-5) * fn), fn)
        assert got[1].shape == (1920 * 540, 3)


@pytest.mark.parametrize("layout", ["band", "cyclic"])
@pytest.mark.parametrize("proj", ["PERSPECTIVE", "ORTHOGRAPHIC"])
def test_host_twin_pixels_entry(host_route, layout, proj):
    """``_rays_for_pixels`` through the ``pixels`` entry against its plain
    version on each rank's pixels of a 4-rank layout (the halo rows
    included: rank 0's row -1), both parities."""
    cfg = RenderConfig(width=128, height=96, checkerboard=True, tile_order=True, projection=Projection[proj],
                       ortho_size=ORTHO)
    pixels = sharded.band_pixels if layout == "band" else sharded.cyclic_pixels
    for rank in range(4):
        px, py_r = pixels(cfg, Mesh(None, rank, 4, "rows", torch.device("cpu")), "cpu")
        for fn in (1, 2):
            e = _t(BENCH_EULER + np.float32(1e-5) * fn)
            want = sharded._rays_for_pixels_plain(cfg, _t(ORIGIN), e, fn, px, py_r, cfg.ortho_size)
            got = sharded._rays_for_pixels(cfg, _t(ORIGIN), e, fn, px, py_r, cfg.ortho_size)
            _equal(got, want, (layout, rank, fn))
    assert set(host_route) == {"rays_pixels"}


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_host_twin_equals_jax_primary_rays(ref, host_route, name):
    """At the bench, demo and ``(0.9, 0.3, 0)`` cameras: every output equal
    to JAX's (JAX's pixel coordinates are int32)."""
    cfg = _cfg(FRAMES[name])
    for j, e in enumerate(JAX_CAMERAS):
        for fn in FRAMES[name][5]:
            got = frame.primary_rays(cfg, _t(ORIGIN), _t(e), fn)
            for k, g in zip(KEYS, got):
                w = ref[f"{name}/{j}/{fn}/{k}"]
                g = g.numpy()
                if g.dtype == np.float32:
                    assert np.array_equal(g.view(np.int32), w.view(np.int32)), (name, j, fn, k)
                else:
                    np.testing.assert_array_equal(g, w.astype(np.int64), err_msg=f"{name} {j} {fn} {k}")


def test_launcher_signatures_are_the_host_entries():
    """Each launcher takes its host entry's arguments (and the stream,
    added at load)."""
    for fn in ("vx_rays_frame", "vx_rays_pixels"):
        assert build.SIGNATURES[fn] == build.HOST_ENTRIES[f"{fn}_host"]
    assert build.KERNEL_SOURCES["rays"] == "rays.cu"


def test_card_route_never_takes_the_plain_body(monkeypatch, host_route):
    """A card call of ``primary_rays`` and ``_rays_for_pixels`` reaches the
    wrapper and never the plain body."""
    def plain(*a, **k):
        raise AssertionError("the card route ran the plain body")

    calls = []
    frame_rays, pixel_rays = rays_kernel.frame_rays, rays_kernel.pixel_rays
    monkeypatch.setattr(frame, "primary_rays_plain", plain)
    monkeypatch.setattr(sharded, "_rays_for_pixels_plain", plain)
    monkeypatch.setattr(rays_kernel, "frame_rays", lambda *a, **k: calls.append("frame") or frame_rays(*a, **k))
    monkeypatch.setattr(rays_kernel, "pixel_rays", lambda *a, **k: calls.append("pixels") or pixel_rays(*a, **k))
    cfg = _cfg(FRAMES["cb_tile_64x48"])
    frame.primary_rays(cfg, _t(ORIGIN), _t(BENCH_EULER), 1)
    px, py_r = sharded.band_pixels(dataclasses.replace(cfg, width=128, height=96),
                                   Mesh(None, 1, 4, "rows", torch.device("cpu")), "cpu")
    sharded._rays_for_pixels(cfg, _t(ORIGIN), _t(BENCH_EULER), 1, px, py_r, cfg.ortho_size)
    assert calls == ["frame", "pixels"] and host_route == ["rays_frame", "rays_pixels"]


def test_cpu_rays_take_the_plain_version(monkeypatch):
    def no_kernel(*a, **k):
        raise AssertionError("the ray kernel was called for CPU tensors")

    monkeypatch.setattr(rays_kernel, "frame_rays", no_kernel)
    cfg = _cfg(FRAMES["cb_tile_64x48"])
    got = frame.primary_rays(cfg, _t(ORIGIN), _t(BENCH_EULER), 1)
    _equal(got, frame.primary_rays_plain(cfg, _t(ORIGIN), _t(BENCH_EULER), 1), "cpu")


def test_wrapper_refuses_cpu_tensors():
    e, o = torch.zeros(3), torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA"):
        rays_kernel.frame_rays(e, o, n=4, width=2, height=2, tile=(2, 1), checkerboard=False, even_frame=True,
                               ortho=False, a=1.0, b=1.0)
    with pytest.raises(ValueError, match="CUDA"):
        rays_kernel.pixel_rays(e, o, torch.zeros(4, dtype=torch.int64), torch.zeros(4, dtype=torch.int64), width=2,
                               height=2, checkerboard=False, even_frame=True, ortho=False, a=1.0, b=1.0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FRAMES) + ["bench"])
def test_ray_kernel_equals_plain_on_card(cuda_device, name):
    """The kernel against its plain version on the card (the plain version's
    basis from the camera kernel), and one launch a frame."""
    spec = BENCH if name == "bench" else FRAMES[name]
    cfg = _cfg(spec)
    o = _t(ORIGIN).to(cuda_device)
    for fn in spec[5]:
        e = _t(BENCH_EULER + np.float32(1e-5) * fn).to(cuda_device)
        before = rays_kernel.launches
        got = frame.primary_rays(cfg, o, e, fn)
        assert rays_kernel.launches == before + 1
        _equal([t.cpu() for t in got], [t.cpu() for t in frame.primary_rays_plain(cfg, o, e, fn)], (name, fn))


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
