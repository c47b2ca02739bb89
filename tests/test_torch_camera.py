"""The port's camera trigonometry (``voxelengine_tpu_torch/core/libm.py``)
and the camera kernel's logic (``csrc/camera.cuh``) against this machine's
C library.

The JAX reference's XLA:CPU computes ``jnp.sin``, ``jnp.cos`` and
``jnp.tan`` as glibc's ``sinf``, ``cosf`` and ``tanf``, so the oracle here
is the C library itself, called through ``ctypes`` (the port never calls
it).  Both twins must be bit-equal to it on every sweep: a dense grid of
4,000,001 angles over [-3.3, 3.3], +-64 ulp around every multiple of pi/4
up to 120 (the reductions' edges), random |x| in [120, 1e5] (the large
reduction), the tiny range, and +-0 and the extreme finite values.
``tests/test_torch_render.py`` holds ``core/libm.py`` against JAX's jitted
functions and the frames at JAX's own cameras against JAX's.

Also: ``fma`` against the C library's, the half field of view's ``tanf``,
the CPU route of ``get_directions`` (the plain version, no kernel), and on
the card the kernel against its plain version.
"""

import ctypes
import ctypes.util
import functools

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.core import libm
from voxelengine_tpu_torch.kernels import build
from voxelengine_tpu_torch.kernels import camera as camera_kernel
from voxelengine_tpu_torch.render import camera

F32 = np.float32
CHUNK = 1 << 20
# the bench camera (bench.py:192), the drifted bench cameras (bench.py:324),
# tests/test_parallel.py's camera and the render tests' cameras
BENCH_EULER = np.array([-0.25, 0.75, 0.0], F32)
CAMERAS = np.concatenate([
    BENCH_EULER + (F32(1e-5) * np.arange(7, dtype=F32))[:, None],
    np.array([[0.9, 0.3, 0.0], [-0.5, 0.8, 0.0], [0.3, -1.2, 0.0], [0.0, 0.0, 0.0], [-0.4, 0.7, 0.0]], F32),
])


def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for fn in ("sinf", "cosf", "tanf"):
        getattr(lib, fn).restype = ctypes.c_float
        getattr(lib, fn).argtypes = [ctypes.c_float]
    lib.fma.restype = ctypes.c_double
    lib.fma.argtypes = [ctypes.c_double] * 3
    return lib


LIBM = _libm()


def _sweep(name):
    """A3's float32 angle sweeps."""
    rng = np.random.default_rng(11)
    if name == "grid":
        return np.linspace(-3.3, 3.3, 4_000_001, dtype=F32)
    if name == "pi4_edges":
        k = np.arange(-152, 153)
        centre = (k * np.pi / 4).astype(F32)
        x = (centre.view(np.int32)[:, None] + np.arange(-64, 65)[None, :]).astype(np.int32).view(F32)
        # a step of one float32 ulp through zero crosses into the other sign
        x = x[np.isfinite(x) & (np.abs(x) <= 120)]
        return np.concatenate([x, -x])
    if name == "large":
        x = (120 + rng.random(200_000) * (1e5 - 120)).astype(F32)
        return np.concatenate([x, -x, F32([120.0, -120.0, np.nextafter(F32(120), F32(0))])])
    if name == "tiny":
        x = (2.0 ** rng.uniform(-149, -10, 100_000)).astype(F32)
        edges = F32([2**-12, 2**-13, 2**-126, 2**-149, np.nextafter(F32(2**-12), F32(0))])
        return np.concatenate([x, -x, edges, -edges])
    assert name == "specials"
    fi = np.finfo(F32)
    x = F32([0.0, fi.max, np.nextafter(fi.max, F32(0)), fi.tiny, 1.0, 0.75, np.pi / 4, np.pi / 2, np.pi])
    return np.concatenate([x, -x])


SWEEPS = ("grid", "pi4_edges", "large", "tiny", "specials")


def _c_library(fn, x):
    f = getattr(LIBM, fn)
    return np.fromiter(map(f, x.tolist()), F32, count=len(x))


@functools.cache
def _c_sweep(sweep):
    """The C library's ``(sinf, cosf, tanf)`` of a sweep (both twins' tests
    read them)."""
    x = _sweep(sweep)
    return tuple(_c_library(fn, x) for fn in ("sinf", "cosf", "tanf"))


def _diffs(got, want):
    return int((np.asarray(got, F32).view(np.int32) != want.view(np.int32)).sum())


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("sweep", SWEEPS)
def test_libm_twin_bit_equal_to_the_c_library(sweep):
    """``core/libm.py``'s ``sinf``, ``cosf`` and ``tanf``: 0 diffs."""
    x, want = _sweep(sweep), _c_sweep(sweep)
    for i in range(0, len(x), CHUNK):
        xc = torch.from_numpy(x[i:i + CHUNK])
        for got, w in zip((*libm.sincosf(xc), libm.tanf(xc)), want):
            assert _diffs(got, w[i:i + CHUNK]) == 0
    assert len(x) >= 4_000_000 or sweep != "grid"


@pytest.mark.parametrize("sweep", SWEEPS)
def test_kernel_logic_bit_equal_to_the_c_library(sweep):
    """``camera.cuh::glibc_sincosf``, built by g++ as the kernel's host
    twin: 0 diffs."""
    lib = build.load_host("camera_host")
    x = _sweep(sweep)
    s, c = np.empty_like(x), np.empty_like(x)
    lib.vx_sincosf_host(x.ctypes.data, len(x), s.ctypes.data, c.ctypes.data)
    want = _c_sweep(sweep)
    assert _diffs(s, want[0]) == 0
    assert _diffs(c, want[1]) == 0


def test_non_finite_angles_give_nan():
    x = torch.tensor([np.inf, -np.inf, np.nan], dtype=torch.float32)
    for v in (*libm.sincosf(x), libm.tanf(x)):
        assert torch.isnan(v).all()


def test_fma_is_one_rounding():
    """The fused step against the C library's ``fma``, on random operands
    and on sums that cancel to the product's rounding error."""
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=20_000), rng.normal(size=20_000) * 1e-3
    for c in (rng.normal(size=20_000), -(a * b) * (1 + rng.normal(size=20_000) * 1e-12)):
        got = libm.fma(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
        want = np.fromiter(map(LIBM.fma, a.tolist(), b.tolist(), c.tolist()), np.float64, count=len(a))
        np.testing.assert_array_equal(got, want)
    got = libm.fma(torch.from_numpy(a), 0.3, -0.7).numpy()
    np.testing.assert_array_equal(got, [LIBM.fma(v, 0.3, -0.7) for v in a])


@pytest.mark.parametrize("fov", [90.0, 60.0, 75.5, 110.0, 1.0])
def test_tan_half_fov_is_the_c_librarys(fov):
    half = F32(fov) * F32(camera.REF_PI) / F32(180.0) / F32(2.0)
    assert camera.tan_half_fov(fov) == float(LIBM.tanf(float(half)))


def test_basis_plain_equals_the_kernel_logic():
    """The camera kernel's host twin and its plain version give the same
    basis bit for bit, on the cameras of the tests and the bench and on
    100,000 random triples (the C library's sinf and cosf underneath)."""
    rng = np.random.default_rng(4)
    e = np.concatenate([CAMERAS, np.stack([rng.uniform(-3.2, 3.2, 100_000), rng.uniform(-200, 200, 100_000),
                                           rng.uniform(-1, 1, 100_000)], 1).astype(F32)])
    out = np.empty((len(e), 9), F32)
    build.load_host("camera_host").vx_camera_basis_host(e.ctypes.data, len(e), out.ctypes.data)
    got = torch.cat(camera.basis_plain(torch.from_numpy(e)), dim=1).numpy()
    assert _diffs(got, out) == 0
    pitch, yaw = e[:, 0], e[:, 1]
    np.testing.assert_array_equal(out[:, 1], _c_library("sinf", pitch))  # -forward.y = sin(pitch)
    np.testing.assert_array_equal(out[:, 6], _c_library("cosf", yaw))  # right.x = cos(yaw)


def test_get_directions_on_the_cpu_is_the_plain_version(monkeypatch):
    """A CPU tensor takes the plain version and never the kernel; shapes
    ``[3]`` and ``[n, 3]`` both work."""
    def no_kernel(*a, **k):
        raise AssertionError("the camera kernel was called for a CPU tensor")

    monkeypatch.setattr(camera_kernel, "camera_basis", no_kernel)
    for e in (torch.from_numpy(CAMERAS[0]), torch.from_numpy(CAMERAS)):
        got = camera.get_directions(e)
        want = camera.basis_plain(e)
        for g, w in zip(got, want):
            assert g.shape == e.shape
            np.testing.assert_array_equal(g.numpy(), w.numpy())


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        camera_kernel.camera_basis(torch.zeros(1, 3))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_camera_kernel_equals_plain_on_card(cuda_device):
    """The kernel against its plain version on the card over the grid sweep
    as pitch and yaw, and the cameras; the card's basis equals the CPU's."""
    x = _sweep("grid")
    e = torch.from_numpy(np.stack([x, x[::-1].copy(), np.zeros_like(x)], 1)).to(cuda_device)
    before = camera_kernel.launches
    got = camera_kernel.camera_basis(e)
    assert camera_kernel.launches == before + 1
    want = torch.cat(camera.basis_plain(e), dim=1)
    assert int((got.view(torch.int32) != want.view(torch.int32)).sum()) == 0
    cams = torch.from_numpy(CAMERAS)
    card = torch.cat(camera.get_directions(cams.to(cuda_device)), dim=1).cpu()
    cpu = torch.cat(camera.get_directions(cams), dim=1)
    np.testing.assert_array_equal(card.numpy(), cpu.numpy())
