"""Test harness configuration: run everything on a virtual 8-device CPU mesh
(multi-chip sharding paths validated without TPU hardware).

VOX_TPU_TESTS=1 skips the CPU forcing so the TPU smoke lane
(test_tpu_smoke.py) can compile the Pallas kernels on real hardware:
    VOX_TPU_TESTS=1 python -m pytest tests/test_tpu_smoke.py -q
"""

import os

_TPU_LANE = os.environ.get("VOX_TPU_TESTS") == "1"
if not _TPU_LANE:
    os.environ.setdefault("JAX_PLATFORM_NAME", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

import jax  # noqa: E402

if not _TPU_LANE:
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_resident_jit_code():
    """Release compiled executables at module boundaries.

    A full cold suite run keeps every module's jitted programs loaded in
    one process; at ~190 accumulated compiles the XLA:CPU JIT has been
    observed (2 of 4 fresh-machine runs, both at the same next compile)
    to segfault inside ``backend_compile_and_load`` — a resident-code-
    volume/layout artifact, not a repo bug: the same test passes alone,
    and any subset of the suite passes.  Dropping the jit caches between
    modules bounds resident compiled code; modules share no compiled
    programs of consequence (shapes differ), so the runtime cost is
    small.
    """
    yield
    jax.clear_caches()


@pytest.fixture()
def rng():
    """Fresh deterministic generator per test (order-independent)."""
    return np.random.default_rng(0xC0FFEE)


@pytest.fixture(scope="session")
def small_world():
    """Shared random 32^3 world with a floor, plus its brickmap (factor 8)."""
    from voxelengine_tpu.core.bitgrid import BitGrid
    from voxelengine_tpu.core.brickmap import build_brickmap

    r = np.random.default_rng(1234)
    dense = r.random((32, 32, 32)) < 0.02
    dense[:, 0:4, :] = r.random((32, 4, 32)) < 0.5  # y-floor ([z, y, x] order)
    grid = BitGrid.from_dense(dense)
    bm = build_brickmap(grid, 8)
    return dense, grid, bm


@pytest.fixture(scope="session")
def ray_batch():
    """Random rays from inside and outside the 32^3 world."""
    r = np.random.default_rng(5678)
    n = 200
    origins = (r.random((n, 3)) * 64 - 16).astype(np.float32)
    targets = (r.random((n, 3)) * 32).astype(np.float32)
    rays = targets - origins
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    return origins, rays.astype(np.float32)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA GPU (the PyTorch port's CUDA kernels); "
        "skipped where torch.cuda.is_available() is false",
    )
