"""K4's wrapper (``voxelengine_tpu_torch/kernels/bmtrace.py``): its choice
between the two instantiations of ``csrc/bmtrace.cu`` (``meta`` in a block's
shared memory, or in global memory) by the table's size alone, its refusals,
and, on the card, both instantiations against the plain ``trace_brickmap``.

The DDA body both instantiations run is held against the JAX package on the
CPU by ``tests/test_torch_gridtrace.py`` (its g++ build with the dense-slot
fetch); here the card lane holds the kernels themselves, bit for bit.
"""

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import build_brickmap
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.kernels import bmtrace, build
from voxelengine_tpu_torch.ops.trace import trace_brickmap
from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_mxu

LIMIT_CHUNKS = bmtrace.SMEM_META_LIMIT // 4  # 58,112 chunks: 227 KB of meta words


@pytest.mark.parametrize("num_chunks,shared", [
    (1, True),
    (4096, True),             # 128^3 at factor 8, K4's documented scope
    (32768, True),            # pallas_trace2.py's own limit, ~32k chunks
    (LIMIT_CHUNKS, True),     # exactly 227 KB
    (LIMIT_CHUNKS + 1, False),
    (131072, False),          # 512x256x512 at factor 8: 512 KB
])
def test_instantiation_is_chosen_by_table_size(num_chunks, shared):
    assert bmtrace.SMEM_META_LIMIT == 227 * 1024
    assert bmtrace.meta_in_shared(num_chunks) is shared


def test_launcher_signature_extends_the_host_entry():
    """The launcher takes the host entry's arguments plus the instantiation
    flag and the work-counter scratch (and the stream, added at load)."""
    host = build.HOST_ENTRIES["vx_trace_brickmap_dense_host"]
    kernel = build.SIGNATURES["vx_trace_brickmap_dense"]
    assert kernel[:16] == host[:16] and kernel[-4:] == host[-4:]
    assert kernel[16:18] == [build._I, build._P] and len(kernel) == len(host) + 2


def _rays(n, dev="cpu"):
    z3 = torch.zeros(n, 3, device=dev)
    return z3, z3.clone(), torch.zeros(n, dtype=torch.int32, device=dev), torch.zeros(n, 3, dtype=torch.int32,
                                                                                          device=dev)


KW = dict(factor=8, max_steps=16, coarse_layout=Layout.LINEAR, brick_layout=Layout.TILED_LINEAR)


def test_wrapper_refuses_cpu_tensors():
    before = (bmtrace.launches, bmtrace.shared_launches)
    with pytest.raises(ValueError, match="CUDA"):
        bmtrace.bmtrace(*_rays(4), torch.zeros(64, dtype=torch.int32), torch.zeros(64, 16, dtype=torch.int32),
                        grid_dims=(4, 4, 4), **KW)
    assert (bmtrace.launches, bmtrace.shared_launches) == before


@pytest.mark.parametrize("grid,kw,match", [
    ((4, 4, 4), dict(factor=0), "int32 indices"),
    ((4, 4, 4), dict(factor=33), "int32 indices"),
    ((1024, 1024, 128), dict(factor=32), "int32 indices"),  # 2^27 chunks x 1024 words
    ((12, 8, 8), dict(coarse_layout=Layout.TILED_LINEAR), "divisible by 8"),
])
def test_wrapper_refuses_grids_outside_the_kernel(grid, kw, match):
    with pytest.raises(ValueError, match=match):
        bmtrace.bmtrace(*_rays(4), torch.zeros(1, dtype=torch.int32), torch.zeros(1, 16, dtype=torch.int32),
                        grid_dims=grid, **dict(KW, **kw))


# ------------------------------------------------------------ card lane


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    return torch.device("cuda")


def _world_and_rays(dims, seed, n, dev, coarse=Layout.TILED_LINEAR):
    """A random dense-slot brickmap at factor 8 over a floor, and rays from
    inside and outside it, from a numpy seed."""
    X, Y, Z = dims
    rng = np.random.default_rng(seed)
    dense = rng.random((Z, Y, X)) < 0.006
    dense[:, :4, :] = rng.random((Z, 4, X)) < 0.5
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(dense).to(dev)), 8, coarse_layout=coarse,
                        brick_layout=Layout.TILED_LINEAR)
    w = np.asarray(dims, np.float32)
    o = rng.random((n, 3)) * w * 1.8 - w * 0.4
    d = rng.random((n, 3)) * w - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    d[1:4] = np.eye(3)  # axis-aligned
    return bm, torch.from_numpy(o.astype(np.float32)).to(dev), torch.from_numpy(d.astype(np.float32)).to(dev)


def _assert_same(got, want):
    assert torch.equal(got.hit, want.hit) and torch.equal(got.steps, want.steps)
    assert torch.equal(got.position[got.hit], want.position[want.hit])
    assert torch.equal(got.normal[got.hit], want.normal[want.hit])


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared_meta", "global_meta"])
@pytest.mark.parametrize("coarse", ["LINEAR", "TILED_MORTON"])
def test_both_instantiations_match_plain_trace_on_card(cuda_device, monkeypatch, shared, coarse):
    """Each instantiation == the plain trace on a 64^3 world (512 chunks);
    the global one is forced by a zero limit."""
    bm, o, d = _world_and_rays((64, 64, 64), 90, 4096, cuda_device, Layout[coarse])
    if not shared:
        monkeypatch.setattr(bmtrace, "SMEM_META_LIMIT", 0)
    before = (bmtrace.launches, bmtrace.shared_launches)
    got = trace_brickmap_mxu(bm, o, d, 256)
    torch.cuda.synchronize()
    assert (bmtrace.launches, bmtrace.shared_launches) == (before[0] + 1, before[1] + shared)
    _assert_same(got, trace_brickmap(bm, o, d, 256))


@pytest.mark.cuda
def test_global_meta_on_a_world_over_the_limit_on_card(cuda_device):
    """A 384x256x384 world at factor 8 (73,728 chunks, 288 KB of meta) runs
    the global-meta instantiation by its size, and == the plain trace."""
    bm, o, d = _world_and_rays((384, 256, 384), 91, 16384, cuda_device)
    assert not bmtrace.meta_in_shared(bm.num_chunks)
    before = (bmtrace.launches, bmtrace.shared_launches)
    got = trace_brickmap_mxu(bm, o, d, 1024)
    torch.cuda.synchronize()
    assert (bmtrace.launches, bmtrace.shared_launches) == (before[0] + 1, before[1])
    _assert_same(got, trace_brickmap(bm, o, d, 1024))


@pytest.mark.cuda
def test_wrapper_refuses_malformed_tables_on_card(cuda_device):
    rays = _rays(4, cuda_device)
    i32 = dict(dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="meta"):
        bmtrace.bmtrace(*rays, torch.zeros(63, **i32), torch.zeros(64, 16, **i32), grid_dims=(4, 4, 4), **KW)
    with pytest.raises(ValueError, match="bricks"):
        bmtrace.bmtrace(*rays, torch.zeros(64, **i32), torch.zeros(64, 15, **i32), grid_dims=(4, 4, 4), **KW)
    with pytest.raises(ValueError, match="meta"):
        bmtrace.bmtrace(*rays, torch.zeros(64, dtype=torch.int64, device=cuda_device), torch.zeros(64, 16, **i32),
                        grid_dims=(4, 4, 4), **KW)
