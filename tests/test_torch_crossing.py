"""The port's crossing dump (``ops/crossing_trace.py``) against the JAX
package's: ``trace_ray_crossings`` field by field, for ``double_step`` on
and off and the macro levels on and off, on rays of ``tests/conftest.py``'s
``small_world`` (and, for macro skips that fire, on a world with empty
regions); ``format_crossings`` gives the same lines; the g++ build of the
record instantiation of K1's loop (``csrc/crossings.cuh``) records the same
rows as its plain version.  Tolerance: equal throughout (floats bit-equal).

Every field of the JAX dump is compared.  The JAX side runs once, in a
subprocess whose XLA:CPU neither contracts FMAs nor runs the algebraic
simplifier (``tests/test_torch_render.py`` module doc); each JAX dump
compiles its own scan, so the file keeps to a few rays.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.ops import crossing_trace as C
from voxelengine_tpu_torch.ops.bigtrace import _kernel_tables, make_line_table, prepared_rays, trace_brickmap_hbm

ROOT = Path(__file__).resolve().parent.parent
BM_KEYS = ("meta", "brick_idx", "bricks", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")
MAX_STEPS = 256
ARRAYS = ("coarse_cell", "fine_cell", "in_fine", "pending", "t_coarse", "t_fine", "point", "steps", "fsteps",
          "want_line", "brick_slot", "position", "normal")
SCALARS = ("iterations", "hit", "hit_immediate", "steps_total")
# (world, ray index, double_step, use_macro): small_world rays 0 (miss), 5
# and 10 in every mode; the sparse world with macro skips on
CASES = [("small", i, ds, um) for i in (0, 5, 10) for ds in (True, False) for um in (True, False)]
CASES += [("sparse", i, ds, True) for i in (0, 1) for ds in (True, False)]


def _small_world():
    """``tests/conftest.py``'s ``small_world`` dense grid and ``ray_batch``."""
    r = np.random.default_rng(1234)
    dense = r.random((32, 32, 32)) < 0.02
    dense[:, 0:4, :] = r.random((32, 4, 32)) < 0.5
    r = np.random.default_rng(5678)
    origins = (r.random((200, 3)) * 64 - 16).astype(np.float32)
    targets = (r.random((200, 3)) * 32).astype(np.float32)
    rays = targets - origins
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    return dense, origins, rays.astype(np.float32)


def _sparse_world():
    """A 128x32x128 world at factor 4 (16 regions, most of them empty) and
    rays that cross empty regions before they reach solid ones."""
    dense = np.zeros((128, 32, 128), bool)
    dense[96:112, 0:8, 96:112] = np.random.default_rng(7).random((16, 8, 16)) < 0.4
    origins = np.array([[2.5, 5.25, 3.0], [127.0, 30.0, 1.5]], np.float32)
    targets = np.array([[104.0, 3.0, 105.0], [100.0, 2.0, 110.0]], np.float32)
    rays = targets - origins
    rays /= np.linalg.norm(rays, axis=1, keepdims=True)
    return dense, origins, rays.astype(np.float32)


WORLDS = {"small": (_small_world, 8), "sparse": (_sparse_world, 4)}


def _key(world, i, ds, um):
    return f"{world}/{i}/ds{int(ds)}/m{int(um)}"


def _jax_reference():
    """JAX side (runs in the subprocess, module doc)."""
    from voxelengine_tpu.core.bitgrid import BitGrid
    from voxelengine_tpu.core.brickmap import build_brickmap
    from voxelengine_tpu.core.layout import Layout
    from voxelengine_tpu.ops.crossing_trace import format_crossings, trace_ray_crossings
    from voxelengine_tpu.ops.pallas_bigtrace import make_line_table as j_lt

    out, tables = {}, {}
    for world, (make, f) in WORLDS.items():
        dense, _, _ = make()
        layout = Layout.TILED_LINEAR if world == "small" else Layout.LINEAR
        bm = build_brickmap(BitGrid.from_dense(dense), f, coarse_layout=layout)
        tables[world] = (bm, j_lt(bm))
        for k in BM_KEYS:
            v = getattr(bm, k)
            out[f"{world}/bm/{k}"] = np.asarray(getattr(v, "value", v))
    for world, i, ds, um in CASES:
        _, origins, rays = WORLDS[world][0]()
        bm, lt = tables[world]
        dump = trace_ray_crossings(bm, lt, origins[i], rays[i], max_steps=MAX_STEPS, use_macro=um, double_step=ds)
        key = _key(world, i, ds, um)
        for k in ARRAYS + SCALARS:
            out[f"{key}/{k}"] = np.asarray(dump[k])
        out[f"{key}/phase"] = np.asarray(["+".join(p) or "-" for p in dump["phase"]] + ["end"])
        out[f"{key}/format"] = np.asarray(format_crossings(dump))
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_ref") / "crossing_ref.npz"
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_disable_hlo_passes=algsimp",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    proc = subprocess.run([sys.executable, __file__, str(path)], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _world(ref, world):
    bm = brickmap_from_numpy({k: ref[f"{world}/bm/{k}"] for k in BM_KEYS}, device="cpu")
    return bm, make_line_table(bm)


@pytest.mark.parametrize("world,i,double_step,use_macro", CASES)
def test_dump_equals_jax_field_by_field(ref, world, i, double_step, use_macro):
    bm, lt = _world(ref, world)
    _, origins, rays = WORLDS[world][0]()
    dump = C.trace_ray_crossings(bm, lt, origins[i], rays[i], max_steps=MAX_STEPS, use_macro=use_macro,
                                 double_step=double_step)
    key = _key(world, i, double_step, use_macro)
    for k in SCALARS:
        assert dump[k] == ref[f"{key}/{k}"].item(), k
    assert ["+".join(p) or "-" for p in dump["phase"]] + ["end"] == ref[f"{key}/phase"].tolist()
    for k in ARRAYS:
        got, want = np.asarray(dump[k]), ref[f"{key}/{k}"]
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=f"{key} {k}")
    assert C.format_crossings(dump) == ref[f"{key}/format"].item()


def test_macro_skips_fire_on_sparse_world(ref):
    """The sparse cases reach the macro skip rows they are there for."""
    phases = [p for k, v in ref.items() if k.startswith("sparse/") and k.endswith("/phase") for p in v.tolist()]
    assert any("mskip" in p for p in phases) and any("step2" in p for p in phases)


def test_dump_result_equals_k1_result(ref):
    """The dump's result is the line-table trace's (the plain K1) for every
    case ray."""
    for world in WORLDS:
        bm, lt = _world(ref, world)
        _, origins, rays = WORLDS[world][0]()
        out = trace_brickmap_hbm(bm, lt, torch.from_numpy(origins), torch.from_numpy(rays), MAX_STEPS,
                                 use_macro=True)
        for i in {c[1] for c in CASES if c[0] == world}:
            dump = C.trace_ray_crossings(bm, lt, origins[i], rays[i], max_steps=MAX_STEPS)
            assert dump["hit"] == bool(out.hit[i]) and dump["steps_total"] == int(out.steps[i])
            if dump["hit"]:
                np.testing.assert_array_equal(dump["position"], out.position[i].numpy())
                np.testing.assert_array_equal(dump["normal"], out.normal[i].numpy())


def _host_record(bm, lt, o, d, use_macro):
    from voxelengine_tpu_torch.kernels import build

    lib = build.load_dda_host()
    sc, dd, act, pad, _ = prepared_rays(bm, o, d)
    tables, _ = _kernel_tables(bm, lt, MAX_STEPS, use_macro)
    n, rmax = o.shape[0], C.iter_limit(MAX_STEPS)
    rows = torch.zeros((n, rmax, C.FIELDS), dtype=torch.int32)
    nrows, flags, steps = (torch.zeros(n, dtype=torch.int32) for _ in range(3))
    pos, nrm = torch.zeros(n, 3), torch.zeros(n, 3)
    (gx, gy, gz), (rx, ry, rz) = bm.grid_dims, lt.region_dims
    assert lib.vx_trace_crossings_host(
        sc.data_ptr(), dd.data_ptr(), act.data_ptr(), pad.data_ptr(), *(t.data_ptr() for t in tables),
        n, gx, gy, gz, rx, ry, rz, bm.factor, bm.words_per_brick, MAX_STEPS, bm.brick_layout.value, rmax,
        int(use_macro), rmax, rows.data_ptr(), nrows.data_ptr(), flags.data_ptr(), pos.data_ptr(),
        nrm.data_ptr(), steps.data_ptr()) == 0
    return rows, nrows, flags, pos, nrm, steps


@pytest.mark.parametrize("world", sorted(WORLDS))
@pytest.mark.parametrize("use_macro", [True, False])
def test_host_build_records_plain_rows(ref, world, use_macro):
    """The g++ build of the record instantiation == ``_lt_step``'s record,
    row for row, and its results, on the world's rays (small world: 40
    mixed rays)."""
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no C++ compiler for the host build of csrc/crossings.cuh")
    bm, lt = _world(ref, world)
    _, origins, rays = WORLDS[world][0]()
    o, d = torch.from_numpy(origins[:40]), torch.from_numpy(rays[:40])
    plain = C.record_crossings(bm, lt, o, d, MAX_STEPS, use_macro)
    host = _host_record(bm, lt, o, d, use_macro)
    assert torch.equal(host[1], plain[1])
    for i in range(o.shape[0]):
        k = int(plain[1][i])
        assert torch.equal(host[0][i, :k], plain[0][i, :k]), i
    for a, b in zip(host[2:], plain[2:]):
        assert torch.equal(a, b)


def test_inactive_ray_has_no_rows(ref):
    bm, lt = _world(ref, "small")
    dump = C.trace_ray_crossings(bm, lt, [-10.0, -10.0, -10.0], [-1.0, 0.0, 0.0], max_steps=MAX_STEPS)
    assert dump["iterations"] == 0 and not dump["hit"] and dump["steps_total"] == 0
    assert dump["coarse_cell"].shape == (0, 3)


# ---------------------------------------------------------------------------
# card lane
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("use_macro", [True, False])
def test_record_kernel_equals_plain_on_card(use_macro):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    from voxelengine_tpu_torch.core.bitgrid import BitGrid
    from voxelengine_tpu_torch.core.brickmap import build_brickmap
    from voxelengine_tpu_torch.kernels import crossings

    dense, origins, rays = _small_world()
    bm = build_brickmap(BitGrid.from_dense(torch.from_numpy(dense)), 8)
    lt = make_line_table(bm)
    o, d = torch.from_numpy(origins[:32]), torch.from_numpy(rays[:32])
    plain = C.record_crossings(bm, lt, o, d, MAX_STEPS, use_macro)
    dev = torch.device("cuda")
    bmc = build_brickmap(BitGrid.from_dense(torch.from_numpy(dense).to(dev)), 8)
    before = crossings.launches
    card = [t.cpu() for t in C.record_crossings(bmc, make_line_table(bmc), o.to(dev), d.to(dev), MAX_STEPS,
                                                use_macro)]
    assert crossings.launches == before + 1
    assert torch.equal(card[1], plain[1])
    for i in range(32):
        k = int(plain[1][i])
        assert torch.equal(card[0][i, :k], plain[0][i, :k])
    for a, b in zip(card[2:], plain[2:]):
        assert torch.equal(a, b)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
