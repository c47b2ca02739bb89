"""The PyTorch port's config, layouts, bit packing and state interop
against the JAX package (same numpy inputs, integer outputs bit-equal)."""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelengine_tpu import config as jcfg
from voxelengine_tpu.core import bitgrid as jbg
from voxelengine_tpu.core import layout as jlay
from voxelengine_tpu_torch import config as tcfg
from voxelengine_tpu_torch.core import bitgrid as tbg
from voxelengine_tpu_torch.core import layout as tlay
from voxelengine_tpu_torch.io.interop import (
    brickmap_from_numpy,
    environment_from_numpy,
    line_table_from_numpy,
)

ROOT = Path(__file__).resolve().parent.parent
LAYOUTS = ("LINEAR", "TILED_LINEAR", "TILED_MORTON")


def test_port_imports_neither_jax_nor_the_jax_package():
    code = (
        "import sys, pkgutil, importlib, voxelengine_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'voxelengine_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib', 'voxelengine_tpu.'))"
        " or k == 'voxelengine_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stdout + out.stderr


def test_config_constants_and_enums_match():
    assert tcfg.FLT_EPS_DDA == jcfg.FLT_EPS_DDA and tcfg.MAX_STEPS == jcfg.MAX_STEPS
    for a, b in ((tcfg.DebugView, jcfg.DebugView), (tcfg.Projection, jcfg.Projection),
                 (tlay.Layout, jlay.Layout)):
        assert [(m.name, m.value) for m in a] == [(m.name, m.value) for m in b]


def test_render_config_keeps_the_reference_fields():
    t, j = tcfg.RenderConfig(), jcfg.RenderConfig()
    tuned_for_tpu = {"trace_tile", "trace_slots", "trace_shortlist", "staged_trace", "stage_iters", "tail_frac",
                     "stage_schedule"}
    tf = {f.name for f in t.__dataclass_fields__.values()}
    jf = {f.name for f in j.__dataclass_fields__.values()}
    assert tf == jf - tuned_for_tpu
    for name in tf:
        a, b = getattr(t, name), getattr(j, name)
        assert (a.name, a.value) == (b.name, b.value) if hasattr(a, "value") else a == b, name


def test_environment_default_bit_equal():
    t, j = tcfg.Environment.default(device="cpu"), jcfg.Environment.default()
    for k in ("light_direction", "light_color", "ambient_color"):
        np.testing.assert_array_equal(getattr(t, k).numpy(), np.asarray(getattr(j, k)), err_msg=k)
    e = environment_from_numpy({k: np.asarray(getattr(j, k)) for k in ("light_direction", "light_color", "ambient_color")},
                              device="cpu")
    assert torch.equal(e.light_direction, t.light_direction)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_sample_index_and_inverse_bit_equal(rng, layout):
    x, y, z = (rng.integers(0, 64, 4000) for _ in range(3))
    tl, jl = tlay.Layout[layout], jlay.Layout[layout]
    got = tlay.sample_index(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(z), 64, 32, tl)
    want = np.asarray(jlay.sample_index(jnp.asarray(x), jnp.asarray(y), jnp.asarray(z), 64, 32, jl))
    np.testing.assert_array_equal(got.numpy(), want)
    back = tlay.position_from_sample_index(got, 64, 32, tl)
    jback = jlay.position_from_sample_index(jnp.asarray(want), 64, 32, jl)
    for a, b in zip(back, jback):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_morton_helpers_bit_equal():
    v = np.arange(8)
    for fn in ("_part1by2", "_compact1by2"):
        np.testing.assert_array_equal(getattr(tlay, fn)(torch.from_numpy(v)).numpy(),
                                      np.asarray(getattr(jlay, fn)(jnp.asarray(v))))
    a, b, c = np.meshgrid(v, v, v, indexing="ij")
    got = tlay._morton3d_8(*(torch.from_numpy(t.reshape(-1)) for t in (a, b, c)))
    want = jlay._morton3d_8(*(jnp.asarray(t.reshape(-1)) for t in (a, b, c)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_words_for_bits():
    for n in (0, 1, 31, 32, 33, 125, 32768):
        assert tbg.words_for_bits(n) == jbg.words_for_bits(n)


def test_pack_unpack_bits_bit_equal(rng):
    bits = rng.random(32 * 300) < 0.5
    bits[:32] = True  # a word with bit 31 set: uint32 0xFFFFFFFF, int32 -1
    got = tbg.pack_bits(torch.from_numpy(bits))
    want = np.asarray(jbg.pack_bits(jnp.asarray(bits)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    np.testing.assert_array_equal(tbg.unpack_bits(got).numpy(), bits)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_layout_order_bits_bit_equal(rng, layout):
    dense = rng.random((16, 8, 24)) < 0.3
    got = tbg.layout_order_bits(torch.from_numpy(dense), tlay.Layout[layout])
    want = np.asarray(jbg.layout_order_bits(jnp.asarray(dense), jlay.Layout[layout]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_brickmap_from_numpy_takes_save_world_keys():
    from voxelengine_tpu.core.bitgrid import BitGrid
    from voxelengine_tpu.core.brickmap import build_brickmap
    from voxelengine_tpu.ops.pallas_bigtrace import make_line_table

    dense = np.random.default_rng(3).random((32, 32, 32)) < 0.1
    bm = build_brickmap(BitGrid.from_dense(dense), 8)
    d = dict(  # exactly the keys io/checkpoint.py::save_world writes
        meta=np.asarray(bm.meta), brick_idx=np.asarray(bm.brick_idx), bricks=np.asarray(bm.bricks),
        grid_dims=np.asarray(bm.grid_dims), factor=bm.factor, coarse_layout=bm.coarse_layout.value,
        brick_layout=bm.brick_layout.value, dense_slots=bm.dense_slots,
    )
    t = brickmap_from_numpy(d, device="cpu")
    assert t.grid_dims == bm.grid_dims and t.factor == 8 and t.dense_slots
    assert t.coarse_layout.value == bm.coarse_layout.value and t.brick_layout.value == bm.brick_layout.value
    assert t.bricks.dtype == torch.int32
    np.testing.assert_array_equal(t.bricks.numpy(), np.asarray(bm.bricks).view(np.int32))
    np.testing.assert_array_equal(t.meta.numpy(), d["meta"])
    with pytest.raises(KeyError):
        brickmap_from_numpy({k: v for k, v in d.items() if k != "bricks"}, device="cpu")

    lt = make_line_table(bm)
    tl = line_table_from_numpy(dict(region_lines=np.asarray(lt.region_lines), macro=np.asarray(lt.macro),
                                    macro2=np.asarray(lt.macro2), num_regions=lt.num_regions,
                                    region_dims=lt.region_dims), device="cpu")
    assert tl.region_dims == lt.region_dims and tl.brick_lines is None
    np.testing.assert_array_equal(tl.region_lines.numpy(), np.asarray(lt.region_lines))


def test_profiling_utilities_match_jax():
    """``utils/profiling.py``: the same EMA frame timer and ray statistics
    as the JAX module, and a ``timed`` bracket that needs no card on the CPU."""
    from voxelengine_tpu.utils import profiling as jprof
    from voxelengine_tpu_torch.utils import profiling as tprof

    for mod in (tprof, jprof):
        s = mod.TraceStats()
        s.record(1_000_000, 10.0, 5_000_000)
        s.record(500_000, 5.0, 1_000_000)
        assert (s.rays, s.total_ms, s.total_steps) == (1_500_000, 15.0, 6_000_000)
        assert np.isclose(s.mrays_per_s, 100.0) and np.isclose(s.avg_steps, 4.0)
        t = mod.FrameTimer(alpha=0.5)
        assert t.fps == 0.0 and t.tick() == 0.0
        t.tick()
        t.tick()
        assert t.frames == 3 and t.ema_ms >= 0.0
    sink = {}
    with tprof.timed("build", sink, verbose=False, device="cpu"):
        torch.ones(8).sum()
    with tprof.timed("host", sink, verbose=False):
        pass
    assert set(sink) == {"build", "host"} and all(v >= 0.0 for v in sink.values())
