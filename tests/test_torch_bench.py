"""The port's bench harness (``voxelengine_tpu_torch/bench.py``) against the
repo's ``bench.py`` and the JAX package, on the CPU at a tiny size.

``run(device="cpu")`` on a 128x64x128 terrain at 4 octaves (camera at
y = 50 so the frame sees terrain, Euler angles (-0.24, 0.76, 0), and on one
route the bench camera's own (-0.25, 0.75, 0)), 64x48, 2 frames x 2
batches: its final
framebuffer equals the JAX package's ``render_frame`` loop over the same
world with the same frame numbers and camera drift (frame 0, then frames
1 .. 6 at ``euler + float32(1e-5) * i``), bit for bit, for the ``pallas``
route (the line table), the ``xla`` route (no line table) and the
host-resident-bricks route with a block permutation and the staged trace;
the world it caches equals JAX's build.  The JAX side runs once, in a
subprocess whose XLA:CPU neither contracts FMAs nor runs the algebraic
simplifier (``tests/test_torch_render.py`` module doc), its frames through
the XLA walk (the line table's walk with the macro levels off, which the
probe picks on this one-region world, is the same chunk walk).

Also: the metric names against ``bench.py``'s own expression, the exit
codes (4 when the gate sees a diff, 3 without a card, 2 for a TPU-only
knob) and that no JSON line is printed for a failed run, and that
``bench_configs --full`` starts the harness.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch import bench
from voxelengine_tpu_torch.io.checkpoint import load_world

ROOT = Path(__file__).resolve().parent.parent
DIMS, OCTAVES, CAMERA_Y, EULER = (128, 64, 128), 4, 50.0, (-0.24, 0.76, 0.0)
BENCH_EULER = (-0.25, 0.75, 0.0)  # bench.py:192
SIZE = dict(width=64, height=48)
TINY = dict(world="small", dims=DIMS, octaves=OCTAVES, camera_y=CAMERA_Y, euler=EULER, frames=2, batches=2,
            device="cpu", **SIZE)
BM_KEYS = ("meta", "brick_idx", "bricks")
# the harness's routes: name -> (run() arguments over TINY, JAX frame sequence)
ROUTES = {
    "pallas": (dict(backend="pallas"), "plain"),
    "xla": (dict(backend="xla"), "plain"),
    "pallas_host_bricks_blocksort_staged": (dict(backend="pallas", host_bricks=True, blocksort=True, stage=8,
                                                 iters=True), "twice0"),
    "pallas_bench_camera": (dict(backend="pallas", euler=BENCH_EULER), "bench_camera"),
}
LAST_FRAME = 6  # frame 0, warm-up 1-2, batches 3-4 and 5-6


def _jax_reference():
    """JAX side (runs in the subprocess, module doc): the world's tables and
    the framebuffer after frames 4 and 6 of the harness's sequence, plain
    and with frame 0 rendered twice (the block-sorted frame's place)."""
    import jax.numpy as jnp

    from voxelengine_tpu.config import Environment as JEnv
    from voxelengine_tpu.config import RenderConfig as JCfg
    from voxelengine_tpu.core.brickmap import build_brickmap_terrain_compact
    from voxelengine_tpu.render.frame import make_framebuffer, render_frame

    out = {}
    bm = build_brickmap_terrain_compact(DIMS, 32, octaves=OCTAVES)
    for k in BM_KEYS:
        out[f"bm/{k}"] = np.asarray(getattr(bm, k))
    cfg = JCfg(checkerboard=True, tile_order=True, **SIZE)
    env = JEnv.default()
    origin = jnp.asarray([DIMS[0] / 2, CAMERA_Y, DIMS[2] / 2], jnp.float32)
    for seq, zeros, e in (("plain", 1, EULER), ("twice0", 2, EULER), ("bench_camera", 1, BENCH_EULER)):
        euler = jnp.asarray(e, jnp.float32)
        fb = make_framebuffer(cfg)
        for _ in range(zeros):
            fb = render_frame(bm, fb, origin, euler, env, jnp.int32(0), cfg)
        for i in range(1, LAST_FRAME + 1):
            fb = render_frame(bm, fb, origin, euler + jnp.float32(1e-5) * i, env, jnp.int32(i), cfg)
            if i in (4, LAST_FRAME):
                out[f"{seq}/{i}"] = np.asarray(fb)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """Run this file's JAX side in a subprocess with XLA:CPU's FMA
    contraction and algebraic simplifier off (module doc)."""
    path = tmp_path_factory.mktemp("jax_ref") / "bench_ref.npz"
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


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The port side on one CPU thread (``tests/test_torch_shade.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """One world cache for the file's runs (the first run builds it)."""
    return str(tmp_path_factory.mktemp("world_cache"))


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_run_on_cpu_bit_equal_to_jax_frames(ref, cache, capsys, name):
    kw, seq = ROUTES[name]
    res = bench.run(cache_dir=cache, **{**TINY, **kw})
    np.testing.assert_array_equal(res.framebuffer.numpy(), ref[f"{seq}/{LAST_FRAME}"])
    assert res.hit_diffs == 0
    rec = res.record
    assert rec["metric"] == "primary_mrays_per_s_48p_checkerboard_1k_world"
    assert rec["unit"] == "Mrays/s" and rec["n_batches"] == 2 and len(rec["batch_ms"]) == 2
    assert rec["device"] == "cpu" and rec["value"] > 0
    assert capsys.readouterr().out == ""  # run() prints nothing on stdout
    world = load_world(os.path.join(cache, bench.world_key(DIMS, OCTAVES) + ".npz"), device="cpu")
    for k in BM_KEYS:
        np.testing.assert_array_equal(getattr(world, k).numpy(), ref[f"bm/{k}"].view(np.int32))


def test_profiled_batch_is_one_batch(ref, cache, tmp_path):
    """With a profile directory the timed batch is traced, once: frames
    0 .. 4, and a chrome trace in the directory."""
    res = bench.run(cache_dir=cache, profile=str(tmp_path / "prof"), **TINY)
    np.testing.assert_array_equal(res.framebuffer.numpy(), ref["plain/4"])
    assert res.record["n_batches"] == 1
    assert (tmp_path / "prof" / "bench_small_pallas.json").stat().st_size > 0


def _bench_py_metric(world, cfg):
    """The metric name as the repo's ``bench.py:402-411`` computes it (its
    own source lines, run here)."""
    src = (ROOT / "bench.py").read_text().splitlines()
    start = next(i for i, line in enumerate(src) if line.strip() == 'shading = ""')
    end = next(i for i in range(start, len(src)) if '+ "_world" + shading)' in src[i])
    scope = {"world": world, "cfg": cfg}
    exec(textwrap.dedent("\n".join(src[start:end + 1])), scope)
    return scope["metric"]


@pytest.mark.parametrize("world", sorted(bench.WORLDS))
@pytest.mark.parametrize("shadows,ao,reflect", [
    (False, 0, False), (True, 0, False), (False, 4, False), (False, 0, True),
    (True, 4, False), (True, 0, True), (False, 4, True), (True, 4, True),
])
def test_metric_names_are_bench_py_names(world, shadows, ao, reflect):
    cfg = SimpleNamespace(height=1080, shadow_rays=shadows, ao_samples=ao, reflections=reflect)
    assert bench.metric_name(world, 1080, shadows, ao, reflect) == _bench_py_metric(world, cfg)


def _main_on_tiny_world(monkeypatch, cache):
    """Route :func:`bench.main`'s call of :func:`bench.run` to the tiny world."""
    real = bench.run
    monkeypatch.setattr(bench, "run", lambda **kw: real(**dict(kw, dims=DIMS, octaves=OCTAVES, camera_y=CAMERA_Y,
                                                               euler=EULER, cache_dir=cache)))
    return {"BENCH_ALLOW_CPU": "1", "BENCH_WORLD": "small", "BENCH_W": "64", "BENCH_H": "48", "BENCH_FRAMES": "1",
            "BENCH_BATCHES": "1"}


def test_main_prints_one_json_line(cache, monkeypatch, capsys):
    env = _main_on_tiny_world(monkeypatch, cache)
    assert bench.main(dict(env, BENCH_BACKEND="xla")) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1
    import json

    rec = json.loads(lines[0])
    assert list(rec) == ["metric", "value", "unit", "vs_baseline", "n_batches", "batch_ms", "device"]
    assert rec["metric"] == "primary_mrays_per_s_48p_checkerboard_1k_world" and rec["n_batches"] == 1


@pytest.mark.parametrize("backend", ["pallas", "xla"])
def test_gate_diff_exits_4_without_json(cache, monkeypatch, capsys, backend):
    """One flipped hit of the plain reference fails the gate (0.01% of
    1,536 rays is 0): exit 4, nothing on stdout."""
    from voxelengine_tpu_torch.ops import trace

    real = trace.trace_brickmap

    def flipped(*a, **k):
        out = real(*a, **k)
        hit = out.hit.clone()
        hit[0] = ~hit[0]
        return out._replace(hit=hit)

    monkeypatch.setattr(trace, "trace_brickmap", flipped)
    env = _main_on_tiny_world(monkeypatch, cache)
    with pytest.raises(SystemExit) as e:
        bench.main(dict(env, BENCH_BACKEND=backend))
    assert e.value.code == 4
    out = capsys.readouterr()
    assert out.out == "" and "FATAL: hit diffs" in out.err


def test_no_card_exits_3_before_any_work(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench.run(world="small", cache_dir=str(tmp_path / "c"))
    assert e.value.code == 3
    with pytest.raises(SystemExit) as e:
        bench.main({})
    assert e.value.code == 3
    assert not (tmp_path / "c").exists()
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("knob", sorted(bench.TPU_ONLY_KNOBS))
def test_tpu_only_knobs_are_refused(knob, capsys):
    assert bench.main({knob: "16", "BENCH_ALLOW_CPU": "1"}) == 2
    out = capsys.readouterr()
    assert out.out == "" and knob in out.err and "no counterpart" in out.err


def test_bench_configs_full_starts_the_harness(monkeypatch, capsys):
    """``bench_configs --full`` runs the four configs, then the harness as
    ``python -m voxelengine_tpu_torch.bench`` in a subprocess, and returns
    its exit code."""
    from voxelengine_tpu_torch.apps import bench_configs

    for name in ("config1", "config2", "config3", "config5"):
        monkeypatch.setattr(bench_configs, name, lambda name=name: f"{name} ran")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    calls = []
    monkeypatch.setattr(bench_configs.subprocess, "run",
                        lambda cmd, **kw: calls.append(cmd) or SimpleNamespace(returncode=7))
    assert bench_configs.main([]) == 0 and calls == []
    assert bench_configs.main(["--full"]) == 7
    assert calls == [[sys.executable, "-m", "voxelengine_tpu_torch.bench"]]
    assert capsys.readouterr().out.count("config5 ran") == 2


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference())
