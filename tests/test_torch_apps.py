"""The port's apps against the JAX package's: ``voxel_app`` headless on a
128^3 world (4 octaves) at 64x48 under one scripted input with moves, a
drag, a crosshair break and a place, in its default mode, with ``--dense``
and with ``--ortho`` (plus a scroll zoom); and ``bench_configs``'s config 1
at its small size.

After the edits the world's integer tables (meta, slots, bricks, and the
line table's region lines and macro words) are bit-equal to the JAX app's
on the same script.  The JAX side runs in subprocesses, one a mode side by
side (each app run through ``runpy`` with ``best_input`` patched, not
edited), with XLA's default passes, since XLA:CPU crashes compiling ``apply_edits_hbm``
without its algebraic simplifier (ROADMAP Queue 3); FMA contraction stays
off (``--xla_cpu_max_isa=AVX``).  The presented frames (every numbered
PPM the sink writes) are byte-equal, the render tests' tolerance; the
simplifier could rewrite a division by a constant into a multiplication
(``tests/test_torch_render.py``), which at these sizes changes no pixel.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from voxelengine_tpu_torch.apps import voxel_app
from voxelengine_tpu_torch.runtime.input import ScriptedInput

ROOT = Path(__file__).resolve().parent.parent
SCRIPT = [["w"], ["drag:0,229"], ["f"], ["w", "right"], ["g"], ["b", "a"], ["scroll:1"], []]
BASE = ["--size", "128", "128", "128", "--octaves", "4", "--width", "64", "--height", "48", "--frames",
        str(len(SCRIPT)), "--record"]
MODES = {"default": [], "dense": ["--dense"], "ortho": ["--ortho"]}
WORLD_KEYS = ("meta", "brick_idx", "bricks")
LT_KEYS = ("region_lines", "macro", "macro2")


def _frames(outdir):
    return {p.name: np.frombuffer(p.read_bytes(), np.uint8) for p in sorted(Path(outdir).glob("frame_*.ppm"))}


def _jax_reference(out_dir, mode):
    """JAX side of ``mode`` (runs in a subprocess, module doc)."""
    import runpy

    import voxelengine_tpu
    import voxelengine_tpu.runtime.input as jin

    jin.best_input = lambda scripted=None: jin.ScriptedInput(SCRIPT)
    made = []

    class Recorded(voxelengine_tpu.VoxelRaytracer3D):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

    voxelengine_tpu.VoxelRaytracer3D = Recorded
    out = {}
    work = Path(out_dir) / f"jax_{mode}"
    work.mkdir()
    os.chdir(work)
    sys.argv = ["voxel_app.py", *BASE, *MODES[mode]]
    runpy.run_path(str(ROOT / "apps" / "voxel_app.py"), run_name="__main__")
    for name, data in _frames(work / "frames").items():
        out[f"{mode}/{name}"] = data
    if made:
        rt = made[0]
        for k in WORLD_KEYS:
            out[f"{mode}/world/{k}"] = np.asarray(getattr(rt.world, k))
        for k in LT_KEYS:
            out[f"{mode}/lt/{k}"] = np.asarray(getattr(rt.line_table, k))
    return out


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(jax, port)``: the JAX app's runs, one subprocess a mode side by side
    (each compiles its own interpret-mode kernels), and meanwhile the port's
    runs of each mode, as ``mode -> (rt, frames, crosshair raytrace calls)``."""
    from voxelengine_tpu_torch.engine import raytracer

    d = tmp_path_factory.mktemp("apps")
    env = dict(
        os.environ, JAX_PLATFORMS="cpu", VOXELENGINE_JAX_CACHE=str(d / "jc"),
        # no FMA contraction; one thread each, so the three compile side by side
        XLA_FLAGS="--xla_cpu_max_isa=AVX --xla_cpu_multi_thread_eigen=false intra_op_parallelism_threads=1",
        PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p),
    )
    procs = {mode: subprocess.Popen([sys.executable, __file__, str(d / f"{mode}.npz"), mode], env=env, cwd=d,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for mode in MODES}
    port = {}
    real = raytracer.VoxelRaytracer3D.raytrace
    with pytest.MonkeyPatch.context() as mp:
        for mode, extra in MODES.items():
            calls = []

            def spy(self, o, r, max_steps=2048, calls=calls):
                calls.append(max_steps)
                return real(self, o, r, max_steps)

            mp.setattr(raytracer.VoxelRaytracer3D, "raytrace", spy)
            work = d / f"port_{mode}"
            work.mkdir()
            mp.chdir(work)
            mp.setattr(voxel_app, "best_input", lambda scripted=None: ScriptedInput(SCRIPT))
            run = voxel_app.main([*BASE, *extra, "--device", "cpu"])
            assert run.frames == len(SCRIPT)
            port[mode] = (run.rt, _frames(work / "frames"), calls)
    jax_out = {}
    for mode, proc in procs.items():
        log, _ = proc.communicate(timeout=900)
        assert proc.returncode == 0, log
        with np.load(d / f"{mode}.npz") as z:
            jax_out.update({k: z[k] for k in z.files})
    return jax_out, port


def _bits(a):
    a = np.asarray(a)
    return a.astype(np.int64) & 0xFFFFFFFF


@pytest.mark.parametrize("mode", sorted(MODES))
def test_app_run_matches_jax(runs, mode):
    ref, port = runs
    rt, frames, _ = port[mode]
    want = sorted(k[len(mode) + 1:] for k in ref if k.startswith(f"{mode}/frame_"))
    assert sorted(frames) == want == [f"frame_{i:06d}.ppm" for i in range(len(SCRIPT))]
    for name in want:
        np.testing.assert_array_equal(frames[name], ref[f"{mode}/{name}"], err_msg=name)
    if mode == "dense":
        assert rt is None
        return
    for k in WORLD_KEYS:
        np.testing.assert_array_equal(_bits(getattr(rt.world, k).numpy()), _bits(ref[f"{mode}/world/{k}"]), err_msg=k)
    for k in LT_KEYS:
        np.testing.assert_array_equal(_bits(getattr(rt.line_table, k).numpy()), _bits(ref[f"{mode}/lt/{k}"]),
                                      err_msg=k)


def test_app_edits_change_the_world(runs):
    """The script's break and place hit the world: the edited bricks differ
    from a fresh build's."""
    from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain

    rt = runs[1]["default"][0]
    fresh = build_brickmap_terrain((128, 128, 128), 32, octaves=4, device="cpu")
    assert not torch.equal(rt.world.bricks, fresh.bricks)


@pytest.mark.parametrize("mode", ["default", "ortho"])
def test_crosshair_goes_through_raytrace(runs, mode):
    """The crosshair break and place trace through ``rt.raytrace`` (on the
    card K1 with the macro levels off, or K4), once each."""
    assert len(runs[1][mode][2]) == 2


def test_bench_config1_small(monkeypatch):
    """``bench_configs`` config 1 at a small size on the CPU: the trace
    agrees with the port's oracle copy on every ray."""
    from voxelengine_tpu_torch.apps import bench_configs

    line = bench_configs.config1(n=48, device=torch.device("cpu"))
    assert line.startswith("oracle parity: 48/48 rays exact"), line


def test_bench_config1_card_route_reaches_k4(monkeypatch):
    """Config 1 routed as a card call reaches K4's entry (a spy that runs
    the plain trace), never the plain walk directly."""
    from voxelengine_tpu_torch.apps import bench_configs
    from voxelengine_tpu_torch.ops import trace2

    seen = []

    def spy(bm, o, d, max_steps):
        seen.append(o.shape[0])
        return trace2.trace_brickmap(bm, o, d, max_steps)

    monkeypatch.setattr(trace2, "_is_cuda", lambda t: True)
    monkeypatch.setattr(trace2, "_trace_brickmap_kernel", spy)
    line = bench_configs.config1(n=16, device=torch.device("cpu"))
    assert seen == [16] and line.startswith("oracle parity: 16/16"), (seen, line)


def test_bench_config5_traces_through_the_line_table(monkeypatch):
    """Config 5 edits through ``edit_voxels`` and re-traces through
    ``trace_brickmap_hbm`` with the macro levels off (K1 on the card), once
    a round plus the warm-up."""
    from voxelengine_tpu_torch.apps import bench_configs
    from voxelengine_tpu_torch.engine import raytracer

    calls = []
    real = raytracer.trace_brickmap_hbm

    def spy(bm, lt, o, d, max_steps, use_macro=True):
        calls.append(use_macro)
        return real(bm, lt, o, d, max_steps, use_macro=use_macro)

    monkeypatch.setattr(raytracer, "trace_brickmap_hbm", spy)
    line = bench_configs.config5(size=64, edits=8, rays=16, reps=2, device=torch.device("cpu"))
    assert calls == [False] * 3 and line.startswith("edit 8 voxels + re-trace 16 rays"), (calls, line)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez(sys.argv[1], **_jax_reference(os.path.dirname(sys.argv[1]), sys.argv[2]))
