"""The port's copies of the presentation runtime (``voxelengine_tpu_torch/
runtime``): ``tests/test_runtime.py``'s cases run against them, and the
frames both sinks write (PPM and PNG, native and Python) are byte-equal to
the JAX package's sinks' on the same frame.  The JAX side runs once, in a
subprocess; the native library is built from ``native/`` into the port's
build directory when ``native/`` holds none that loads.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from voxelengine_tpu_torch.runtime import native
from voxelengine_tpu_torch.runtime.display import Renderer
from voxelengine_tpu_torch.runtime.input import ScriptedInput, best_input
from voxelengine_tpu_torch.utils.profiling import FrameTimer, TraceStats

ROOT = Path(__file__).resolve().parent.parent
MODE = 1 | 2 | 4 | 8  # numbered and live PPM and PNG
FILES = ("frame_000000.ppm", "latest.ppm", "frame_000000.png", "latest.png")


def _frame():
    return np.random.default_rng(3).integers(0, 256, (48, 64, 4), np.uint8)


def _write_frames(renderer_cls, outdir, force_python):
    r = renderer_cls("t")
    r.init(64, 48, outdir=str(outdir), mode=MODE, force_python_sink=force_python)
    r._pixels[:] = _frame()
    r.render()
    r.close()
    return {name: (Path(outdir) / name).read_bytes() for name in FILES}


def _jax_reference(out_dir):
    """JAX side (runs in the subprocess): the JAX package's sinks.  Its
    native library builds itself into ``native/`` when missing, and other
    processes may be building it at the same moment: wait until it loads."""
    import time

    from voxelengine_tpu.runtime import native as jnative
    from voxelengine_tpu.runtime.display import Renderer as JRenderer

    for _ in range(20):
        if jnative.framesink_lib() is not None:
            break
        jnative._loaded["framesink"] = False  # try the load again
        time.sleep(0.5)
    assert jnative.framesink_lib() is not None, "the JAX package's frame sink did not load"

    out = {}
    for force in (True, False):
        d = Path(out_dir) / f"jax_{int(force)}"
        for name, data in _write_frames(JRenderer, d, force).items():
            out[f"{int(force)}/{name}"] = np.frombuffer(data, np.uint8)
    return out


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ref")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(p for p in (str(ROOT), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.run([sys.executable, __file__, str(d / "runtime_ref.npz")], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(d / "runtime_ref.npz") as z:
        return {k: z[k] for k in z.files}


def _read_ppm(path):
    data = open(path, "rb").read()
    parts = data.split(b"\n", 3)
    w, h = map(int, parts[1].split())
    return np.frombuffer(parts[3], np.uint8).reshape(h, w, 3)


@pytest.mark.parametrize("force_python", [True, False])
def test_renderer_callback_loop(tmp_path, force_python):
    r = Renderer("test")
    assert r.init(8, 4, 1.0, outdir=str(tmp_path), mode=3, force_python_sink=force_python)
    frames = []

    def cb(data):
        assert data.width == 8 and data.height == 4
        data.pixels[...] = len(frames) * 10
        data.pixels[..., 3] = 255
        frames.append(1)

    r.add_render_event_callback(cb)
    for _ in range(3):
        r.render()
    r.close()
    assert len(frames) == 3
    assert r.frames_presented >= 1  # the native sink may coalesce
    img = _read_ppm(os.path.join(str(tmp_path), "latest.ppm"))
    assert img.shape == (4, 8, 3)
    assert len(np.unique(img)) == 1


def test_scripted_input_sequence():
    src = ScriptedInput([["w"], ["w", "a"], []])
    assert [e.key for e in src.poll()] == ["w"]
    assert [e.key for e in src.poll()] == ["w", "a"]
    assert [e.key for e in src.poll()] == []
    assert [e.key for e in src.poll()] == ["quit"]
    assert [e.key for e in best_input([["f"]]).poll()] == ["f"]


def test_frame_timer_ema():
    t = FrameTimer(alpha=0.5)
    t.tick()
    t.tick()
    assert t.ema_ms >= 0
    assert t.frames == 2


def test_trace_stats():
    s = TraceStats()
    s.record(1_000_000, 10.0, 5_000_000)
    assert np.isclose(s.mrays_per_s, 100.0)
    assert np.isclose(s.avg_steps, 5.0)


@pytest.mark.parametrize("force_python", [True, False])
def test_png_sink_roundtrip(tmp_path, force_python):
    PIL = pytest.importorskip("PIL.Image")
    bgra = _frame()
    r = Renderer("t")
    r.init(64, 48, outdir=str(tmp_path), mode=4 | 8, force_python_sink=force_python)
    r._pixels[:] = bgra
    r.render()
    r.close()
    assert r.frames_presented == 1
    img = np.asarray(PIL.open(tmp_path / "latest.png"))
    assert np.array_equal(img, bgra[..., [2, 1, 0]])
    assert (tmp_path / "frame_000000.png").exists()


@pytest.mark.parametrize("force_python", [True, False])
def test_sink_bytes_equal_jax_sinks(ref, tmp_path, force_python):
    """PPM and PNG bytes of the port's sinks == the JAX package's, native
    and Python, on the same frame."""
    got = _write_frames(Renderer, tmp_path, force_python)
    for name in FILES:
        np.testing.assert_array_equal(np.frombuffer(got[name], np.uint8), ref[f"{int(force_python)}/{name}"],
                                      err_msg=name)


def test_native_library_built_when_missing(tmp_path, monkeypatch):
    """With no loadable library in ``native/``, the sink is built from its
    sources into the build directory and loads."""
    import shutil

    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no make or g++ to build native/framesink.cpp")
    monkeypatch.setattr(native, "_BUILD_DIR", str(tmp_path / "build"))
    real = native._try_load
    monkeypatch.setattr(native, "_try_load", lambda p: None if p.startswith(native._NATIVE_DIR) else real(p))
    lib = native._load("libframesink.so")
    assert lib is not None and (tmp_path / "build" / "libframesink.so").exists()


def _tty_input(monkeypatch, slave):
    import sys as _sys

    class _Stdin:
        def fileno(self):
            return slave

        def isatty(self):
            return True

    monkeypatch.setattr(_sys, "stdin", _Stdin())
    from voxelengine_tpu_torch.runtime.input import TtyInput

    return TtyInput()


def test_tty_input_escape_sequences(monkeypatch):
    import os as _os
    import pty
    import time

    master, slave = pty.openpty()
    t = _tty_input(monkeypatch, slave)
    try:
        _os.write(master, b"w")
        _os.write(master, b"\x1b[A")
        _os.write(master, b"\x1b[5~")
        _os.write(master, b"\x1bf")
        time.sleep(0.05)
        evs = [e.key for e in t.poll()]
    finally:
        t.close()
        _os.close(master)
    assert evs == ["w", "up", "quit", "f"], evs


def test_tty_input_split_escape_sequence(monkeypatch):
    import os as _os
    import pty
    import threading

    master, slave = pty.openpty()
    t = _tty_input(monkeypatch, slave)
    try:
        _os.write(master, b"\x1b")
        lag = threading.Timer(0.01, _os.write, (master, b"[A"))
        lag.start()
        evs = [e.key for e in t.poll()]
        lag.join()
    finally:
        t.close()
        _os.close(master)
    assert evs == ["up"], evs


if __name__ == "__main__":
    np.savez(sys.argv[1], **_jax_reference(os.path.dirname(sys.argv[1])))
