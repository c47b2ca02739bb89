"""Build and load the port's hand-written kernels at first use.

Each library is compiled from ``voxelengine_tpu_torch/csrc`` into
``voxelengine_tpu_torch/kernels/_build/`` (ignored by git), named by a hash
of its sources and flags, so a source change rebuilds and an unchanged
tree reuses the library.  Libraries have a plain C interface and are loaded
with ``ctypes``; nothing includes PyTorch's headers, so a build takes
seconds.  Nothing is built when this module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# --fmad=false and no fast-math: every float op separately and IEEE rounded,
# as in the plain torch trace (csrc/bigtrace.cu, top note)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# start, dir, active, pad, region_lines, brick_lines; n, grid xyz, region
# xyz, factor, wpb, max_steps, brick_layout, iter_limit; flags, pos,
# normal, steps
_TRACE_ARGS = [_P] * 6 + [_I] * 12 + [_P] * 4


def _build(name: str, compiler: str, flags, source: Path) -> Path:
    """Compile ``source`` into a shared library unless the hashed one exists."""
    h = hashlib.sha256(" ".join([Path(compiler).name, *flags]).encode())
    for dep in (source, CSRC / "dda.cuh"):
        h.update(dep.name.encode())
        h.update(dep.read_bytes())
    out = BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler, *flags, "-I", str(CSRC), "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    out.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"building {name} failed:\n{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never loads a partial file
    return out


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")
    return nvcc


def bigtrace_library() -> Path:
    """Build (if needed) the Hopper traversal kernel; returns its path."""
    return _build("bigtrace", _nvcc(), NVCC_FLAGS, CSRC / "bigtrace.cu")


def dda_host_library() -> Path:
    """Build (if needed) the host C++ build of ``dda.cuh``; returns its path."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    return _build("dda_host", cxx, HOST_FLAGS, CSRC / "dda_host.cpp")


@functools.cache
def load_bigtrace() -> ctypes.CDLL:
    """The kernel library with ``vx_bigtrace``'s signature declared."""
    lib = ctypes.CDLL(str(bigtrace_library()))
    lib.vx_bigtrace.argtypes = _TRACE_ARGS + [_P]  # + stream
    lib.vx_bigtrace.restype = ctypes.c_int
    return lib


@functools.cache
def load_dda_host() -> ctypes.CDLL:
    """The host library with ``vx_trace_host``'s signature declared."""
    lib = ctypes.CDLL(str(dda_host_library()))
    lib.vx_trace_host.argtypes = _TRACE_ARGS
    lib.vx_trace_host.restype = ctypes.c_int
    return lib
