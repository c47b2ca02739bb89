"""Build and load the port's hand-written kernels at first use.

Each library is compiled from ``voxelengine_tpu_torch/csrc`` into
``voxelengine_tpu_torch/kernels/_build/`` (ignored by git), named by a hash
of its source, every header in ``csrc`` and the flags, so any source change
rebuilds and an unchanged tree reuses the library.  Libraries have a plain
C interface and are loaded with ``ctypes``; nothing includes PyTorch's
headers, so a build takes seconds.  Nothing is built when this module is
imported.  The wrappers' shared argument checks live here too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

from voxelengine_tpu_torch.utils.profiling import span

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

# --fmad=false and no fast-math: every float op separately and IEEE rounded,
# as in the plain torch traces (csrc/bigtrace.cu, top note)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")

# library name -> source; each CUDA library holds the kernels of one source
KERNEL_SOURCES = {
    "bigtrace": "bigtrace.cu", "rrtrace": "rrtrace.cu", "gridtrace": "gridtrace.cu", "bmtrace": "bmtrace.cu",
    "terrain": "terrain.cu", "crossings": "crossings.cu", "zslab": "zslab.cu", "camera": "camera.cu",
    "rays": "rays.cu", "shade": "shade.cu", "secondary": "secondary.cu",
}
# host library name -> source (g++): the kernels' per-ray and per-voxel logic
HOST_SOURCES = {"dda_host": "dda_host.cpp", "terrain_host": "terrain_host.cpp", "camera_host": "camera_host.cpp",
                "shade_host": "shade_host.cpp"}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_RAYS = [_P] * 4  # start, dir, active, pad
_OUTS = [_P] * 4  # flags (or hit), pos, normal, steps
_ORIGIN_RAYS = [_P, _I, _P, _I]  # origins, its row stride, raw directions, its row stride
_RECORD_OUTS = [_P] * 6  # valid (uint8), hit_point, normal, distance, voxel_index, steps
# C signatures, stream excluded (the host builds take none)
_LINE_TABLE = [_P] * 4  # region_lines, brick_lines, macro, macro2
# n, gx, gy, gz, rx, ry, rz, factor, wpb, max_steps, brick_layout, iter_limit, use_macro
_LINE_TABLE_INTS = [_I] * 13
_SHADE = [_P] * 5 + [_I, _P, _I] + [_P] * 13 + [_I] * 4 + [_F] * 3 + [_I]
# kind; pos, nrm, dirs, its row stride; px, py, light; width, seed_frame,
# ao_samples (csrc/secondary.cuh::VX_SECONDARY_PARAMS)
_SECONDARY = [_I, _P, _P, _P, _I, _P, _P, _P, _I, _I, _I]
_SECONDARY_OUTS = [_P] * 5  # hit, position, normal, steps, ao (null where the kind writes none)
# the secondary entries' kinds, by their `kind` argument (secondary.cuh::SecondaryKind)
SECONDARY_KINDS = ("shadow", "reflection", "ao")
SIGNATURES = {
    # ... outputs, diag (null, or int32[11, n])
    "vx_bigtrace": _RAYS + _LINE_TABLE + _LINE_TABLE_INTS + _OUTS + [_P],
    # the same from origins and raw directions; hit (uint8) in place of flags
    "vx_bigtrace_rays": _ORIGIN_RAYS + _LINE_TABLE + _LINE_TABLE_INTS + _OUTS + [_P],
    # the same, macro off, no diag: the ray API's result record
    "vx_bigtrace_record": _ORIGIN_RAYS + _LINE_TABLE + _LINE_TABLE_INTS[:-1] + _RECORD_OUTS,
    # a kind of secondary rays built from the primary trace; the kind's outputs
    "vx_bigtrace_secondary": _SECONDARY + _LINE_TABLE + _LINE_TABLE_INTS + _SECONDARY_OUTS,
    # ... max_rows, rows, nrows, outputs (the record instantiation of K1's loop)
    "vx_trace_crossings": _RAYS + _LINE_TABLE + _LINE_TABLE_INTS + [_I, _P, _P] + _OUTS,
    # ... refill, counter (int32 scratch), stats (null, or uint64[2]), outputs
    "vx_rrtrace": _RAYS + _LINE_TABLE + _LINE_TABLE_INTS + [_I, _P, _P] + _OUTS,
    # origins, its row stride, rays, its row stride, words; n, X, Y, Z,
    # layout, max_steps; hit (uint8), ...
    "vx_trace_grid": [_P, _I, _P, _I, _P] + [_I] * 6 + _OUTS,
    # ... limbs, plane in place of words; staged, words16, counter (int32 scratch)
    "vx_trace_grid_limbs": [_P, _I, _P, _I, _P, _L] + [_I] * 6 + [_I, _I, _P] + _OUTS,
    # meta, bricks; n, gx, gy, gz, factor, wpb, max_steps, coarse_layout,
    # brick_layout, iter_limit, shared_meta; counter (int32 scratch), outputs
    "vx_trace_brickmap_dense": _RAYS + [_P] * 2 + [_I] * 11 + [_P] + _OUTS,
    # ... meta, brick_idx, bricks; then as vx_trace_brickmap_dense
    "vx_trace_brickmap_compact": _RAYS + [_P] * 3 + [_I] * 11 + [_P] + _OUTS,
    # both from origins and raw directions; hit (uint8) in place of flags
    "vx_trace_brickmap_dense_rays": _ORIGIN_RAYS + [_P] * 2 + [_I] * 11 + [_P] + _OUTS,
    "vx_trace_brickmap_compact_rays": _ORIGIN_RAYS + [_P] * 3 + [_I] * 11 + [_P] + _OUTS,
    # both storing the ray API's result record, as vx_bigtrace_record
    "vx_trace_brickmap_dense_record": _ORIGIN_RAYS + [_P] * 2 + [_I] * 11 + [_P] + _RECORD_OUTS,
    "vx_trace_brickmap_compact_record": _ORIGIN_RAYS + [_P] * 3 + [_I] * 11 + [_P] + _RECORD_OUTS,
    # both from the primary trace, as vx_bigtrace_secondary
    "vx_trace_brickmap_dense_secondary": _SECONDARY + [_P] * 2 + [_I] * 11 + [_P] + _SECONDARY_OUTS,
    "vx_trace_brickmap_compact_secondary": _SECONDARY + [_P] * 3 + [_I] * 11 + [_P] + _SECONDARY_OUTS,
    # rays (round 0) or null, rows_in (later rounds) or null, meta, bricks;
    # m, gx, gy, gz, z0, slab_gz, factor, wpb, max_steps, brick_layout,
    # iter_limit; counter (int32 scratch), rows_out, status, outputs (K4-slab)
    "vx_zslab": _RAYS + [_P] * 3 + [_I] * 11 + [_P] * 3 + _OUTS,
    # K4-slab's batch form: the batch's origins and directions; rows_in,
    # idx_in (null in round 0), meta, bricks; the ints as vx_zslab's;
    # counters (int32[3] scratch), rows_out, idx_out, hit (int32), ...
    "vx_zslab_rays": _ORIGIN_RAYS + [_P] * 4 + [_I] * 11 + [_P] * 3 + _OUTS,
    # K5 from origins and raw directions; hit (uint8) in place of flags, no stats
    "vx_rrtrace_rays": _ORIGIN_RAYS + _LINE_TABLE + _LINE_TABLE_INTS + [_I, _P] + _OUTS,
    # secondary.cu: a kind's rays for a caller's tracer (origins, dirs out),
    # and the reduce of its results (the kind, the primary position,
    # ao_samples, n; the tracer's hit, position, normal, steps; the kind's
    # outputs)
    "vx_secondary_build": _SECONDARY + [_I, _P, _P],
    # pos, ao_samples, n, trace hit, trace position, ao (AO only)
    "vx_secondary_reduce": [_P, _I, _I, _P, _P, _P],
    # z0, factor, chunks_x, chunks_y, wpb, brick_layout, octaves; occ
    # (uint8), bmin, bmax, words
    "vx_terrain_slab": [_I] * 7 + [_P] * 4,
    # kind, n, in, scale, seed, octaves, lacunarity, decay, fout, uout
    "vx_noise_points": [_I, _I, _P, _F, _I, _I, _F, _F, _P, _P],
    # euler (f32[n, 3]), n, out (f32[n, 9]: -forward, -up, right)
    "vx_camera_basis": [_P, _I, _P],
    # euler, origin, window (null or f32[2]), block_perm (null or int64);
    # n, W, H, bw, bh, checkerboard, even_frame, ortho; a, b (scale_x and
    # scale_y, or the orthographic window); basis (null or f32[9]), rows
    # (f32[n, 3]), px, py, py_r (int64[n])
    "vx_rays_frame": [_P] * 4 + [_I] * 8 + [_F] * 2 + [_P] * 5,
    # euler, origin, window, px, py_r; n, W, H, checkerboard, even_frame,
    # ortho; a, b; basis, rows, py
    "vx_rays_pixels": [_P] * 5 + [_I] * 6 + [_F] * 2 + [_P] * 3,
    # hit, pos, nrm, steps, origins, its row stride, dirs, its row stride,
    # px, py, py_r, cam, light_dir, light_color, ambient, shadow_hit,
    # shadow_steps, refl_hit, refl_pos, refl_nrm, ao (each null where not
    # traced); width, height, view, crosshair; reflectivity,
    # pos_mod, mod_m; n; color, write
    "vx_shade": _SHADE + [_P] * 2,
    # ...; where the framebuffer lies in the image (tw, th, tiles_x, ranks,
    # rank: csrc/shade.cuh::FrameDest); the framebuffer
    "vx_shade_composite": _SHADE + [_I] * 5 + [_P],
}
# host-build entry -> its C signature: the kernel launcher's it mirrors,
# except K4's two, which have no instantiation flag and no work counter; and the
# grid walk alone on prepared rays (vx_trace_grid_host, *_limbs_host)
HOST_ENTRIES = {
    "vx_trace_host": SIGNATURES["vx_bigtrace"],
    "vx_rrtrace_host": SIGNATURES["vx_rrtrace"],
    "vx_trace_crossings_host": SIGNATURES["vx_trace_crossings"],
    "vx_trace_grid_full_host": SIGNATURES["vx_trace_grid"],
    "vx_trace_grid_limbs_full_host": SIGNATURES["vx_trace_grid_limbs"],
    "vx_trace_brickmap_dense_host": _RAYS + [_P] * 2 + [_I] * 10 + _OUTS,
    "vx_trace_brickmap_compact_host": _RAYS + [_P] * 3 + [_I] * 10 + _OUTS,
    "vx_bigtrace_rays_host": SIGNATURES["vx_bigtrace_rays"],
    "vx_trace_brickmap_dense_rays_host": _ORIGIN_RAYS + [_P] * 2 + [_I] * 10 + _OUTS,
    "vx_trace_brickmap_compact_rays_host": _ORIGIN_RAYS + [_P] * 3 + [_I] * 10 + _OUTS,
    "vx_bigtrace_record_host": SIGNATURES["vx_bigtrace_record"],
    "vx_trace_brickmap_dense_record_host": _ORIGIN_RAYS + [_P] * 2 + [_I] * 10 + _RECORD_OUTS,
    "vx_trace_brickmap_compact_record_host": _ORIGIN_RAYS + [_P] * 3 + [_I] * 10 + _RECORD_OUTS,
    "vx_bigtrace_secondary_host": SIGNATURES["vx_bigtrace_secondary"],
    "vx_trace_brickmap_dense_secondary_host": _SECONDARY + [_P] * 2 + [_I] * 10 + _SECONDARY_OUTS,
    "vx_trace_brickmap_compact_secondary_host": _SECONDARY + [_P] * 3 + [_I] * 10 + _SECONDARY_OUTS,
    "vx_trace_grid_host": _RAYS + [_P] + [_I] * 6 + _OUTS,
    "vx_trace_grid_limbs_host": _RAYS + [_P, _L] + [_I] * 6 + _OUTS,
    # limbs, plane, words16, out: K3's staging alone
    "vx_limb_words_host": [_P, _L, _I, _P],
    "vx_zslab_host": SIGNATURES["vx_zslab"],
    "vx_zslab_rays_host": SIGNATURES["vx_zslab_rays"],
    "vx_rrtrace_rays_host": SIGNATURES["vx_rrtrace_rays"],
    "vx_secondary_build_host": SIGNATURES["vx_secondary_build"],
    "vx_secondary_reduce_host": SIGNATURES["vx_secondary_reduce"],
    "vx_terrain_slab_host": SIGNATURES["vx_terrain_slab"],
    "vx_noise_points_host": SIGNATURES["vx_noise_points"],
    "vx_camera_basis_host": SIGNATURES["vx_camera_basis"],
    "vx_rays_frame_host": SIGNATURES["vx_rays_frame"],
    "vx_rays_pixels_host": SIGNATURES["vx_rays_pixels"],
    "vx_shade_host": SIGNATURES["vx_shade"],
    "vx_shade_composite_host": SIGNATURES["vx_shade_composite"],
    # x, n, sin, cos: glibc_sincosf alone
    "vx_sincosf_host": [_P, _I, _P, _P],
}


def _build(name: str, compiler: str, flags, source: Path) -> Path:
    """Compile ``source`` into a shared library unless the hashed one exists."""
    h = hashlib.sha256(" ".join([Path(compiler).name, *flags]).encode())
    for dep in (source, *sorted(CSRC.glob("*.cuh"))):
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


def kernel_library(name: str) -> Path:
    """Build (if needed) the Hopper library ``name`` of :data:`KERNEL_SOURCES`."""
    return _build(name, _nvcc(), NVCC_FLAGS, CSRC / KERNEL_SOURCES[name])


def host_library(name: str = "dda_host") -> Path:
    """Build (if needed) the host C++ library ``name`` of :data:`HOST_SOURCES`."""
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) found")
    return _build(name, cxx, HOST_FLAGS, CSRC / HOST_SOURCES[name])


def _declare(lib: ctypes.CDLL, fn: str, argtypes) -> None:
    f = getattr(lib, fn)
    f.argtypes = argtypes
    f.restype = ctypes.c_int


@functools.cache
def load_kernel(name: str) -> ctypes.CDLL:
    """The Hopper library ``name`` with its launchers' signatures declared
    (each takes the stream last)."""
    lib = ctypes.CDLL(str(kernel_library(name)))
    for fn, args in SIGNATURES.items():
        if hasattr(lib, fn):
            _declare(lib, fn, args + [_P])
    return lib


@functools.cache
def load_host(name: str = "dda_host") -> ctypes.CDLL:
    """The host library ``name`` with its entries' signatures declared."""
    lib = ctypes.CDLL(str(host_library(name)))
    for fn, args in HOST_ENTRIES.items():
        if hasattr(lib, fn):
            _declare(lib, fn, args)
    return lib


def load_dda_host() -> ctypes.CDLL:
    """The host build of the traversal kernels' step logic."""
    return load_host("dda_host")


def check(kernel: str, name: str, t: torch.Tensor, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor on ``device`` of
    ``shape`` (``None`` entries match any size)."""
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be a contiguous {dtype} tensor on {device}, "
            f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if t.dim() != len(shape) or any(want is not None and got != want for got, want in zip(t.shape, shape)):
        raise ValueError(f"{kernel}: {name} must have shape {shape}, got {tuple(t.shape)}")


def require_cuda(kernel: str, dev: torch.device) -> None:
    """Raise unless ``dev`` is a CUDA device: a kernel never runs on the CPU."""
    if dev.type != "cuda":
        raise ValueError(f"{kernel}: tensors must be on a CUDA device, got {dev}")


def check_rays(kernel: str, start, d, active, pad) -> torch.device:
    """Check a kernel's ray inputs (start and direction ``f32[N, 3]``,
    ``active`` ``i32[N]``, edge pad ``i32[N, 3]``, all on one CUDA
    device); returns that device."""
    dev = start.device
    require_cuda(kernel, dev)
    n = start.shape[0]
    check(kernel, "start", start, torch.float32, (n, 3), dev)
    check(kernel, "d", d, torch.float32, (n, 3), dev)
    check(kernel, "active", active, torch.int32, (n,), dev)
    check(kernel, "pad", pad, torch.int32, (n, 3), dev)
    return dev


def ray_rows(kernel: str, name: str, t: torch.Tensor, n: int, device) -> tuple:
    """``(t, row stride)`` of an ``f32[n, 3]`` tensor of rays on ``device``
    whose rows are 3 contiguous floats; a row stride of 0 (one origin
    broadcast to every ray, as ``primary_rays`` makes them) is taken as it
    is, any other layout is copied to a contiguous tensor."""
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != (n, 3):
        raise ValueError(f"{kernel}: {name} must be a float32 [{n}, 3] tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if t.stride(1) != 1 or t.stride(0) not in (0, 3):
        t = t.contiguous()
    return t, t.stride(0)


def ray_outputs(n: int, dev, hit_dtype=torch.int32):
    """Empty ``(flags i32[N] (or hit of ``hit_dtype``), position f32[N, 3],
    normal f32[N, 3], steps i32[N])``."""
    return (
        torch.empty((n,), dtype=hit_dtype, device=dev),
        torch.empty((n, 3), dtype=torch.float32, device=dev),
        torch.empty((n, 3), dtype=torch.float32, device=dev),
        torch.empty((n,), dtype=torch.int32, device=dev),
    )


def record_outputs(n: int, dev):
    """Empty ``(valid bool[N], hit_point f32[N, 3], normal f32[N, 3],
    distance f32[N], voxel_index i32[N], steps i32[N])``: the ray API's
    result record (``engine/raytracer.py::RayTraceResults``), as the record
    entries write it."""
    return (
        torch.empty((n,), dtype=torch.bool, device=dev),
        torch.empty((n, 3), dtype=torch.float32, device=dev),
        torch.empty((n, 3), dtype=torch.float32, device=dev),
        torch.empty((n,), dtype=torch.float32, device=dev),
        torch.empty((n,), dtype=torch.int32, device=dev),
        torch.empty((n,), dtype=torch.int32, device=dev),
    )


def pointers(args) -> list:
    """A launcher's arguments with each tensor as its data pointer."""
    return [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]


def secondary_inputs(kernel: str, kind: str, position, normal, *, light=None, dirs=None, px=None, py=None,
                     width: int = 0, frame_number: int = 0, ao_samples: int = 0):
    """Check a secondary entry's inputs (``csrc/secondary.cuh``):
    ``kind`` is one of :data:`SECONDARY_KINDS`; ``position`` and
    ``normal`` are the primary trace's (``f32[N, 3]``, contiguous, on one
    CUDA device); the shadow kind reads ``light`` (``f32[3]``), the
    reflection kind ``dirs`` (the rays' raw directions, ``f32[N, 3]`` rows
    or one broadcast row), the AO kind ``px``, ``py`` (``int64[N]``),
    ``width``, ``frame_number`` and ``ao_samples`` (>= 1).  Returns
    ``(device, N, the launcher's arguments before the tables (tensors
    among them))``: ``VX_SECONDARY_PARAMS``."""
    if kind not in SECONDARY_KINDS:
        raise ValueError(f"{kernel}: kind must be one of {SECONDARY_KINDS}, got {kind!r}")
    dev = position.device
    require_cuda(kernel, dev)
    n = position.shape[0]
    check(kernel, "position", position, torch.float32, (n, 3), dev)
    check(kernel, "normal", normal, torch.float32, (n, 3), dev)
    d, ds = None, 0
    if kind == "shadow":
        check(kernel, "light", light, torch.float32, (3,), dev)
    elif kind == "reflection":
        d, ds = ray_rows(kernel, "dirs", dirs, n, dev)
    else:
        check(kernel, "px", px, torch.int64, (n,), dev)
        check(kernel, "py", py, torch.int64, (n,), dev)
        if ao_samples < 1:
            raise ValueError(f"{kernel}: the AO kind needs ao_samples >= 1, got {ao_samples}")
    seed_frame = ((frame_number + 1) * 7919) & 0xFFFFFFFF  # wraps as the plain version's int32 seed
    head = (SECONDARY_KINDS.index(kind), position, normal, d, ds, px if kind == "ao" else None,
            py if kind == "ao" else None, light if kind == "shadow" else None, width,
            seed_frame - (1 << 32) if seed_frame >= 1 << 31 else seed_frame, ao_samples)
    return dev, n, head


def secondary_outputs(kind: str, n: int, dev):
    """A secondary entry's five outputs (``VX_SECONDARY_OUTS``: tensors,
    None where the kind writes none) and the kind's results they make:
    shadow ``(hit bool[N], steps i32[N])``, reflection ``(hit, position
    f32[N, 3], normal f32[N, 3])``, AO the factor ``f32[N]``."""
    hit = torch.empty((n,), dtype=torch.bool, device=dev) if kind != "ao" else None
    if kind == "shadow":
        outs = [hit, None, None, torch.empty((n,), dtype=torch.int32, device=dev), None]
        return outs, (hit, outs[3])
    if kind == "reflection":
        outs = [hit, torch.empty((n, 3), dtype=torch.float32, device=dev),
                torch.empty((n, 3), dtype=torch.float32, device=dev), None, None]
        return outs, (hit, outs[1], outs[2])
    outs = [None] * 4 + [torch.empty((n,), dtype=torch.float32, device=dev)]
    return outs, outs[4]


def secondary_args(kernel: str, kind: str, position, normal, **inputs):
    """:func:`secondary_inputs` and :func:`secondary_outputs` together:
    ``(device, N, the launcher's arguments before the tables, its five
    outputs, the kind's results)``."""
    dev, n, head = secondary_inputs(kernel, kind, position, normal, **inputs)
    outs, res = secondary_outputs(kind, n, dev)
    return dev, n, head, outs, res


def launch(kernel: str, fn, *args, dev) -> None:
    """Call the launcher ``fn(*args, stream)`` on ``dev``'s current stream;
    raise if the launch was refused (its ``cudaGetLastError``).  Under
    ``torch.profiler`` each call is a ``launch`` span naming ``fn``'s entry
    (``utils/profiling.py::span``)."""
    with span("launch", detail=fn.__name__), torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel}: kernel launch failed with cudaError {err}")
