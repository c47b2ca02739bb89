"""ctypes bindings for the native (C++) runtime components: the PyTorch port's
copy of ``voxelengine_tpu/runtime/native.py``.

Loads ``libframesink.so`` and ``libbitops.so`` from the repository's
``native/`` directory.  Where a library is missing there, or does not load
(a build for another machine), it is built with ``native/Makefile`` into
this package's build directory (``kernels/_build/native``, ignored by git),
the sources read where they are.  Every native feature has a pure-Python
fallback, so the runtime works on hosts without a toolchain; the fallback
presents frames, as the native sink does, and reads nothing from the card.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from typing import Optional

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))), "native")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "kernels", "_build", "native")


def _try_load(path: str) -> Optional[ctypes.CDLL]:
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _load(name: str) -> Optional[ctypes.CDLL]:
    """``native/<name>`` if it loads, else the one built from ``native/``'s
    sources into the build directory (built here when missing)."""
    lib = _try_load(os.path.join(_NATIVE_DIR, name))
    if lib is not None:
        return lib
    built = os.path.join(_BUILD_DIR, name)
    if not os.path.exists(built):
        try:
            os.makedirs(_BUILD_DIR, exist_ok=True)
            with tempfile.TemporaryDirectory(dir=_BUILD_DIR) as tmp:
                subprocess.run(
                    ["make", "-s", "-B", "-f", os.path.join(_NATIVE_DIR, "Makefile"), f"VPATH={_NATIVE_DIR}", name],
                    cwd=tmp, check=True, capture_output=True,
                )
                # atomic: a concurrent build never loads a partial file
                os.replace(os.path.join(tmp, name), built)
        except (OSError, subprocess.CalledProcessError):
            return None
    return _try_load(built)


_framesink: Optional[ctypes.CDLL] = None
_bitops: Optional[ctypes.CDLL] = None
_loaded = {"framesink": False, "bitops": False}


def framesink_lib() -> Optional[ctypes.CDLL]:
    global _framesink
    if not _loaded["framesink"]:
        _loaded["framesink"] = True
        lib = _load("libframesink.so")
        if lib is not None:
            lib.fs_init.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_char_p]
            lib.fs_init.restype = ctypes.c_int
            lib.fs_submit.argtypes = [ctypes.c_int, ctypes.c_char_p]
            lib.fs_submit.restype = ctypes.c_int
            lib.fs_frames_written.argtypes = [ctypes.c_int]
            lib.fs_frames_written.restype = ctypes.c_long
            lib.fs_close.argtypes = [ctypes.c_int]
            lib.fs_close.restype = ctypes.c_long
        _framesink = lib
    return _framesink


def bitops_lib() -> Optional[ctypes.CDLL]:
    global _bitops
    if not _loaded["bitops"]:
        _loaded["bitops"] = True
        lib = _load("libbitops.so")
        if lib is not None:
            u8p = ctypes.POINTER(ctypes.c_uint8)
            u32p = ctypes.POINTER(ctypes.c_uint32)
            i32p = ctypes.POINTER(ctypes.c_int32)
            lib.bit_pack.argtypes = [u8p, ctypes.c_uint64, u32p]
            lib.bit_unpack.argtypes = [u32p, ctypes.c_uint64, u8p]
            lib.bit_popcount.argtypes = [u32p, ctypes.c_uint64]
            lib.bit_popcount.restype = ctypes.c_uint64
            lib.build_brickmap_host.argtypes = [
                u32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int, i32p, u32p, ctypes.c_int,
            ]
        _bitops = lib
    return _bitops
