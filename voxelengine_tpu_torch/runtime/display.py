"""Presentation runtime, the SDLRenderer equivalent: the PyTorch port's copy
of ``voxelengine_tpu/runtime/display.py`` (numpy and ctypes; the JAX
package's cannot be imported without JAX).

Mirrors the reference's presentation API surface (``SDLRenderer.h:13-39``):
``Renderer(title).init(w, h, scale)``, ``add_render_event_callback``,
``render()`` per frame, ``close()`` — but instead of an SDL window +
streaming texture, frames flow to the native asynchronous frame sink
(``native/framesink.cpp``), which double-buffers and encodes PPM captures /
a live-preview file off the render thread.  A pure-Python sink keeps
everything working without the native lib.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
from typing import Callable, List, Optional

import numpy as np

from voxelengine_tpu_torch.runtime.native import framesink_lib


@dataclasses.dataclass
class CallbackData:
    """Per-frame callback payload (``SDLRenderer.h:23-31``): the renderer,
    frame dims, and the pixel staging buffer the callback fills (BGRA8)."""

    renderer: "Renderer"
    width: int
    height: int
    pixels: np.ndarray  # uint8 [H, W, 4] BGRA
    present: bool = True  # callbacks may clear: skip this cycle's sink submit
    # (the "don't present a stale staging buffer" analog of skipping
    # SDL_RenderPresent)


def _encode_png(rgb: np.ndarray) -> bytes:
    """RGB uint8 [H, W, 3] -> PNG bytes (stdlib zlib; no imaging deps)."""
    import struct
    import zlib

    h, w = rgb.shape[:2]

    def chunk(typ, data):
        return (
            struct.pack(">I", len(data)) + typ + data
            + struct.pack(">I", zlib.crc32(typ + data) & 0xFFFFFFFF)
        )

    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
    ).tobytes()
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + chunk(b"IDAT", zlib.compress(raw, 6))
        + chunk(b"IEND", b"")
    )


class _PySink:
    """Fallback synchronous PPM/PNG writer."""

    def __init__(self, width, height, mode, outdir):
        self.w, self.h, self.mode, self.dir = width, height, mode, outdir
        self.frames_written = 0

    def _atomic(self, name, data):
        tmp = os.path.join(self.dir, name + ".tmp")
        with open(tmp, "wb") as f:
            f.write(data)
        os.replace(tmp, os.path.join(self.dir, name))

    def submit(self, bgra: np.ndarray):
        rgb = bgra[..., [2, 1, 0]]
        header = f"P6\n{self.w} {self.h}\n255\n".encode()
        n = self.frames_written
        if self.mode & 1:
            self._atomic(f"frame_{n:06d}.ppm", header + rgb.tobytes())
        if self.mode & 2:
            self._atomic("latest.ppm", header + rgb.tobytes())
        if self.mode & 4:
            self._atomic(f"frame_{n:06d}.png", _encode_png(rgb))
        if self.mode & 8:
            self._atomic("latest.png", _encode_png(rgb))
        self.frames_written += 1

    def close(self):
        return self.frames_written


class _NativeSink:
    def __init__(self, lib, width, height, mode, outdir):
        self._lib = lib
        self._h = lib.fs_init(width, height, mode, outdir.encode())
        if self._h < 0:
            raise RuntimeError("framesink init failed")

    def submit(self, bgra: np.ndarray):
        buf = np.ascontiguousarray(bgra)
        self._lib.fs_submit(self._h, buf.ctypes.data_as(ctypes.c_char_p))

    @property
    def frames_written(self):
        return self._lib.fs_frames_written(self._h)

    def close(self):
        return int(self._lib.fs_close(self._h))


class Renderer:
    """Window-loop equivalent (``SDLRenderer.h:13-39``)."""

    def __init__(self, title: str = "voxelengine_tpu_torch"):
        self.title = title
        self._callbacks: List[Callable[[CallbackData], None]] = []
        self._sink = None
        self._open = False
        self.width = 0
        self.height = 0
        self._pixels: Optional[np.ndarray] = None
        self._final_count = 0

    def init(
        self,
        width: int,
        height: int,
        scale: float = 1.0,
        outdir: str = "frames",
        mode: int = 2,
        force_python_sink: bool = False,
    ) -> bool:
        """Create the output surface (``SDLRenderer.cpp:12-46``).  ``scale``
        is accepted for API parity (nearest-neighbour upscaling is the
        viewer's job here).  ``mode`` bitmask: 1 = numbered PPM sequence,
        2 = live latest.ppm, 4 = numbered PNG sequence, 8 = live
        latest.png (PNGs via the dependency-free native encoder)."""
        self.width, self.height = int(width), int(height)
        os.makedirs(outdir, exist_ok=True)
        lib = None if force_python_sink else framesink_lib()
        if lib is not None:
            self._sink = _NativeSink(lib, self.width, self.height, mode, outdir)
        else:
            self._sink = _PySink(self.width, self.height, mode, outdir)
        self._pixels = np.zeros((self.height, self.width, 4), np.uint8)
        self._open = True
        return True

    def add_render_event_callback(self, cb: Callable[[CallbackData], None]) -> None:
        """Register a per-frame fill callback (``SDLRenderer.h:33``)."""
        self._callbacks.append(cb)

    def render(self) -> None:
        """One presentation cycle (``SDLRenderer.cpp:48-68``): invoke the
        callbacks with the staging buffer, then hand the frame to the
        asynchronous sink (the lock/unlock-texture + present analog)."""
        if not self._open:
            return
        data = CallbackData(self, self.width, self.height, self._pixels)
        for cb in self._callbacks:
            cb(data)
        if data.present:
            self._sink.submit(self._pixels)

    @property
    def frames_presented(self) -> int:
        if not self._open:
            return self._final_count
        return int(self._sink.frames_written) if self._sink else 0

    def is_open(self) -> bool:
        return self._open

    def close(self) -> None:
        if self._open and self._sink:
            final = self._sink.close()
            self._final_count = (
                int(final) if final is not None else int(self._sink.frames_written)
            )
        self._open = False
