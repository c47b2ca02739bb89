"""Engine object and batch ray queries: counterpart of
``voxelengine_tpu/engine/raytracer.py``.

``VoxelRaytracer3D`` mirrors ``GPUDDA::VoxelRaytracer3D``
(``VolumeRaytracer.cuh:291-377``): upload a brickmap world once, fire ray
batches through :meth:`VoxelRaytracer3D.raytrace` and get the
``RayTraceResults`` record (``VolumeRaytracer.cu:574-618``), and edit
voxels in place.

Where the rays go on the card: with a line table (built by
:meth:`~VoxelRaytracer3D.upload_world` for LINEAR worlds, as in JAX), K1 with
the macro levels off, which computes ``trace_brickmap``'s function, the one
the JAX facade traces; without one, K4 for a dense-slot world, and a
compact world is refused.  On the CPU the plain walk.  Edits go through
:func:`~voxelengine_tpu_torch.ops.bigtrace.apply_edits_hbm` where there is a
line table, else :func:`~voxelengine_tpu_torch.core.brickmap.apply_edits`.

The port has no fused table: the JAX facade's ``make_fused_table``,
``apply_edits_fused``, ``update_fused_words`` and ``fused_table`` work
around XLA's gathers on the TPU, and no traversal here reads such a table.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import torch

from voxelengine_tpu_torch.config import MAX_STEPS
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import BrickMap, apply_edits, build_brickmap
from voxelengine_tpu_torch.core.exact import dot3, sqrt_rn
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.ops.bigtrace import (
    LineTable,
    apply_edits_hbm,
    make_line_table,
    materialize_brick_lines,
    trace_brickmap_hbm,
)
from voxelengine_tpu_torch.ops.trace import TraceOut
from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_no_table

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class RayTraceResults:
    """Struct-of-tensors result record (``VolumeRaytracer.cuh:179-202``)."""

    valid: torch.Tensor  # bool[N]
    hit_point: torch.Tensor  # f32[N,3]; (inf, inf, inf) on a miss (VolumeRaytracer.cu:112)
    normal: torch.Tensor  # f32[N,3]
    distance: torch.Tensor  # f32[N]
    voxel_index: torch.Tensor  # i32[N], linear x-fastest index of the hit voxel
    steps: torch.Tensor  # i32[N]


def _batch_trace(bm: BrickMap, origins, rays, max_steps: int, lt: Optional[LineTable] = None) -> RayTraceResults:
    """Trace (K1 with the macro levels off through ``lt``, else
    ``trace_brickmap_no_table``) and derive the result record."""
    if lt is not None:
        out = trace_brickmap_hbm(bm, lt, origins, rays, max_steps, use_macro=False)
    else:
        out = trace_brickmap_no_table(bm, origins, rays, max_steps)
    return results_from_trace(bm, origins, out)


def results_from_trace(bm: BrickMap, origins: torch.Tensor, out: TraceOut) -> RayTraceResults:
    """The result record of a trace of ``origins``.  ``voxel_index`` is the
    JAX package's deliberate fix of the reference's post-pass
    (``VolumeRaytracer.cu:611-612``, ``PARITY.md``): the hit point lies on
    the entry face and the normal points into the hit voxel, so a
    half-voxel nudge along it, then ``floor``, names the voxel; the
    multiply-accumulate wraps as int32 arithmetic does."""
    X, Y, _ = bm.world_dims
    hit_point = torch.where(out.hit[:, None], out.position, float("inf"))
    diff = origins - out.position
    distance = torch.where(out.hit, sqrt_rn(dot3(diff, diff)), 0.0)
    pi = torch.floor(out.position + 0.5 * out.normal).to(torch.int32).long()
    lin = (pi[:, 2] * (X * Y) + pi[:, 1] * X + pi[:, 0]) & 0xFFFFFFFF
    lin = torch.where(lin >= 2**31, lin - 2**32, lin)
    voxel_index = torch.where(out.hit, lin, 0).to(torch.int32)
    return RayTraceResults(
        valid=out.hit, hit_point=hit_point, normal=out.normal, distance=distance,
        voxel_index=voxel_index, steps=out.steps,
    )


class VoxelRaytracer3D:
    """Engine facade: world upload, batch ray queries and edits
    (``VolumeRaytracer.cuh:291-377``'s surface, plus ``edit_voxels`` and
    ``upload_world``).  The world stays on the device it was built on."""

    def __init__(self, verbose_timing: bool = False, line_table: bool = True):
        self._bm: Optional[BrickMap] = None
        self._lt: Optional[LineTable] = None
        self._want_lt = line_table
        self._factor = 1
        self._verbose = verbose_timing
        self.last_kernel_ms: float = 0.0

    # -- upload ------------------------------------------------------------

    def upload_world(self, bm: BrickMap) -> None:
        """Take a built brickmap; with ``line_table`` and a LINEAR coarse
        layout, build its line table and attach its brick lines."""
        self._bm = bm
        self._factor = bm.factor
        self._lt = None
        if self._want_lt and bm.coarse_layout is Layout.LINEAR:
            self._lt = materialize_brick_lines(bm, make_line_table(bm))

    def upload_world_lines(self, bm: BrickMap, lt: LineTable) -> None:
        """Attach a built world and its line table as they are."""
        self._bm = bm
        self._factor = bm.factor
        self._lt = lt

    def upload_voxel_buffer(self, grid: BitGrid, factor: Optional[int] = None) -> None:
        """Build and upload the two-level world of a dense grid, on the
        grid's device (``UploadVoxelBuffer``, ``VolumeRaytracer.cu:527-572``)."""
        self.upload_world(build_brickmap(grid, factor if factor is not None else self._factor))

    def set_factor(self, f: int) -> None:
        self._factor = f

    def get_factor(self) -> int:
        return self._factor

    @property
    def world(self) -> BrickMap:
        if self._bm is None:
            raise ValueError("no world uploaded")
        return self._bm

    @property
    def line_table(self) -> Optional[LineTable]:
        return self._lt

    # -- queries -----------------------------------------------------------

    def raytrace(self, origins, rays, max_steps: int = MAX_STEPS) -> RayTraceResults:
        """Batch ray query (``VolumeRaytracer.cu:574-618``) of ``[N, 3]``
        origins and directions (tensors or arrays, moved to the world's
        device).  ``last_kernel_ms`` is the call's wall time between two
        synchronisations of the device (``VolumeRaytracer.cu:595``)."""
        bm = self.world
        dev = bm.meta.device
        origins = torch.as_tensor(origins, dtype=F32, device=dev)
        rays = torch.as_tensor(rays, dtype=F32, device=dev)
        sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda *_: None)
        sync(dev)
        t0 = time.perf_counter()
        res = _batch_trace(bm, origins, rays, max_steps, self._lt)
        sync(dev)
        self.last_kernel_ms = (time.perf_counter() - t0) * 1000.0
        if self._verbose:
            print(f"Raytracing time: {self.last_kernel_ms:.3f} ms")
        return res

    # -- edits -------------------------------------------------------------

    def edit_voxels(self, x, y, z, value) -> None:
        """Place or break voxels in place (dense-slot worlds), and keep the
        line table in step: O(edits) word writes, no rebuild."""
        if self._lt is not None:
            self._bm, self._lt = apply_edits_hbm(self.world, self._lt, x, y, z, value)
        else:
            self._bm = apply_edits(self.world, x, y, z, value)
