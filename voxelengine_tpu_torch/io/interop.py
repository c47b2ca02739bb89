"""State carried across from the JAX package's formats.

:func:`brickmap_from_numpy` takes exactly the keys that
``voxelengine_tpu/io/checkpoint.py::save_world`` writes, so a world cache
loads with ``brickmap_from_numpy(numpy.load(path), device)`` (the brick
words go in the ``.bricks.npy`` sidecar; add them under ``bricks``).
Brick and grid words arrive as uint32 and are kept as their int32 bit
patterns.  :func:`bitgrid_from_numpy` takes a dense
:class:`~voxelengine_tpu_torch.core.bitgrid.BitGrid`'s fields.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from voxelengine_tpu_torch.config import Environment, default_device
from voxelengine_tpu_torch.core.bitgrid import BitGrid
from voxelengine_tpu_torch.core.brickmap import BrickMap
from voxelengine_tpu_torch.core.layout import Layout
from voxelengine_tpu_torch.ops.bigtrace import LineTable

BRICKMAP_KEYS = (
    "meta", "brick_idx", "bricks", "grid_dims", "factor",
    "coarse_layout", "brick_layout", "dense_slots",
)


def _i32(a, device) -> torch.Tensor:
    """Integer array -> int32 tensor on ``device``, uint32 as its bit pattern."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(np.array(a, dtype=np.int32, order="C")).to(device)  # owned copy


def _layout(v) -> Layout:
    return Layout(int(getattr(v, "value", v)))


def brickmap_from_numpy(d: Mapping, device=default_device()) -> BrickMap:
    """A :class:`BrickMap` on ``device`` from ``save_world``'s mapping."""
    missing = [k for k in BRICKMAP_KEYS if k not in d]
    if missing:
        raise KeyError(f"brickmap_from_numpy: missing keys {missing}")
    return BrickMap(
        meta=_i32(d["meta"], device),
        brick_idx=_i32(d["brick_idx"], device),
        bricks=_i32(d["bricks"], device),
        grid_dims=tuple(int(v) for v in np.asarray(d["grid_dims"]).reshape(-1)),
        factor=int(d["factor"]),
        coarse_layout=_layout(d["coarse_layout"]),
        brick_layout=_layout(d["brick_layout"]),
        dense_slots=bool(d["dense_slots"]),
    )


def bitgrid_from_numpy(d: Mapping, device=default_device()) -> BitGrid:
    """A :class:`BitGrid` on ``device`` from a mapping with the JAX grid's
    fields: ``words`` (uint32 or int32), ``dims`` ``(X, Y, Z)`` and
    ``layout`` (a Layout, its name's value or an int)."""
    return BitGrid(
        words=_i32(np.asarray(d["words"]).reshape(-1), device),
        dims=tuple(int(v) for v in np.asarray(d["dims"]).reshape(-1)),
        layout=_layout(d["layout"]),
    )


def line_table_from_numpy(d: Mapping, device=default_device()) -> LineTable:
    """A :class:`LineTable` from a mapping with keys ``region_lines``,
    ``macro``, ``macro2``, ``num_regions``, ``region_dims`` and optionally
    ``brick_lines``."""
    bl = d.get("brick_lines")
    return LineTable(
        region_lines=_i32(d["region_lines"], device),
        macro=_i32(d["macro"], device),
        macro2=_i32(d["macro2"], device),
        num_regions=int(d["num_regions"]),
        region_dims=tuple(int(v) for v in np.asarray(d["region_dims"]).reshape(-1)),
        brick_lines=None if bl is None else _i32(bl, device),
    )


def environment_from_numpy(d: Mapping, device=default_device()) -> Environment:
    """An :class:`Environment` from a mapping of three float32[3] arrays."""
    def f32(k):
        return torch.from_numpy(np.array(d[k], dtype=np.float32, order="C")).to(device)

    return Environment(
        light_direction=f32("light_direction"),
        light_color=f32("light_color"),
        ambient_color=f32("ambient_color"),
    )
