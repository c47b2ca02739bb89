"""World and line-table checkpoints: counterpart of
``voxelengine_tpu/io/checkpoint.py``.

The same files as the JAX package, so a cache written by either package
loads in the other:

* a world is ``<key>.npz`` (compressed: ``version``, ``meta``,
  ``brick_idx``, ``grid_dims``, ``factor``, ``coarse_layout``,
  ``brick_layout``, ``dense_slots``) plus the raw brick words in the
  ``<key>.npz.bricks.npy`` sidecar, written sidecar first and npz last,
  each through a temporary file and ``os.replace``, so the npz, the cache's
  validity marker, never exists without its bricks;
* a line table is ``<key>.lt.npz`` with its side tables and
  ``layout_version`` (:data:`LINE_TABLE_LAYOUT_VERSION`); the brick lines
  are a view of the bricks and are not stored.

Brick words are uint32 in the files and their int32 bit patterns in the
port.  Left out: the JAX package's orbax pair (``save_world_orbax`` /
``load_world_orbax``), which is bound to JAX's checkpoint stack.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys

import numpy as np
import torch

from voxelengine_tpu_torch.config import default_device
from voxelengine_tpu_torch.core.brickmap import BrickMap
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy, line_table_from_numpy
from voxelengine_tpu_torch.ops.bigtrace import MACRO2_WORDS, MACRO3_WORDS, LineTable, make_line_table

FORMAT_VERSION = 1
# bump whenever the macro table LAYOUT changes (bit grouping, word
# packing): 3 = word budgets 32+4 (the JAX package's number)
LINE_TABLE_LAYOUT_VERSION = 3
_SMALL_KEYS = ("meta", "brick_idx", "grid_dims", "factor", "coarse_layout", "brick_layout", "dense_slots")


def _world_paths(path: str):
    """Canonical (npz, bricks sidecar) paths for a world checkpoint:
    callers may pass the base name or the .npz name."""
    npz = path if path.endswith(".npz") else path + ".npz"
    return npz, npz + ".bricks.npy"


def _np_i32(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_world(path: str, bm: BrickMap) -> None:
    """Write a brickmap world: the small tables compressed in the .npz, the
    brick words raw (uint32) in the ``.bricks.npy`` sidecar, sidecar first
    and npz last, each atomically (module doc)."""
    path, sidecar = _world_paths(path)
    np.save(sidecar + ".tmp.npy", _np_i32(bm.bricks).view(np.uint32))
    os.replace(sidecar + ".tmp.npy", sidecar)
    np.savez_compressed(
        path + ".tmp.npz",
        version=FORMAT_VERSION,
        meta=_np_i32(bm.meta),
        brick_idx=_np_i32(bm.brick_idx),
        grid_dims=np.asarray(bm.grid_dims),
        factor=bm.factor,
        coarse_layout=bm.coarse_layout.value,
        brick_layout=bm.brick_layout.value,
        dense_slots=bm.dense_slots,
    )
    os.replace(path + ".tmp.npz", path)


def _load(path: str):
    """(npz tables, bricks as a host array or memmap) of a world file, in
    either the sidecar form or the older all-in-npz form."""
    path, sidecar = _world_paths(path)
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"{path}: unknown world format {int(z['version'])}")
        small = {k: z[k] for k in _SMALL_KEYS}
        bricks = z["bricks"] if "bricks" in z.files else None
    if bricks is None:
        bricks = np.load(sidecar, mmap_mode="r")
    return small, bricks


def load_world(path: str, device=default_device()) -> BrickMap:
    """A world saved by :func:`save_world` (either package's), on ``device``."""
    small, bricks = _load(path)
    return brickmap_from_numpy(dict(small, bricks=bricks), device)


def load_world_host_bricks(path: str, device=default_device()):
    """A world's small tables on ``device`` with the brick words left on
    the host: ``(bm, bricks_host)``, ``bm.bricks`` None (``words_per_brick``
    comes from ``factor``) and ``bricks_host`` the read-only ``uint32[N,
    wpb]`` memmap of the sidecar (or the array of an all-in-npz file)."""
    small, bricks = _load(path)
    placeholder = np.zeros((0, bricks.shape[1]), np.int32)  # brickmap_from_numpy wants bricks
    bm = brickmap_from_numpy(dict(small, bricks=placeholder), device)
    return dataclasses.replace(bm, bricks=None), bricks


def generate_or_load(cache_dir: str, key: str, generate_fn, device=default_device()) -> BrickMap:
    """Load ``{cache_dir}/{key}.npz`` onto ``device`` if it is there and
    readable, else build it with ``generate_fn()`` and save it."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, key + ".npz")
    if os.path.exists(path):
        try:
            return load_world(path, device)
        except Exception as e:  # truncated npz, deleted sidecar: rebuild
            print(f"world cache {path} unreadable ({type(e).__name__}: {e}); rebuilding",
                  file=sys.stderr, flush=True)
    bm = generate_fn()
    save_world(path, bm)
    return bm


def memo_json(cache_dir: str, key: str, fn):
    """A JSON-value disk memo: the value cached for ``key`` in
    ``{cache_dir}/{key}.memo.json`` if it is there and readable, else
    ``fn()``, stored (atomically) and returned.  For hints whose staleness
    is harmless, such as ``render.frame.probe_use_macro``'s decision
    (traversal results are the same either way); callers fold every input
    of the decision into ``key``."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, key + ".memo.json")
    if os.path.exists(path):
        try:
            with open(path) as f:
                return json.load(f)["value"]
        except Exception as e:  # truncated or corrupt: recompute
            print(f"memo {path} unreadable ({type(e).__name__}: {e}); recomputing", file=sys.stderr, flush=True)
    value = fn()
    if hasattr(value, "item"):  # a numpy or torch scalar
        value = value.item()
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"key": key, "value": value}, f)
    os.replace(tmp, path)
    return value


def save_line_table(path: str, lt: LineTable) -> None:
    """Write a :class:`LineTable`'s side tables (region lines, macro levels)
    atomically; the brick lines are a view of the bricks and are not
    stored."""
    np.savez_compressed(
        path + ".tmp.npz",
        version=FORMAT_VERSION,
        layout_version=LINE_TABLE_LAYOUT_VERSION,
        region_lines=_np_i32(lt.region_lines),
        macro=_np_i32(lt.macro),
        macro2=_np_i32(lt.macro2),
        num_regions=lt.num_regions,
        region_dims=np.asarray(lt.region_dims),
    )
    os.replace(path + ".tmp.npz", path)


def load_line_table(path: str, device=default_device()) -> LineTable:
    """A line table saved by :func:`save_line_table` (either package's), on
    ``device``.  Refuses one of another macro layout (its words would be
    misread); pads a ``macro2`` written before a macro level existed with
    all-occupied words (-1), which turns that level off."""
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"{path}: unknown line-table format {int(z['version'])}")
        layout_version = int(z["layout_version"]) if "layout_version" in z.files else 1
        if layout_version != LINE_TABLE_LAYOUT_VERSION:
            raise ValueError(f"{path}: stale line-table layout {layout_version}")
        d = {k: z[k] for k in ("region_lines", "macro", "macro2", "num_regions", "region_dims")}
    want = MACRO2_WORDS + MACRO3_WORDS
    if d["macro2"].shape[0] < want:
        d["macro2"] = np.concatenate([d["macro2"], np.full(want - d["macro2"].shape[0], -1, np.int32)])
    return line_table_from_numpy(d, device)


def line_table_or_build(cache_dir: str, key: str, bm: BrickMap) -> LineTable:
    """:func:`~voxelengine_tpu_torch.ops.bigtrace.make_line_table` of ``bm``,
    cached as ``{cache_dir}/{key}.lt.npz``: loaded onto ``bm``'s device
    when the file is there and readable, else built and saved."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, key + ".lt.npz")
    if os.path.exists(path):
        try:
            return load_line_table(path, bm.meta.device)
        except Exception:
            pass  # stale layout or truncated file: rebuild below
    lt = make_line_table(bm)
    save_line_table(path, lt)
    return lt
