"""Run the multi-device entries on host data, one call a rank, for checks.

:func:`run_cases` is a rank body for
:func:`~voxelengine_tpu_torch.parallel.mesh.run_ranks`: it builds the
named worlds from numpy (the JAX package's ``save_world`` keys), runs each
case through the sharded entry it names on this rank's device, assembles
the ranks' shares (:func:`~voxelengine_tpu_torch.parallel.sharded.
gather_rows`) and returns numpy arrays, the same on every rank.  The
cross-checks against the JAX package and the single-device paths feed it
seeded numpy inputs, so spawned ranks import nothing but this package.

A case is ``(key, kind, args)``; results are keyed ``"{key}/{field}"``:

- ``zsharded``: ``trace_brickmap_zsharded`` (``world``, ``origins``,
  ``rays``, ``max_steps``); fields ``hit``, ``position``, ``normal``,
  ``steps``, and ``moved``, the rays this rank handed on each round;
- ``hbm_zsharded``: ``trace_brickmap_hbm_zsharded`` over each rank's own
  row of ``make_zsharded_hbm`` (also ``use_macro``); the same fields;
- ``hbm_tables``: each rank's row of ``make_zsharded_hbm(bm, n, rank)``,
  gathered: ``brick_lines``, ``region_lines``, ``macro``, ``macro2``;
- ``frame_rows`` / ``frame_cyclic`` / ``frame_zsharded``:
  ``render_frame_sharded`` / ``render_frame_cyclic`` /
  ``render_frame_zsharded`` (``world``, ``cfg``: ``RenderConfig`` fields
  with enum members by name, ``origin``, ``euler``, ``frames``: the frame
  numbers, chained; ``lt`` for the first two, ``zw`` for the last); field
  ``"{frame}"``, the image after that frame;
- ``raytrace``: ``raytrace_sharded`` (``world``, ``origins``, ``rays``,
  ``max_steps``, ``lt``); the four fields gathered, and ``mean``;
- ``collectives``: :func:`collectives` (no ``world``); its fields, which
  differ from rank to rank.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Tuple

import numpy as np
import torch

from voxelengine_tpu_torch.config import DebugView, Environment, Projection, RenderConfig
from voxelengine_tpu_torch.io.interop import brickmap_from_numpy
from voxelengine_tpu_torch.ops.bigtrace import make_line_table
from voxelengine_tpu_torch.parallel import distributed, sharded
from voxelengine_tpu_torch.parallel.mesh import Mesh
from voxelengine_tpu_torch.render.frame import make_framebuffer

TRACE_FIELDS = ("hit", "position", "normal", "steps")


def render_config(fields: Mapping) -> RenderConfig:
    """A :class:`RenderConfig` from plain fields, enum members by name."""
    kw = dict(fields)
    if isinstance(kw.get("debug_view"), str):
        kw["debug_view"] = DebugView[kw["debug_view"]]
    if isinstance(kw.get("projection"), str):
        kw["projection"] = Projection[kw["projection"]]
    return RenderConfig(**kw)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def run_cases(mesh: Mesh, worlds: Dict[str, Mapping], cases: List[Tuple[str, str, dict]]) -> Dict[str, np.ndarray]:
    """This rank's part of each case (module doc); returns the results."""
    dev = mesh.device
    bms = {name: brickmap_from_numpy(d, device=dev) for name, d in worlds.items()}
    lts = {}

    def lt_of(name):
        if name not in lts:
            lts[name] = make_line_table(bms[name])
        return lts[name]

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev)

    env = Environment.default(dev)
    out = {}
    for key, kind, a in cases:
        if kind == "collectives":
            out.update({f"{key}/{f}": _np(v) for f, v in collectives(mesh).items()})
            continue
        bm = bms[a["world"]]
        if kind == "zsharded":
            stats = []
            res = distributed.trace_brickmap_zsharded(bm, t(a["origins"]), t(a["rays"]), mesh, a["max_steps"], stats)
            out[f"{key}/moved"] = np.asarray([s["sent_up"] + s["sent_down"] for s in stats], np.int64)
        elif kind == "hbm_zsharded":
            zw = distributed.make_zsharded_hbm(bm, mesh.size, mesh.rank)
            res = distributed.trace_brickmap_hbm_zsharded(zw, t(a["origins"]), t(a["rays"]), mesh, a["max_steps"],
                                                          a.get("use_macro", True))
        elif kind == "hbm_tables":
            zw = distributed.make_zsharded_hbm(bm, mesh.size, mesh.rank)
            for f in ("brick_lines", "region_lines", "macro", "macro2"):
                out[f"{key}/{f}"] = _np(sharded.gather_rows(getattr(zw, f + "_stack"), mesh))
            continue
        elif kind == "raytrace":
            res, mean = sharded.raytrace_sharded(bm, t(a["origins"]), t(a["rays"]), mesh, a["max_steps"],
                                                 lt_of(a["world"]) if a["lt"] else None)
            res = type(res)(*(sharded.gather_rows(f, mesh) for f in res))
            out[f"{key}/mean"] = _np(mean)
        else:
            cfg = render_config(a["cfg"])
            origin, euler = t(a["origin"]), t(a["euler"])
            if kind == "frame_rows":
                fb = sharded.make_framebuffer_rows(cfg, mesh)
            elif kind == "frame_cyclic":
                fb = sharded.make_framebuffer_cyclic(cfg, mesh)
            else:
                fb = make_framebuffer(cfg, dev)
                zw = distributed.make_zsharded_hbm(bm, mesh.size, mesh.rank) if a["zw"] else None
            for fn in a["frames"]:
                if kind == "frame_rows":
                    sharded.render_frame_sharded(bm, fb, origin, euler, env, fn, cfg, mesh,
                                                 lt_of(a["world"]) if a["lt"] else None)
                    img = _np(sharded.gather_rows(fb, mesh))
                elif kind == "frame_cyclic":
                    sharded.render_frame_cyclic(bm, fb, origin, euler, env, fn, cfg, mesh,
                                                lt_of(a["world"]) if a["lt"] else None)
                    img = sharded.cyclic_to_image(sharded.gather_rows(fb, mesh), cfg)
                else:
                    distributed.render_frame_zsharded(bm, fb, origin, euler, env, fn, cfg, mesh, zw=zw)
                    img = _np(fb)
                out[f"{key}/{fn}"] = img.copy()
            continue
        for f, v in zip(TRACE_FIELDS, res):
            out[f"{key}/{f}"] = _np(v)
    return out



def collectives(mesh: Mesh) -> Dict[str, torch.Tensor]:
    """Each collective of the mesh on small tensors, from rank-dependent
    values: ``psum``, ``pmin``, ``pmax``, a bool ``psum``, ``all_gather``
    and the neighbour permute (rank r sends ``10 r + 1`` up and ``10 r +
    2`` down)."""
    from voxelengine_tpu_torch.parallel.mesh import all_gather, pmax, pmin, ppermute_neighbours, psum

    r = mesh.rank
    x = torch.tensor([r + 1.0, -r, 2.0 * r], device=mesh.device)
    below, above = ppermute_neighbours(torch.full((2,), 10 * r + 1, device=mesh.device),
                                       torch.full((2,), 10 * r + 2, device=mesh.device), mesh)
    return dict(psum=psum(x, mesh), pmin=pmin(x, mesh), pmax=pmax(x, mesh),
                any=psum(torch.tensor([r == 1, False], device=mesh.device), mesh),
                gather=all_gather(torch.tensor([[r, r]], device=mesh.device), mesh), below=below, above=above)


def fail_on_rank(mesh: Mesh, rank: int):
    """Raise on ``rank`` while the others wait in a collective: the
    launcher must stop them and report the failing rank."""
    from voxelengine_tpu_torch.parallel.mesh import psum

    if mesh.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    return psum(torch.ones(1, device=mesh.device), mesh)
