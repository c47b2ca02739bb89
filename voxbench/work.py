"""What the per-layer readers read (:class:`Run`), and the work a step's
kernels must do, for their roofline shares.

The work is counted after the traced window, on the steps' own inputs
through the program's public calls (the primary rays of
``render/frame.py::primary_rays``, their trace by the walk the world
takes: ``ops/bigtrace.py::trace_brickmap_hbm`` through a line table,
``ops/trace2.py::trace_brickmap_no_table`` without one; the secondary walks
by ``ops/secondary.py::secondary_plain`` over it), and priced by
:mod:`voxbench.roofline`.  The kinds are K1's (``k1_rays``,
``k1_secondary``) where the world has a line table and K4's (``k4_rays``,
``k4_secondary``) where it has none.  A bound is the least time a launch
needs; a share is that bound over the launch's device time in the traced
window.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from voxbench import roofline

WORK_STEPS = 3  # steps of the traced window whose work is counted


@dataclass
class Run:
    """A traced run as the readers see it."""

    entry: str
    steps: int
    window_s: float
    spans: dict = field(default_factory=dict)  # name -> each span's seconds
    profile: object = None  # voxbench.profiling.Profile
    bounds: dict = field(default_factory=dict)  # kernel kind -> bound ms a launch
    world_build_s: float = 0.0

    def roofline_pct(self, entry: str, kind: str, per_frame: bool = False):
        """A kernel kind's bound a launch over its mean device time a launch
        in the traced window, in percent, in runs of ``entry`` (None
        elsewhere); ``per_frame``: the bound covers a frame's launches of
        the kind together, so the device time is summed a frame."""
        if self.entry != entry or self.profile is None or kind not in self.bounds:
            return None
        secs = self.profile.kind_seconds(kind)
        if not secs:
            return None
        ms = sum(secs) * 1e3 / (self.steps if per_frame else len(secs))
        return 100.0 * self.bounds[kind] / ms

    def idle_pct(self, entry: str):
        """The traced window's share with no operation on the card."""
        if self.entry != entry or self.profile is None:
            return None
        busy, _ = self.profile.busy()
        return 100.0 * (1.0 - busy / self.profile.window_s)

    def span_ms(self, entry: str, name: str):
        """The mean of span ``name``'s durations, in ms."""
        s = self.spans.get(name)
        return sum(s) / len(s) * 1e3 if self.entry == entry and s else None


def _kernel(config: dict) -> str:
    """The traversal kernel of ``config``'s world: K1 through its line
    table, K4 without one."""
    return "k1" if config["world"]["line_table"] else "k4"


def expected_launches(config: dict, traffic: dict) -> dict:
    """The port's kernels a step launches, by kind: a frame's ray-setup
    kernel, the traversal's rays entry (K1's or K4's), one secondary entry
    a kind and the shading kernel; a query's record entry (a rays entry)."""
    k = _kernel(config)
    if traffic["entry"] == "raytrace":
        return {f"{k}_rays": 1}
    sh = traffic["shading"]
    kinds = int(sh["shadows"]) + int(sh["reflections"]) + int(sh["ao_samples"] > 0)
    out = {"rays": 1, f"{k}_rays": 1, "shade": 1}
    if kinds:
        out[f"{k}_secondary"] = kinds
    return out


def _walk(bm, lt, use_macro: bool):
    """``(walk(o, d, max_steps), table_bytes(out))``: the program's trace of
    the world, through ``lt`` or without a table, and the table bytes its
    hits need (a compact world's K4 also reads each hit chunk's slot)."""
    from voxelengine_tpu_torch.ops.bigtrace import trace_brickmap_hbm
    from voxelengine_tpu_torch.ops.trace2 import trace_brickmap_no_table

    dims, f, wpb = bm.world_dims, bm.factor, bm.words_per_brick

    def table(out):
        b = roofline.hit_table_bytes(out.hit, out.position, out.normal, dims, f, wpb)
        if lt is None and not bm.dense_slots:
            b += roofline.slot_bytes(out.hit, out.position, out.normal, dims, f)
        return b

    if lt is not None:
        return (lambda o, d, ms: trace_brickmap_hbm(bm, lt, o, d, ms, use_macro=use_macro)), table
    return (lambda o, d, ms: trace_brickmap_no_table(bm, o, d, ms)), table


def _frame_world(driver):
    if hasattr(driver, "rt"):
        return driver.rt.world, driver.rt.line_table, driver.g.environment
    return driver.bm, driver.lt, driver.env


def _frame_bounds(driver, g: int) -> dict:
    from voxelengine_tpu_torch.ops.secondary import frame_kinds, secondary_plain
    from voxelengine_tpu_torch.render.frame import primary_rays

    bm, lt, env = _frame_world(driver)
    cfg = driver.cfg
    k = _kernel(driver.config)
    walk, table = _walk(bm, lt, cfg.trace_use_macro)
    i = (driver.phase + g) % driver.period
    o, d, px, py, _ = primary_rays(cfg, driver.pos[i], driver.eul[i], g)
    n = o.shape[0]
    out = walk(o, d, cfg.max_steps)
    res = {f"{k}_rays": roofline.bound(n, table(out), int(out.steps.sum()), roofline.grid_ray_bytes(o, d))}
    kinds = frame_kinds(cfg)
    if kinds:
        total = 0.0
        for kind in kinds:
            walks = []

            def trace(oo, dd, ms, walks=walks):
                r = walk(oo, dd, ms)
                walks.append(r)
                return r

            secondary_plain(kind, trace, out, d, px, py, env, g, cfg)
            steps = sum(int(r.steps.sum()) for r in walks)
            total += roofline.bound(n, sum(table(r) for r in walks), steps, roofline.secondary_bytes(kind, d))
        res[f"{k}_secondary"] = total  # a frame's three launches together
    shade_bytes = roofline.shade_bytes(cfg.width, cfg.height, out.hit, d, px, py, cfg.crosshair, bool(kinds))
    res["shade"] = max(shade_bytes / roofline.HBM_BYTES_PER_S * 1e3, roofline.shade_ops_ms(out.hit))
    return res


def _query_bounds(driver, g: int) -> dict:
    bm = driver.rt.world
    walk, table = _walk(bm, driver.rt.line_table, False)
    o, d = driver.rays(g)
    out = walk(o, d, driver.max_steps)
    return {f"{_kernel(driver.config)}_rays": roofline.bound(o.shape[0], table(out), int(out.steps.sum()),
                                                             roofline.grid_ray_bytes(o, d))}


def bounds(driver, res: dict) -> dict:
    """Mean bound ms a launch of each kind (the secondary entries: a
    frame's launches together) over :data:`WORK_STEPS` steps of the window."""
    last = res["last"]
    steps = [g for g in range(last - WORK_STEPS + 1, last + 1) if g >= last - res["steps"] + 1]
    fn = _query_bounds if driver.traffic["entry"] == "raytrace" else _frame_bounds
    with torch.no_grad():
        per = [fn(driver, g) for g in steps]
    return {k: sum(p[k] for p in per) / len(per) for k in per[0]}
