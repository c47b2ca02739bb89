"""Single-ray crossing dump of K1's loop: counterpart of
``voxelengine_tpu/ops/crossing_trace.py``.

The reference's ``RECORD_INTERSECTED_POINTS`` build
(``DDATestCpp/DDATestCpp.cpp:15-25,129-131``): every DDA event of one
selected ray (phase, coarse and fine cell, crossing times, step counts), so
a single disagreeing ray can be followed event by event.

How it is made.  :func:`record_crossings` records each ray's walk, one row a
loop iteration of K1 (``csrc/dda.cuh::ray_iterate``, the DIAG build): on
the card through the record instantiation of that loop
(``csrc/crossings.cu``, :mod:`voxelengine_tpu_torch.kernels.crossings`), on
the CPU through its plain version, ``ops/bigtrace.py::_lt_step`` stepped
over the rays with the same fields recorded (``csrc/crossings.cuh`` lists
them).  Both give the same rows, bit for bit.

:func:`trace_ray_crossings` then rebuilds the JAX dump's rows, which are
the iterations of the TPU kernel's loop body (``_trace_inner``) under an
always-served fetch.  K1 runs one DDA event an iteration where that body
sometimes spends two iterations on one event and sometimes one iteration
on two:

* a descend is one K1 iteration; ``_trace_inner`` first defers it to a
  ``pend_to`` row (the chunk's slot word is fetched next), whose state is
  the one before the descend with ``pending`` set, then runs it as a
  ``desc`` row;
* with ``double_step``, a fine step that ``_trace_inner`` pairs with the
  next one (the counters already say so: ``fstep`` and ``step2`` on the
  first, nothing on its partner) is one row holding the state after the
  partner; where the budget ended the ray after the first step, the
  partner step is computed here from the first one's state, as
  ``_trace_inner`` computes it in the same iteration.  Without
  ``double_step`` every fine step is its own row and ``step2`` never
  fires (a partner's ``xrun`` is recomputed from its brick word);
* ``want_line`` is the line the iteration reads, ``NOLINE`` where the ray
  retires: the region of a coarse or pending cell, ``NOLINE`` for a macro
  skip or when the brick word is the one held from the ray's previous fine
  iteration, else ``num_regions + word >> 10``; ``brick_slot`` is the slot
  of the most recent descend, 0 before it (as the TPU carry starts);
* crossing times on an axis with a zero direction are ``BIG`` (3.4e38),
  the TPU kernel's seed, where K1 seeds ``inf``.

``stall`` and ``adjstall`` are 0: there is no line cache to wait on.  The
JAX dump's ``max_iters`` cap counts its own rows; K1's iteration cap
(``3 * max_steps + 64``) counts K1's, which are never more.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from voxelengine_tpu_torch.config import MAX_STEPS
from voxelengine_tpu_torch.core.brickmap import BrickMap
from voxelengine_tpu_torch.core.layout import sample_index
from voxelengine_tpu_torch.ops.bigtrace import (
    PHASES,
    LineTable,
    _kernel_tables,
    _lt_step,
    brick_lines_view,
    prepared_rays,
)
from voxelengine_tpu_torch.ops.trace import _axis_pick3, _init_state

F32 = torch.float32
I32 = torch.int32
BIG = np.float32(3.4e38)  # the TPU kernel's "no crossing" time (pallas_bigtrace.py:61)
NOLINE = 0x7FFFFFFF  # no line wanted (pallas_bigtrace.py:62)
# csrc/crossings.cuh::CrossingField
CC, CT, FC, FT, PT, STEPS, FSTEPS, STATE, BSLOT, DIAG = 0, 3, 6, 9, 12, 15, 16, 17, 18, 19
FIELDS = DIAG + len(PHASES)
S_ACTIVE, S_FINE, S_HIT, S_IMM = 1, 2, 4, 8
MSKIP, CADV, DESC, FSTEP, STEP2, ASC, XRUN = (PHASES.index(k) for k in
                                               ("mskip", "cadv", "desc", "fstep", "step2", "asc", "xrun"))


def _is_cuda(t: torch.Tensor) -> bool:
    """Whether rays on ``t``'s device go to the kernel (one place, so a test
    can route a CPU call as a card call)."""
    return t.is_cuda


def iter_limit(max_steps: int) -> int:
    """K1's iteration cap, and the rows a ray can record."""
    return 3 * max_steps + 64


def record_crossings(bm: BrickMap, lt: LineTable, origins: torch.Tensor, rays: torch.Tensor,
                     max_steps: int = MAX_STEPS, use_macro: bool = True):
    """Record each ray's walk, one row of :data:`FIELDS` int32 words a K1
    iteration (``csrc/crossings.cuh``).  Returns ``(rows i32[N, R, FIELDS],
    nrows i32[N], flags, position, normal, steps)``: ray ``i``'s rows are
    ``rows[i, :nrows[i]]``, and the last four are K1's raw outputs for the
    rays (``flags = hit | hit_imm << 1``).  CUDA rays run the record
    instantiation of K1's loop, CPU rays its plain version."""
    if not _is_cuda(origins):
        return _record_plain(bm, lt, origins, rays, max_steps, use_macro)
    from voxelengine_tpu_torch.kernels import crossings as kc

    start_c, d, active, pad, _ = prepared_rays(bm, origins, rays)
    tables, kw = _kernel_tables(bm, lt, max_steps, use_macro)
    return kc.crossings(start_c, d, active, pad, *tables, max_rows=iter_limit(max_steps), **kw)


def _record_plain(bm: BrickMap, lt: LineTable, origins, rays, max_steps: int, use_macro: bool):
    """The record kernel's plain version: ``_lt_step`` (one K1 event a ray
    an iteration, with the diag counters) and the same fields each
    iteration, for every ray that was active before it."""
    st = _init_state(bm, origins, rays)
    n, dev = origins.shape[0], origins.device
    st["diag"] = torch.zeros((n, len(PHASES) + 1), dtype=I32, device=dev)
    st["paired"] = torch.zeros((n,), dtype=torch.bool, device=dev)
    rx, ry, _ = lt.region_dims
    gmax = torch.tensor(bm.grid_dims, dtype=I32, device=dev) - 1
    lines = lt.region_lines.reshape(-1)
    bslot = torch.zeros((n,), dtype=I32, device=dev)
    rows, was_active = [], []
    for _ in range(iter_limit(max_steps)):
        act = st["active"]
        if not bool(act.any()):
            break
        desc0 = st["diag"][:, DESC]
        st = _lt_step(bm, lt, st, max_steps, use_macro, diag=True)
        # a descend's brick slot, read as _lt_step reads it (the coarse cell
        # does not move at a descend)
        cl = torch.minimum(st["ccell"].clamp_min(0), gmax)
        rg = cl >> 3
        cidx = (rg[:, 0] + rx * (rg[:, 1] + ry * rg[:, 2])).long() * 1024 + (
            (cl[:, 0] & 7) + ((cl[:, 1] & 7) << 3) + ((cl[:, 2] & 7) << 6))
        bslot = torch.where(st["diag"][:, DESC] > desc0, lines[cidx + 512].clamp_min(0), bslot)
        state = (st["active"].to(I32) * S_ACTIVE + st["in_fine"].to(I32) * S_FINE + st["hit"].to(I32) * S_HIT
                 + st["hit_imm"].to(I32) * S_IMM)
        rows.append(torch.cat([
            st["ccell"], st["ctmax"].contiguous().view(I32), st["fcell"], st["ftmax"].contiguous().view(I32),
            st["fpos"].contiguous().view(I32), st["steps"][:, None], st["fsteps"][:, None], state[:, None],
            bslot[:, None], st["diag"][:, : len(PHASES)],
        ], dim=1).to(I32))
        was_active.append(act)
    rec = torch.stack(rows, dim=1) if rows else torch.zeros((n, 0, FIELDS), dtype=I32, device=dev)
    nrows = torch.stack(was_active, dim=1).sum(dim=1).to(I32) if rows else torch.zeros((n,), dtype=I32, device=dev)
    flags = (st["hit"].to(I32) | (st["hit_imm"].to(I32) << 1)).to(I32)
    steps = torch.where(st["active"], max_steps, st["steps"]).to(I32)
    return rec, nrows, flags, st["pos_out"], st["norm_out"], steps


def _f32(words) -> np.ndarray:
    return np.asarray(words, np.int32).view(np.float32)


class _Rebuild:
    """Turns one ray's K1 rows into the JAX dump's rows (module doc)."""

    def __init__(self, bm: BrickMap, lt: LineTable, st0, max_steps: int, double_step: bool):
        self.bm, self.lt, self.max_steps, self.double_step = bm, lt, max_steps, double_step
        self.f = bm.factor
        self.d = st0["d"][0].cpu().numpy()
        self.sign = np.where(self.d > 0.0, 1, -1).astype(np.int32)
        self.td = st0["tdelta"][0].cpu().numpy()
        self.bricks = (lt.brick_lines if lt.brick_lines is not None else brick_lines_view(bm)).reshape(-1)
        self.hwid = -1  # the brick word held from the previous fine iteration
        self.fs = np.zeros(3, np.float32)  # the fine walk's start
        self.rows = []

    def state(self, w) -> dict:
        """A K1 row as a state dict."""
        return dict(cc=w[CC:CC + 3].copy(), ct=_f32(w[CT:CT + 3]).copy(), fc=w[FC:FC + 3].copy(),
                    ft=_f32(w[FT:FT + 3]).copy(), pt=_f32(w[PT:PT + 3]).copy(), steps=int(w[STEPS]),
                    fsteps=int(w[FSTEPS]), active=bool(w[STATE] & S_ACTIVE), fine=bool(w[STATE] & S_FINE),
                    pending=False, bslot=int(w[BSLOT]), diag=w[DIAG:DIAG + len(PHASES)].copy())

    def region(self, cc) -> int:
        rx, ry, _ = self.lt.region_dims
        cl = np.clip(cc, 0, np.asarray(self.bm.grid_dims) - 1) >> 3
        return int(cl[0] + rx * (cl[1] + ry * cl[2]))

    def fine_word(self, pre) -> int:
        """The global brick-word id a fine iteration reads (its cell
        clamped into the brick)."""
        c = np.clip(pre["fc"], 0, self.f - 1)
        bit = int(sample_index(int(c[0]), int(c[1]), int(c[2]), self.f, self.f, self.bm.brick_layout))
        return pre["bslot"] * self.bm.words_per_brick + (bit >> 5)

    def fine_want(self, pre) -> tuple:
        """``(want, word id)`` of a fine iteration; the held word moves to it."""
        w = self.fine_word(pre)
        want = NOLINE if w == self.hwid else self.lt.num_regions + (w >> 10)
        self.hwid = w
        return want, w

    def emit(self, post, phase, want):
        self.rows.append(dict(post, phase=tuple(phase), want=want if post["active"] else NOLINE))

    def second_step(self, s) -> dict:
        """``_trace_inner``'s second step of a pair from the first one's
        state ``s`` (:1016-1051): the advance, its entry point, the counts."""
        t = s["ft"]
        ax = [bool(v) for v in _axis_pick3(*(torch.tensor(v) for v in t))]
        a = ax.index(True)
        out = dict(s, fc=s["fc"].copy(), ft=t.copy(), pt=s["pt"].copy())
        for k in range(3):
            out["pt"][k] = (np.float32(s["fc"][k] + (self.sign[k] > 0)) if k == a
                            else np.float32(self.fs[k] + np.float32(t[a] * self.d[k])))
        out["fc"][a] += self.sign[a]
        out["ft"][a] = np.float32(t[a] + self.td[a])
        out["fsteps"] = s["fsteps"] + 1
        out["steps"] = min(s["steps"] + 1, self.max_steps)
        return out

    def run(self, k1_rows: np.ndarray, init: dict):
        prev, i = init, 0
        while i < len(k1_rows):
            cur = self.state(k1_rows[i])
            dl = cur["diag"] - prev["diag"]
            hit = bool(k1_rows[i][STATE] & S_HIT)
            if dl[DESC]:
                self.emit(dict(prev, pending=True), ("pend_to",), self.region(prev["cc"]))
                self.fs = cur["pt"].copy()
                self.emit(cur, ("desc",), self.region(cur["cc"]))
            elif prev["fine"] and (hit or dl[ASC]):
                want, _ = self.fine_want(prev)
                self.emit(cur, ("asc",) if dl[ASC] else (), want)
            elif prev["fine"]:  # a fine step, counted or a counted one's partner
                want, w = self.fine_want(prev)
                if not dl[FSTEP]:  # a partner as its own row (double_step off)
                    axis = int(np.flatnonzero(cur["fc"] != prev["fc"])[0])
                    xrun = axis == 0 and int(self.bricks[w]) == 0
                    self.emit(cur, ("fstep",) + (("xrun",) if xrun else ()), want)
                else:
                    pair = self.double_step and bool(dl[STEP2])
                    phase = ("fstep",) + (("step2",) if pair else ()) + (("xrun",) if dl[XRUN] else ())
                    if pair:
                        if i + 1 < len(k1_rows):
                            i += 1
                            cur = self.state(k1_rows[i])
                        else:  # the budget ended the ray after the first step
                            cur = self.second_step(cur)
                        self.hwid = w  # the partner reads the same word
                    self.emit(cur, phase, want)
            elif dl[MSKIP]:
                self.emit(cur, ("mskip",), NOLINE)
            elif dl[CADV]:
                self.emit(cur, ("cadv",), self.region(prev["cc"]))
            else:  # left the world
                self.emit(cur, (), NOLINE)
            prev = cur
            i += 1
        return self.rows


def trace_ray_crossings(
    bm: BrickMap,
    lt: LineTable,
    origin,
    ray,
    max_steps: int = MAX_STEPS,
    use_macro: bool = True,
    double_step: bool = True,
    max_iters: Optional[int] = None,
):
    """Trace one ray through K1's event loop, dumping every iteration as the
    JAX package's ``trace_ray_crossings`` dumps ``_trace_inner``'s (module
    doc).  ``origin`` and ``ray`` are 3-vectors, moved to the world's device:
    the record instantiation of K1's loop on the card, its plain version on
    the CPU.

    Returns JAX's dict: ``iterations``; per row ``phase`` (the names of the
    counters that fired), ``coarse_cell``, ``fine_cell``, ``in_fine``,
    ``pending``, ``t_coarse``, ``t_fine``, ``point`` (the fine walk's
    position, brick units), ``steps``, ``fsteps``, ``want_line`` and
    ``brick_slot``; and the result, ``hit``, ``hit_immediate``,
    ``position``, ``normal`` and ``steps_total``, which are K1's for the
    ray."""
    dev = bm.meta.device
    o = torch.as_tensor(origin, dtype=F32, device=dev).reshape(1, 3)
    r = torch.as_tensor(ray, dtype=F32, device=dev).reshape(1, 3)
    rec, nrows, flags, pos, nrm, _ = record_crossings(bm, lt, o, r, max_steps, use_macro)
    st0 = _init_state(bm, o, r)
    k1_rows = rec[0, : int(nrows[0])].cpu().numpy()
    init = dict(cc=st0["ccell"][0].cpu().numpy(), ct=st0["ctmax"][0].cpu().numpy(), fc=np.zeros(3, np.int32),
                ft=np.zeros(3, np.float32), pt=np.zeros(3, np.float32), steps=0, fsteps=0, active=True,
                fine=False, pending=False, bslot=0, diag=np.zeros(len(PHASES), np.int32))
    rows = _Rebuild(bm, lt, st0, max_steps, double_step).run(k1_rows, init)
    if max_iters is None:
        max_iters = 3 * max_steps + 64  # the JAX dump's default cap
    cut = len(rows) > max_iters
    rows = rows[:max_iters]
    ran = len(rows)

    def col(key, dtype, width=None):
        shape = (ran, width) if width else (ran,)
        return np.asarray([row[key] for row in rows], dtype).reshape(shape)

    d = st0["d"][0].cpu().numpy()

    def times(key):  # TPU seed on zero-direction axes
        t = col(key, np.float32, 3)
        return np.where(np.isinf(t) & (d == 0.0), BIG, t).astype(np.float32)

    fl = 0 if cut else int(flags[0])
    hit_imm = bool(fl & 2)
    position = pos[0].cpu().numpy().astype(np.float32) if fl & 1 else np.zeros(3, np.float32)
    normal = nrm[0].cpu().numpy().astype(np.float32) if fl & 1 else np.zeros(3, np.float32)
    if hit_imm:  # degenerate 0-step hit: entry point and world-entry normal
        position = st0["start_c"][0].cpu().numpy() * np.float32(bm.factor)
        normal = st0["start_normal"][0].cpu().numpy()
    return dict(
        iterations=ran,
        phase=[row["phase"] for row in rows],
        coarse_cell=col("cc", np.int32, 3),
        fine_cell=col("fc", np.int32, 3),
        in_fine=col("fine", bool),
        pending=col("pending", bool),
        t_coarse=times("ct"),
        t_fine=times("ft"),
        point=col("pt", np.float32, 3),
        steps=col("steps", np.int32),
        fsteps=col("fsteps", np.int32),
        want_line=col("want", np.int32),
        brick_slot=col("bslot", np.int32),
        hit=bool(fl & 1),
        hit_immediate=hit_imm,
        position=position,
        normal=normal,
        steps_total=int(rows[-1]["steps"]) if ran else 0,
    )


def format_crossings(dump, limit: int = 200) -> str:
    """Human-readable event log of a :func:`trace_ray_crossings` dump (the
    JAX function's lines)."""
    lines = [
        f"# {dump['iterations']} iterations, hit={dump['hit']}"
        f" steps={dump['steps_total']} pos={dump['position']}"
    ]
    for i in range(min(dump["iterations"], limit)):
        ph = "+".join(dump["phase"][i]) or "-"
        cc = dump["coarse_cell"][i]
        if dump["in_fine"][i]:
            fc = dump["fine_cell"][i]
            lines.append(
                f"{i:5d} {ph:12s} chunk=({cc[0]},{cc[1]},{cc[2]})"
                f" cell=({fc[0]},{fc[1]},{fc[2]}) t={dump['t_fine'][i]}"
                f" steps={dump['steps'][i]}"
            )
        else:
            lines.append(
                f"{i:5d} {ph:12s} chunk=({cc[0]},{cc[1]},{cc[2]})"
                f" t={dump['t_coarse'][i]} steps={dump['steps'][i]}"
            )
    if dump["iterations"] > limit:
        lines.append(f"... {dump['iterations'] - limit} more")
    return "\n".join(lines)
