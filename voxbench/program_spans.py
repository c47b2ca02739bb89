"""The program's own spans in a traced window, for the readers
``launch_host_ms.*``, ``program_host_ms.*``, ``kernel_launches.*`` and
``idle_in_program_pct.*``.

While a ``torch.profiler`` session runs, the program records its spans in a
ring in memory (``voxelengine_tpu_torch/utils/profiling.py::
span_records``): each record's name, start and end on
``time.perf_counter_ns``, its parent, its step (its root's index) and, for
a ``launch``, the kernel's entry.  A step's root spans are an entry's :data:`ROOTS`.  A
profile retaken by :func:`voxbench.profiling.profiled` leaves every try's
spans in the ring, so the window's steps are the newest ``run.steps`` roots
of each root name, with every span under them.  Where the program records
no spans (a version without them) every reading is None.

The idle share needs the program's spans on the profile's clock: each
step's anchored root span (:data:`ANCHOR`) ends just before the
benchmark's span of the step, which returns from the same call, so the
offset between the two clocks is the median over the steps of the
difference of their ends; its spread over the steps is logged.
"""

from __future__ import annotations

import statistics
import sys

# an entry's root spans: what a step of the entry's window calls
ROOTS = {"render_frame": ("frame",), "render_screen_present": ("screen", "bgra8"), "raytrace": ("raytrace",)}
# the root span anchored on the benchmark's span around the same call
ANCHOR = {"render_frame": ("frame", "enqueue"), "render_screen_present": ("screen", "enqueue"),
          "raytrace": ("raytrace", "call")}
# host time inside a root that is not the program's own: its kernels'
# launches (read apart) and a wait for the card; neither holds the other
NOT_PROGRAM = ("launch", "raytrace.sync")


def records() -> list:
    """The program's span records, or ``[]`` where it keeps none."""
    try:
        from voxelengine_tpu_torch.utils import profiling
    except ImportError:
        return []
    read = getattr(profiling, "span_records", None)
    return list(read()) if read is not None else []


class Window:
    """The window's steps in the program's spans: ``roots``, the newest
    ``steps`` roots of each of ``names``; ``inside``, every span under
    them, roots included; ``steps``, the steps found (the first root
    name's count)."""

    def __init__(self, recs, names, steps: int):
        roots = []
        found = []
        for name in names:
            rs = sorted((r for r in recs if r.name == name and r.parent == -1), key=lambda r: r.start_ns)
            rs = rs[-steps:]
            roots += rs
            found.append(len(rs))
        self.roots, self.steps = roots, found[0]
        ids = {r.index for r in roots}
        self.inside = [r for r in recs if r.step in ids]  # a span's step is its root's index

    def ms(self, *names) -> float:
        """Host ms a step inside the spans named ``names``."""
        return sum(r.end_ns - r.start_ns for r in self.inside if r.name in names) / self.steps / 1e6

    def count(self, name: str) -> float:
        """Spans named ``name`` a step."""
        return sum(r.name == name for r in self.inside) / self.steps

    def program_ms(self) -> float:
        """Host ms a step inside the roots, less :data:`NOT_PROGRAM`."""
        roots = sum(r.end_ns - r.start_ns for r in self.roots) / self.steps / 1e6
        return roots - self.ms(*NOT_PROGRAM)


def window(run, entry: str, recs=None):
    """The :class:`Window` of a run of ``entry`` (None in a run of another
    entry, or where the program recorded no step)."""
    if run.entry != entry or run.steps <= 0:
        return None
    w = Window(records() if recs is None else recs, ROOTS[entry], run.steps)
    return w if w.steps else None


def anchor(run, w: Window, entry: str):
    """``(offset s, spread s, steps)``: the program's clock
    (``perf_counter``, s) plus ``offset`` is the profile's window clock;
    ``spread`` is the distance between the quartiles of the steps'
    offsets.  None where no step pairs."""
    prog, bench = ANCHOR[entry]
    p = sorted(r.end_ns / 1e9 for r in w.roots if r.name == prog)
    b = sorted(t for n, _, t in run.profile.spans if n == bench)
    k = min(len(p), len(b))
    if not k:
        return None
    offs = [y - x for x, y in zip(p[len(p) - k:], b[len(b) - k:])]
    q = statistics.quantiles(offs, n=4) if k > 1 else [offs[0]] * 3
    return statistics.median(offs), q[2] - q[0], k


def _union(iv):
    out = []
    for s, t in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t)
        else:
            out.append([s, t])
    return out


def overlap_s(a, b) -> float:
    """Seconds in both unions of intervals ``a`` and ``b``."""
    a, b = _union(a), _union(b)
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(hi - lo, 0.0)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_in_program_pct(run, entry: str, metric: str, recs=None):
    """The traced window's share in which the card was idle while a root
    span of the program was open on the host."""
    w = window(run, entry, recs)
    if w is None or run.profile is None:
        return None
    a = anchor(run, w, entry)
    if a is None:
        return None
    off, spread, k = a
    roots = ", ".join(f"{n} {w.ms(n):.4f}" for n in ROOTS[entry])
    print(f"{metric}: the program's clock anchored over {k} steps, offsets' spread {spread * 1e6:.2f} us; "
          f"host ms a step in its root spans: {roots}", file=sys.stderr, flush=True)
    _, gaps = run.profile.busy()
    opened = [(r.start_ns / 1e9 + off, r.end_ns / 1e9 + off) for r in w.roots]
    return 100.0 * overlap_s(gaps, opened) / run.profile.window_s
