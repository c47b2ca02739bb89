"""The world a configuration states is the world a run builds and traces:
every entry over compact and dense-slot bricks, with and without a line
table, comes out correct through the route it names; the four cells keep
their builds and their launches; a world the port cannot trace fails
before any build, naming the key; the kernel kinds find K1's and K4's
launches by name."""

import time

import pytest
import torch

import tiny
from voxbench import drivers, harness, manifest, profiling, roofline, work

CELLS = ("terrain8k_1080p.shaded", "app1k_720p.shaded_present", "terrain8k_1080p.primary", "app1k_720p.query")
ROUTES = [(cell, bricks, lt) for cell in ("terrain8k_1080p.shaded", "app1k_720p.shaded_present", "app1k_720p.query")
          for bricks in ("compact", "dense_slots") for lt in (True, False)]
BUILDERS = ("build_brickmap_terrain_compact", "build_brickmap_terrain")


def _spy_traces(monkeypatch):
    """Record each walk the program takes on the CPU: ``(route, dense
    slots)``, ``route`` ``"table"`` or ``"no_table"``."""
    import voxelengine_tpu_torch.engine.raytracer as raytracer
    import voxelengine_tpu_torch.render.frame as frame

    seen = set()

    def spy(mod, name, route):
        fn = getattr(mod, name)

        def wrapped(bm, *a, **k):
            seen.add((route, bm.dense_slots))
            return fn(bm, *a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    for mod in (frame, raytracer):
        spy(mod, "trace_brickmap_hbm", "table")
        spy(mod, "trace_brickmap_no_table", "no_table")
    spy(frame, "trace_secondary_hbm", "table")
    spy(frame, "trace_secondary_no_table", "no_table")
    return seen


@pytest.mark.parametrize("name,bricks,line_table", ROUTES)
def test_every_route_is_correct_through_the_world_it_names(monkeypatch, name, bricks, line_table):
    seen = _spy_traces(monkeypatch)
    cfg, tr, e2e, layer = tiny.cell(name, bricks=bricks, line_table=line_table,
                                    macro=None if line_table else "off")
    rec = harness.run_cell(name, cfg, tr, 2**31 + 11, 0.4, False, "cpu", time.perf_counter(), e2e, layer)
    (got,) = rec["check"].values()
    assert rec["correct"] and got["value"] == 0.0, rec["check"]
    assert seen == {("table" if line_table else "no_table", bricks == "dense_slots")}


class _Stop(Exception):
    """Raised by the recorders once the world is built: nothing more is
    needed of the set-up."""


def _record_builds(monkeypatch, stop_after: bool = True):
    """Record the calls the drivers make to build a world, in order; the
    builders return a stand-in and the last step (the brick lines, or the
    facade's upload) stops the set-up."""
    from voxelengine_tpu_torch.core import brickmap
    from voxelengine_tpu_torch.engine import raytracer
    from voxelengine_tpu_torch.ops import bigtrace

    calls = []

    def builder(name):
        def fn(*a, **k):
            calls.append((name, a, k))
            return "world"
        return fn

    for name in BUILDERS:
        monkeypatch.setattr(brickmap, name, builder(name))

    def make_line_table(bm):
        calls.append(("make_line_table", (bm,), {}))
        return "lines"

    def materialize_brick_lines(bm, lt):
        calls.append(("materialize_brick_lines", (bm, lt), {}))
        raise _Stop

    def init(self, verbose_timing=False, line_table=True):
        calls.append(("VoxelRaytracer3D", (), {"line_table": line_table}))

    def upload_world(self, bm):
        calls.append(("upload_world", (bm,), {}))
        raise _Stop

    monkeypatch.setattr(bigtrace, "make_line_table", make_line_table)
    monkeypatch.setattr(bigtrace, "materialize_brick_lines", materialize_brick_lines)
    monkeypatch.setattr(raytracer.VoxelRaytracer3D, "__init__", init)
    monkeypatch.setattr(raytracer.VoxelRaytracer3D, "upload_world", upload_world)
    return calls


def _setup(name, config):
    tr = manifest.traffic_file(name)
    d = drivers.DRIVERS[tr["entry"]](config, tr, 1, torch.device("cpu"))
    with pytest.raises(_Stop):
        d.setup()


CPU = torch.device("cpu")
TODAY = {
    "terrain8k_1080p": [("build_brickmap_terrain_compact", ((8192, 512, 8192), 32), {"octaves": 32, "device": CPU}),
                        ("make_line_table", ("world",), {}), ("materialize_brick_lines", ("world", "lines"), {})],
    "app1k_720p": [("VoxelRaytracer3D", (), {"line_table": True}),
                   ("build_brickmap_terrain", ((1024, 1024, 1024), 32), {"octaves": 32, "device": CPU}),
                   ("upload_world", ("world",), {})],
}


@pytest.mark.parametrize("name", CELLS)
def test_the_four_cells_build_as_before(monkeypatch, name):
    """The full-size configurations' builds: the same functions with the
    same arguments in the same order, the line table with them."""
    calls = _record_builds(monkeypatch)
    _setup(name, manifest.config_file(manifest.cell(manifest.load(), name)["config"]))
    assert calls == TODAY[name.split(".")[0]]


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("world,key", [({"bricks": "sparse"}, "world.bricks"),
                                       ({"bricks": None}, "world.bricks"),
                                       ({"line_table": "yes"}, "world.line_table"),
                                       ({"line_table": False, "macro": "probe"}, "frame.macro"),
                                       ({"line_table": False, "macro": "on"}, "frame.macro")])
def test_a_world_the_port_cannot_trace_fails_before_the_build(monkeypatch, capsys, name, world, key):
    calls = _record_builds(monkeypatch)
    w = dict(world)
    cfg = manifest.config_file(manifest.cell(manifest.load(), name)["config"])
    if "macro" in w:
        cfg["frame"]["macro"] = w.pop("macro")
    cfg["world"].update(w)
    tr = manifest.traffic_file(name)
    with pytest.raises(ValueError, match=key.replace(".", r"\.")):
        harness.run_cell(name, cfg, tr, 1, 0.1, False, "cpu", time.perf_counter(), [], [])
    assert calls == []
    # the command refuses it as a bad argument, before it looks for a card
    monkeypatch.setattr(manifest, "config_file", lambda _name: cfg)
    assert harness.main(["--workload", name, "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and key in out.err
    assert calls == []


def test_expected_launches_of_the_four_cells_are_todays():
    today = {"terrain8k_1080p.shaded": {"rays": 1, "k1_rays": 1, "shade": 1, "k1_secondary": 3},
             "app1k_720p.shaded_present": {"rays": 1, "k1_rays": 1, "shade": 1, "k1_secondary": 3},
             "terrain8k_1080p.primary": {"rays": 1, "k1_rays": 1, "shade": 1},
             "app1k_720p.query": {"k1_rays": 1}}
    bench = manifest.load()
    for name, want in today.items():
        cfg = manifest.config_file(manifest.cell(bench, name)["config"])
        tr = manifest.traffic_file(name)
        assert work.expected_launches(cfg, tr) == want, name
        cfg["world"]["line_table"] = False
        k4 = {k.replace("k1_", "k4_"): v for k, v in want.items()}
        assert work.expected_launches(cfg, tr) == k4, name


# the names torch.profiler gives the launches on the card (the K4 names as a
# trace of the K4 routes read them; K1's as the four cells' traces do)
K1 = "void (anonymous namespace)::bigtrace_kernel<{m}, false, vx::{r}>(vx::TraceParams, vx::LineTableFetch, int, vx::{r}, "
K4 = ("void (anonymous namespace)::bmtrace_kernel<vx::{f}<{s}>, vx::{r}>(vx::TraceParams, vx::{f}<{s}>, int, int, int*, "
      "vx::{r}, float*, float*, int*)")
RAYS = (("OriginRays", "rays"), ("OriginRaysRecord", "rays"), ("SecondaryRays<0> ", "secondary"),
        ("SecondaryRays<1> ", "secondary"), ("SecondaryRays<2> ", "secondary"))
NAMES = [(K1.format(m=m, r=r), f"k1_{kind}") for m in ("false", "true") for r, kind in RAYS]
NAMES += [(K4.format(f=f, s=s, r=r), f"k4_{kind}") for f in ("DenseSlotFetch", "CompactFetch") for s in ("false", "true")
          for r, kind in RAYS]
NAMES += [("void (anonymous namespace)::rays_kernel<false>(float const*, float const*, float const*, long const*, int, "
           "int, int, int, int, int, int, int, float, float, float*, float*, long*, long*, long*)", "rays"),
          ("void (anonymous namespace)::shade_kernel<true>(vx::ShadeArgs, vx::FrameDest, int, float*, unsigned char*, "
           "float*)", "shade"),
          ("void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<at::native::"
           "CUDAFunctor_add<float> >", None), ("Memcpy DtoH (Device -> Pageable)", None), ("Memset (Device)", None)]


@pytest.mark.parametrize("name,kind", NAMES)
def test_kernel_kinds_find_k1_and_k4_by_name(name, kind):
    assert profiling.kernel_kind(name) == kind


@pytest.mark.parametrize("line_table", [True, False])
@pytest.mark.parametrize("bricks", ["compact", "dense_slots"])
def test_the_bounds_price_the_walk_the_world_takes(monkeypatch, bricks, line_table):
    """On the CPU (the issue rate set by hand) a shaded frame's work is
    priced under the kinds of its route; without a line table a compact
    world's walk also reads each hit chunk's slot."""
    monkeypatch.setattr(roofline, "issue_rates", lambda: {"issue": 3.345e13})
    name = "terrain8k_1080p.shaded"
    cfg, tr, _, _ = tiny.cell(name, bricks=bricks, line_table=line_table, macro=None if line_table else "off")
    d = drivers.DRIVERS[tr["entry"]](cfg, tr, 5, CPU)
    d.setup()
    for g in range(2):
        d.step(g, profiling.NoSpans())
    got = work.bounds(d, {"last": 1, "steps": 2})
    k = "k1" if line_table else "k4"
    assert set(got) == {f"{k}_rays", f"{k}_secondary", "shade"} and all(v > 0 for v in got.values())
    walk, table = work._walk(d.bm, d.lt, False)
    from voxelengine_tpu_torch.render.frame import primary_rays

    o, dd, *_ = primary_rays(d.cfg, d.pos[d.phase], d.eul[d.phase], 0)
    out = walk(o, dd, d.cfg.max_steps)
    hits = roofline.hit_table_bytes(out.hit, out.position, out.normal, d.bm.world_dims, d.bm.factor,
                                    d.bm.words_per_brick)
    slots = roofline.slot_bytes(out.hit, out.position, out.normal, d.bm.world_dims, d.bm.factor)
    assert slots > 0 and table(out) == hits + (slots if (bricks == "compact" and not line_table) else 0)
