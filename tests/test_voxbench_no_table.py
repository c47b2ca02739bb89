"""The benchmark's cell over the 8k world without a line table
(``terrain8k_1080p_no_table.shaded``): its files state the upstream's world
walked by K4-compact with ``terrain8k_1080p.shaded``'s traffic; cut to a CPU
size, a run through the harness takes the walks without a table over
compact bricks and comes out correct against ``voxbench/reference/``, and
its control does not; the cell reports K4's readers and no K1 reader, and
those readers read only K4's launches of a frame."""

import copy
import time

import pytest
import torch

from voxbench import drivers, harness, manifest, work

CELL = "terrain8k_1080p_no_table.shaded"
K1_CELL = "terrain8k_1080p.shaded"
BENCH = manifest.load()
CPU = torch.device("cpu")
LAYER = {"enqueue_ms", "device_idle_pct.frame", "shade_roofline", "world_build_s", "launch_host_ms.frame",
         "program_host_ms.frame", "kernel_launches.frame", "idle_in_program_pct.frame", "k4_rays_roofline.frame",
         "k4_secondary_roofline"}
READERS = {"k4_rays_roofline.frame": "k4_rays", "k4_secondary_roofline": "k4_secondary"}


def _files(name):
    return manifest.config_file(manifest.cell(BENCH, name)["config"]), manifest.traffic_file(name)


def _tiny():
    """The cell's own files cut to a size a CPU test holds: a 128^3 world
    of 4 octaves, 96x64 frames, the camera over the terrain, 2 checked
    steps of 256 pixels."""
    cfg, tr = (copy.deepcopy(x) for x in _files(CELL))
    cfg["world"].update(dims=[128, 128, 128], octaves=4)
    cfg["frame"].update(width=96, height=64)
    tr["camera"].update(position=[64.0, 60.0, 64.0], frames_per_turn=16)
    tr["warmup_steps"] = 2
    tr["check"].update(steps=2, pixels=256)
    return cfg, tr


def test_the_configuration_is_the_8k_world_without_a_line_table():
    cfg, _ = _files(CELL)
    k1, _ = _files(K1_CELL)
    assert cfg["world"] == {"dims": [8192, 512, 8192], "factor": 32, "octaves": 32, "bricks": "compact",
                            "line_table": False}
    assert cfg["frame"] == dict(k1["frame"], macro="off")
    assert (cfg["frame"]["width"], cfg["frame"]["height"]) == (1920, 1080)
    assert cfg["reduced"] == [] and cfg["precision"] == k1["precision"] and cfg["guarantees"] == k1["guarantees"]
    assert "voxbench/reference/" in cfg["assumed"]["reference"]
    assert "VolumeRaytracer.cu:354-525" in cfg["source"]
    assert drivers.world_route(cfg) == ("build_brickmap_terrain_compact", False)


@pytest.mark.parametrize("key", ["entry", "shading", "camera", "loop", "warmup_steps", "check"])
def test_the_traffic_is_the_k1_cells(key):
    assert _files(CELL)[1][key] == _files(K1_CELL)[1][key]


def test_the_cell_reports_frame_time_setup_and_k4s_readers():
    w = manifest.cell(BENCH, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == ("terrain8k_1080p_no_table", "shaded", 1)
    assert {m["name"] for m in manifest.end_to_end(BENCH, CELL)} == {"frame_ms", "frame_ms_p95", "setup_s"}
    layer = {m["name"] for m in manifest.per_layer(BENCH, CELL)}
    assert layer == LAYER and not any(n.startswith("k1_") for n in layer)
    for name in READERS:
        (m,) = [m for m in BENCH["per_layer"] if m["name"] == name]
        assert m["workloads"] == [CELL] and m["moves"] == "frame_ms" and m["source"] == "device_trace"
    assert manifest.reader("k4_rays_roofline.frame").LAYER == "K4 traversal"


def test_a_frame_launches_k4s_kinds():
    cfg, tr = _files(CELL)
    assert work.expected_launches(cfg, tr) == {"rays": 1, "k4_rays": 1, "shade": 1, "k4_secondary": 3}


def test_the_full_size_world_is_built_compact_without_a_line_table(monkeypatch):
    """The set-up at full size, the build stubbed: W1 to compact bricks
    with the configuration's arguments, no line table, no macro levels."""
    from voxelengine_tpu_torch.core import brickmap
    from voxelengine_tpu_torch.ops import bigtrace

    calls = []

    def stub(name):
        def fn(*a, **k):
            calls.append((name, a, k))
            return "world"
        return fn

    def no_table(*a, **k):
        raise AssertionError("a line table was built")

    for name in drivers.BUILDERS.values():
        monkeypatch.setattr(brickmap, name, stub(name))
    monkeypatch.setattr(bigtrace, "make_line_table", no_table)
    monkeypatch.setattr(bigtrace, "materialize_brick_lines", no_table)
    cfg, tr = _files(CELL)
    d = drivers.DRIVERS[tr["entry"]](cfg, tr, 2**31 + 22, CPU)
    d.setup()
    assert calls == [("build_brickmap_terrain_compact", ((8192, 512, 8192), 32), {"octaves": 32, "device": CPU})]
    assert d.bm == "world" and d.lt is None and d.cfg.trace_use_macro is False
    assert (d.cfg.width, d.cfg.height, d.cfg.ao_samples) == (1920, 1080, 4)


def _spy_walks(monkeypatch):
    """Record each walk a frame takes: ``(function, dense slots)``."""
    import voxelengine_tpu_torch.render.frame as frame

    seen = set()
    for name in ("trace_brickmap_hbm", "trace_brickmap_no_table", "trace_secondary_hbm", "trace_secondary_no_table"):
        fn = getattr(frame, name)

        def wrapped(bm, *a, _fn=fn, _name=name, **k):
            seen.add((_name, bm.dense_slots))
            return _fn(bm, *a, **k)

        monkeypatch.setattr(frame, name, wrapped)
    return seen


def test_the_cut_cell_walks_k4_compact_and_is_correct_where_its_control_is_not(monkeypatch):
    seen = _spy_walks(monkeypatch)
    cfg, tr = _tiny()
    rec = harness.run_cell(CELL, cfg, tr, 2**31 + 22, 0.4, False, "cpu", time.perf_counter(),
                           manifest.end_to_end(BENCH, CELL), manifest.per_layer(BENCH, CELL), control=True)
    got, ctl = rec["check"]["pixels_off"], rec["check"]["control.pixels_off"]
    assert rec["correct"] and got["value"] == 0.0, rec["check"]
    assert ctl["value"] > ctl["limit"], rec["check"]
    assert seen == {("trace_brickmap_no_table", False), ("trace_secondary_no_table", False)}
    assert set(rec["metrics"]) == {"frame_ms", "frame_ms_p95", "setup_s"}


class _Profile:
    """Device seconds of each launch, by kind."""

    def __init__(self, seconds):
        self.seconds = seconds

    def kind_seconds(self, kind):
        return self.seconds.get(kind, [])


def _run(entry="render_frame", kinds=("k4_rays", "k4_secondary")):
    secs = {"k4_rays": [1e-3, 1e-3], "k4_secondary": [1e-3] * 6, "k1_rays": [1e-3, 1e-3], "k1_secondary": [1e-3] * 6}
    bounds = {"k4_rays": 0.02, "k4_secondary": 0.06, "k1_rays": 0.02, "k1_secondary": 0.06}
    return work.Run(entry=entry, steps=2, window_s=1.0, profile=_Profile({k: secs[k] for k in kinds}),
                    bounds={k: bounds[k] for k in kinds})


@pytest.mark.parametrize("name", sorted(READERS))
def test_k4s_readers_read_their_kind_of_a_frame(name):
    """A rays launch of 1 ms against a 0.02 ms bound; a frame's three
    secondary launches, 3 ms, against 0.06: 2% each."""
    assert manifest.reader(name).read(_run()) == pytest.approx(2.0)


@pytest.mark.parametrize("name", sorted(READERS))
@pytest.mark.parametrize("run", [dict(entry="raytrace"), dict(entry="render_screen_present"),
                                 dict(kinds=("k1_rays", "k1_secondary"))], ids=["query", "present", "k1_frame"])
def test_k4s_readers_read_nothing_elsewhere(name, run):
    assert manifest.reader(name).read(_run(**run)) is None
