"""The check at a size a CPU test holds: the reference agrees with the port
on a tiny world (the two compared here only), the control (the reference
in bfloat16 in the program's place) fails, and a run whose timed path is
broken underneath comes out not correct, for each fault a cell can have."""

import dataclasses
import time

import pytest
import torch

import tiny
from voxbench import harness
from voxbench.reference import terrain

CELLS = ("terrain8k_1080p.shaded", "app1k_720p.shaded_present", "terrain8k_1080p.primary", "app1k_720p.query")


def _run(name, control=False):
    cfg, tr, e2e, layer = tiny.cell(name)
    return harness.run_cell(name, cfg, tr, 2**31 + 7, 0.6, False, "cpu", time.perf_counter(), e2e, layer,
                            control=control)


def test_the_terrain_rule_is_the_ports():
    from voxelengine_tpu_torch.worldgen.terrain import solid_at

    g = torch.Generator().manual_seed(5)
    cells = torch.randint(0, 2048, (20000, 3), generator=g)
    cells[:, 1] %= 512
    want = solid_at(cells[:, 0], cells[:, 1], cells[:, 2], octaves=32)
    assert torch.equal(terrain.solid(cells, 32), want)


@pytest.mark.parametrize("name", CELLS)
def test_the_reference_agrees_with_the_port_and_the_control_fails(name):
    rec = _run(name, control=True)
    (key, got), (_, ctl) = list(rec["check"].items())
    assert rec["correct"] and got["value"] == 0.0, rec["check"]
    assert ctl["value"] > 3 * got["limit"], rec["check"]
    e2e = {m["name"] for m in tiny.cell(name)[2]}
    assert set(rec["metrics"]) == e2e


def test_the_tiny_cameras_are_in_the_air():
    from voxbench import scene

    for name in CELLS:
        cfg, tr, _, _ = tiny.cell(name)
        pos, _, _ = scene.camera_table(tr["camera"], 1)
        assert not terrain.solid(torch.from_numpy(pos).floor().long(), cfg["world"]["octaves"]).any()


def _frame_faults():
    """Faults of a frame's render, planted in ``module``'s ``render_frame``."""
    import voxelengine_tpu_torch.render.frame as frame

    render = frame.render_frame

    def unchanged(bm, fb, *a, **k):  # the step returns its state unchanged
        return fb

    def altered(*a, **k):  # every pixel's red off where the frame is produced
        fb = render(*a, **k)
        fb[..., 0] = torch.clamp(fb[..., 0] + 0.05, 0.0, 1.0)
        return fb

    def half(bm, fb, *a, **k):  # half of the frame's pixels left out: the top rows keep the last frame's
        before = fb[: fb.shape[0] // 2].clone()
        out = render(bm, fb, *a, **k)
        out[: fb.shape[0] // 2] = before
        return out

    return {"unchanged": unchanged, "altered": altered, "half": half}


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name,module", [("terrain8k_1080p.primary", "voxelengine_tpu_torch.render.frame"),
                                         ("app1k_720p.shaded_present", "voxelengine_tpu_torch.render.graphics")])
def test_a_broken_frame_is_not_correct(monkeypatch, name, module, fault):
    import importlib

    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, "render_frame", _frame_faults()[fault])
    rec = _run(name)
    assert not rec["correct"], rec["check"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_a_broken_query_is_not_correct(monkeypatch, fault):
    from voxelengine_tpu_torch.engine.raytracer import VoxelRaytracer3D

    call = VoxelRaytracer3D.raytrace
    prev = {}

    def broken(self, origins, rays, max_steps=2048):
        res = call(self, origins, rays, max_steps)
        if fault == "unchanged":  # the call hands back the previous call's record
            out, prev["res"] = prev.get("res", res), res
            return out
        if fault == "half":  # half of the batch left out
            n = res.valid.shape[0] // 2
            valid = res.valid.clone()
            valid[n:] = False
            return dataclasses.replace(res, valid=valid)
        return dataclasses.replace(res, voxel_index=res.voxel_index + 1)  # each answer altered

    monkeypatch.setattr(VoxelRaytracer3D, "raytrace", broken)
    rec = _run("app1k_720p.query")
    assert not rec["correct"], rec["check"]


def test_a_traced_run_reports_what_the_host_reads():
    """Off the card the traced run has spans but no profile: the span and
    build readers report, the device's readers report nothing."""
    cfg, tr, e2e, layer = tiny.cell("app1k_720p.shaded_present")
    rec = harness.run_cell("app1k_720p.shaded_present", cfg, tr, 2**31 + 9, 0.6, True, "cpu", time.perf_counter(),
                           e2e, layer)
    assert set(rec["metrics"]) == {"enqueue_ms.present", "present_ms", "world_build_s"}, rec["metrics"]
    assert rec["correct"] and list(rec)[-1] == "check"
