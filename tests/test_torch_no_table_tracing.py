"""On the card: a frame over a compact world without a line table (the
route of the benchmark's ``terrain8k_1080p_no_table`` configuration) is
the ray-setup kernel, K4-compact's rays entry, one K4-compact secondary
entry a kind on a shaded frame, and the shading kernel's composite entry,
each a ``launch`` span under the frame's stages; no ``vx.*`` range is drawn
on the device's timeline.  Both meta placements: shared memory (the small
world's own) and global memory (the 8k world's; forced by a zero limit)."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voxelengine_tpu_torch.config import Environment, RenderConfig
from voxelengine_tpu_torch.core.brickmap import build_brickmap_terrain_compact
from voxelengine_tpu_torch.kernels import bmtrace
from voxelengine_tpu_torch.render import frame
from voxelengine_tpu_torch.utils import profiling

ORIGIN = (64.0, 60.0, 64.0)
EULER = (-0.25, 0.8, 0.0)
SHADED = dict(shadow_rays=True, ao_samples=4, reflections=True)
SIZE = dict(width=96, height=64, max_steps=256, tile_order=True, checkerboard=True)


@pytest.fixture(scope="module")
def card_world():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card (see README, PyTorch/CUDA port)")
    dev = torch.device("cuda")
    bm = build_brickmap_terrain_compact((128, 128, 128), 32, octaves=4, device=dev)
    assert not bm.dense_slots
    return bm, dev


def _launches(recs, root):
    """Each ``launch`` span's entry in ``root``'s frame, in the order they opened."""
    return [r.detail for r in sorted(recs, key=lambda r: r.start_ns) if r.name == "launch" and r.step == root.index]


def _children(recs, root, detail=False):
    """``root``'s children, in the order they opened: their names, or with
    ``detail`` their details."""
    kids = [r for r in sorted(recs, key=lambda r: r.start_ns) if r.parent == root.index]
    return [r.detail for r in kids] if detail else [r.name for r in kids]


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared_meta", "global_meta"])
def test_card_frames_without_a_line_table_launch_k4_compact(card_world, monkeypatch, shared):
    bm, dev = card_world
    if not shared:
        monkeypatch.setattr(bmtrace, "SMEM_META_LIMIT", 0)
    env = Environment.default(dev)
    shaded, primary = RenderConfig(**SIZE, **SHADED), RenderConfig(**SIZE)
    fb_s, fb_p = frame.make_framebuffer(shaded, device=dev), frame.make_framebuffer(primary, device=dev)
    pos, eul = torch.tensor(ORIGIN, device=dev), torch.tensor(EULER, device=dev)
    frame.render_frame(bm, fb_s, pos, eul, env, 0, shaded)  # loads each kernel library
    frame.render_frame(bm, fb_p, pos, eul, env, 0, primary)
    torch.cuda.synchronize()
    profiling.clear_spans()
    before = (bmtrace.compact_launches, bmtrace.compact_shared_launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        frame.render_frame(bm, fb_s, pos, eul, env, 1, shaded)
        frame.render_frame(bm, fb_p, pos, eul, env, 1, primary)
        torch.cuda.synchronize()
    recs = profiling.span_records()
    profiling.clear_spans()
    roots = sorted((r for r in recs if r.name == "frame" and r.parent == -1), key=lambda r: r.start_ns)
    assert len(roots) == 2
    s, p = roots
    assert _launches(recs, s) == ["vx_rays_frame", "vx_trace_brickmap_compact_rays"] + [
        "vx_trace_brickmap_compact_secondary"] * 3 + ["vx_shade_composite"]
    assert _children(recs, s) == ["frame.rays", "frame.trace"] + ["frame.secondary"] * 3 + ["frame.shade"]
    assert _children(recs, s, detail=True)[2:5] == ["shadow", "reflection", "ao"]
    assert _launches(recs, p) == ["vx_rays_frame", "vx_trace_brickmap_compact_rays", "vx_shade_composite"]
    assert _children(recs, p) == ["frame.rays", "frame.trace", "frame.shade"]
    assert (bmtrace.compact_launches - before[0], bmtrace.compact_shared_launches - before[1]) == (
        5, 5 if shared else 0)
    on_device = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and e.name.startswith("vx.")]
    assert on_device == []
    assert bool((fb_s > 0).any()) and bool((fb_p > 0).any())
