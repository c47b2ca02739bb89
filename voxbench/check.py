"""Whether what the timed path produced is correct: a sample, drawn from the
seed, of the window's frames or calls, compared with the plain reference
(:mod:`voxbench.reference`), which works the world out again from the
terrain rule and takes nothing the program made.

The number compared is a share of samples off: a frame's pixel whose
colour differs from the reference's by more than ``tolerance`` in some
channel (floats in [0, 1]; bytes for presented BGRA8 frames), or a query
ray whose record disagrees (valid, voxel index or normal differ, or the
hit point or distance by more than ``tolerance`` voxels).  The traffic
file's ``check`` holds the sample's size, the tolerance and the limit on
the share, with the readings the limit was set from.

The control (``control=True``) puts the reference, computed in bfloat16,
in the program's place on the same samples.
"""

from __future__ import annotations

import torch

from voxbench import scene
from voxbench.reference.render import bgra8, query_record, shade_pixels


def _frame_samples(driver, check: dict):
    """``(g, px, py, cam, euler, frame number)`` of every sampled pixel, on
    the device the reference runs on."""
    f = driver.config["frame"]
    parts = []
    for g in sorted(driver.kept):
        px, py = scene.frame_pixels(driver.seed, g, check["pixels"], f["width"], f["height"], f["checkerboard"])
        pos, eul = driver.camera(g)
        n = px.shape[0]
        parts.append((torch.full((n,), g), px, py, torch.from_numpy(pos).expand(n, 3), torch.from_numpy(eul).expand(n, 3)))
    g, px, py, cam, eul = (torch.cat(t) for t in zip(*parts))
    return g, px, py, cam, eul


def frames(driver, check: dict, control: bool, dev) -> dict:
    """Share of sampled pixels off: of the presented BGRA8 bytes where the
    entry presents its frames, else of the framebuffer's floats."""
    f, sh = driver.config["frame"], driver.traffic["shading"]
    g, px, py, cam, eul = _frame_samples(driver, check)
    frame = {"width": f["width"], "height": f["height"], "fov": f["fov"]}
    args = (cam.to(dev), eul.to(dev), g.to(dev), px.to(dev), py.to(dev), driver.world, frame, sh)
    want = shade_pixels(*args)
    presented = driver.traffic["entry"] == "render_screen_present"
    if control:
        got = shade_pixels(*args, dtype=torch.bfloat16)
        got = bgra8(got) if presented else got.to(torch.float64)
    else:
        parts = []
        for k in torch.unique(g):
            t, m = driver.kept[int(k)], g == k
            parts.append(t[py[m].to(t.device), px[m].to(t.device)].to(dev))
        got = torch.cat(parts)
        got = got if presented else got.to(torch.float64)
    if presented:
        want = bgra8(want)
        off = (got.to(torch.int32) - want.to(torch.int32)).abs().amax(dim=1) > check["tolerance"]
    else:
        off = (got - want).abs().amax(dim=1) > check["tolerance"]
    return {"samples": int(off.numel()), "off": int(off.sum())}


def queries(driver, check: dict, control: bool, dev) -> dict:
    """Share of sampled rays whose record disagrees with the reference's."""
    offs, dirs = [], []
    got = {k: [] for k in ("valid", "hit_point", "normal", "distance", "voxel_index")}
    for gi in sorted(driver.kept):
        idx = scene.query_samples(driver.seed, gi, check["rays"], driver.query["rays"])
        o, d = driver.rays(gi)
        offs.append(o[idx.to(o.device)].to(dev))
        dirs.append(d[idx.to(d.device)].to(dev))
        rec = driver.kept[gi]
        for k in got:
            got[k].append(getattr(rec, k)[idx.to(o.device)].to(dev))
    o, d = torch.cat(offs), torch.cat(dirs)
    want = query_record(o, d, driver.world)
    if control:
        got = query_record(o, d, driver.world, dtype=torch.bfloat16)
    else:
        got = {k: torch.cat(v) for k, v in got.items()}
    tol = check["tolerance"]
    vw, vg = want["valid"], got["valid"].to(torch.bool)
    both = vw & vg
    bad = vw != vg
    bad |= both & (got["voxel_index"].to(torch.int64) != want["voxel_index"])
    bad |= both & (got["normal"].to(torch.float64) != want["normal"]).any(dim=1)
    bad |= both & ((got["hit_point"].to(torch.float64) - want["hit_point"]).abs().amax(dim=1) > tol)
    bad |= both & ((got["distance"].to(torch.float64) - want["distance"]).abs() > tol)
    return {"samples": int(bad.numel()), "off": int(bad.sum())}


KINDS = {"render_frame": frames, "render_screen_present": frames, "raytrace": queries}


def run(driver, control: bool, dev) -> dict:
    """``{share name: {"value", "limit"}}`` of the traffic's check, and
    the counts it came from."""
    check = driver.traffic["check"]
    counts = KINDS[driver.traffic["entry"]](driver, check, control, dev)
    share = counts["off"] / max(counts["samples"], 1)
    return {"name": check["name"], "value": share, "limit": check["limit"], **counts}

