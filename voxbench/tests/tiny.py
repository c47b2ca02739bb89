"""Cells at a size a CPU test holds: a 128^3 world of 4 octaves, 96x64
frames, a few thousand query rays, the camera over the terrain."""

import copy

from voxbench import manifest


def cell(name: str, bricks: str = None, line_table: bool = None, macro: str = None):
    """``(config, traffic, end-to-end metrics, per-layer metrics)`` of cell
    ``name`` cut to the tiny size; ``bricks``, ``line_table`` and ``macro``,
    where given, replace the configuration's ``world.bricks``,
    ``world.line_table`` and ``frame.macro``."""
    bench = manifest.load()
    w = manifest.cell(bench, name)
    cfg = copy.deepcopy(manifest.config_file(w["config"]))
    tr = copy.deepcopy(manifest.traffic_file(name))
    cfg["world"].update(dims=[128, 128, 128], octaves=4)
    for group, key, value in (("world", "bricks", bricks), ("world", "line_table", line_table),
                              ("frame", "macro", macro)):
        if value is not None:
            cfg[group][key] = value
    cfg["frame"].update(width=96, height=64)
    cam = tr["camera"]
    if cam["path"] == "orbit":
        cam.update(position=[64.0, 60.0, 64.0], frames_per_turn=16)
    else:
        cam.update(start=[20.0, 60.0, 100.0], frames_per_turn=12, speed=1.0)
    tr["warmup_steps"] = 2
    ch = tr["check"]
    ch.update(steps=2)
    if "pixels" in ch:
        ch["pixels"] = 256
    if "rays" in ch:
        ch["rays"] = 256
    if "query" in tr:
        tr["query"].update(rays=4096, box=16.0, batches=2)
    return cfg, tr, manifest.end_to_end(bench, name), manifest.per_layer(bench, name)
