"""``BENCHMARK.json`` and the files it names, found by name:

* a configuration: ``voxbench/configs/<config>.json``;
* a traffic mix: ``voxbench/traffic/<cell>.json``;
* a per-layer metric's reader: ``voxbench/metrics/<metric>.py``, which
  declares ``LAYER``, ``UNIT``, ``SOURCE`` and ``MOVES`` and defines
  ``read(run)``, returning the metric's value or None where the run holds
  nothing to read.

A cell, a configuration or a metric is added by adding its file and its
entry in ``BENCHMARK.json``; nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def config_file(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "configs" / f"{name}.json").read_text())


def traffic_file(cell: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{cell}.json").read_text())


def reader(metric: str, here: Path = HERE):
    """The module of ``metrics/<metric>.py`` (names hold dots, so it is
    loaded from its path)."""
    path = here / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"voxbench_metric_{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(manifest: dict, name: str) -> dict:
    for w in manifest["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def end_to_end(manifest: dict, name: str) -> list:
    """The end-to-end metrics cell ``name`` reports."""
    return [m for m in manifest["end_to_end"] if name in m.get("workloads", [name])]


def per_layer(manifest: dict, name: str) -> list:
    """The per-layer metrics cell ``name`` reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(manifest, name)}
    out = []
    for m in manifest["per_layer"]:
        if "workloads" in m:
            if name in m["workloads"]:
                out.append(m)
        elif m["moves"] in e2e:
            out.append(m)
    return out
