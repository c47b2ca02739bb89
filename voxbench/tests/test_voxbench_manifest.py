"""BENCHMARK.json and the files it names: every entry loads, names and
units keep to their characters, every per-layer metric's cells report what
it moves, a new cell is found from its files alone, and nothing under
voxbench/ imports JAX or the JAX package."""

import ast
import json
import re
import shutil
from pathlib import Path

import pytest

from voxbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
BENCH = manifest.load()


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_entries_have_their_keys_and_limits():
    assert set(BENCH) == KEYS["top"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert BENCH["paths"] == ["voxbench"] and len(BENCH["command"]) <= 32
    for c in BENCH["configs"]:
        assert set(c) == KEYS["config"] and _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        assert set(w) == KEYS["workload"] and w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["end_to_end"]
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["per_layer"] and _line(m["layer"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units_keep_to_their_characters():
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]]
    names += [w["config"] for w in BENCH["workloads"]] + [w["traffic"] for w in BENCH["workloads"]]
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names += [m["name"] for m in metrics] + [k for c in BENCH["configs"] for k in c["reduced"]]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    assert all(UNIT.match(m["unit"]) for m in metrics)
    assert all(m["better"] in ("lower", "higher") for m in metrics)
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(BENCH["workloads"])


def test_every_entry_loads_its_file():
    for c in BENCH["configs"]:
        assert c["file"] == f"voxbench/configs/{c['name']}.json"
        cfg = manifest.config_file(c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        tr = manifest.traffic_file(w["name"])
        assert tr["entry"] in ("render_frame", "render_screen_present", "raytrace")
        assert tr["check"]["limit"] > 0
    for m in BENCH["per_layer"]:
        r = manifest.reader(m["name"])
        assert (r.LAYER, r.UNIT, r.SOURCE, r.MOVES) == (m["layer"], m["unit"], m["source"], m["moves"])
        assert callable(r.read)


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in manifest.end_to_end(BENCH, w["name"])}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert manifest.per_layer(BENCH, w["name"])


def test_per_layer_metrics_cells_report_what_they_move():
    for m in BENCH["per_layer"]:
        for cell in m.get("workloads", [w["name"] for w in BENCH["workloads"]]):
            manifest.cell(BENCH, cell)
            assert m["moves"] in {e["name"] for e in manifest.end_to_end(BENCH, cell)}, (m["name"], cell)


def test_a_new_cell_is_found_from_its_files_alone(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(manifest.HERE, root / "voxbench", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "app1k_720p.later", "config": "app1k_720p", "traffic": "later", "chips": 1,
                               "why": "a cell a later change adds"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = manifest.traffic_file("app1k_720p.query")
    traffic["query"]["rays"] = 1 << 16
    (root / "voxbench" / "traffic" / "app1k_720p.later.json").write_text(json.dumps(traffic))
    here = root / "voxbench"
    loaded = manifest.load(root)
    assert manifest.cell(loaded, "app1k_720p.later")["traffic"] == "later"
    assert manifest.traffic_file("app1k_720p.later", here)["query"]["rays"] == 1 << 16
    assert {m["name"] for m in manifest.end_to_end(loaded, "app1k_720p.later")} == {"setup_s"}
    assert manifest.config_file("app1k_720p", here)["name"] == "app1k_720p"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in ("import_module", "__import__"):
            if node.args and isinstance(node.args[0], ast.Constant):
                yield node.args[0].value


@pytest.mark.parametrize("path", sorted(manifest.HERE.rglob("*.py")), ids=lambda p: str(p.relative_to(manifest.HERE)))
def test_nothing_imports_jax_or_the_jax_package(path):
    top = {name.split(".")[0] for name in _imports(path)}
    assert not top & {"jax", "jaxlib", "flax", "voxelengine_tpu"}


def test_the_forbidden_names_are_compared_whole():
    from voxbench import harness

    assert harness.forbidden_modules(["voxelengine_tpu_torch", "voxelengine_tpu_torch.render.frame", "jaxtyping"]) == []
    assert harness.forbidden_modules(["voxelengine_tpu.ops.trace", "jax._src.api", "numpy"]) == ["jax", "voxelengine_tpu"]
