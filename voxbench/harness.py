"""One run of one cell: set-up, warm-up, a measured window, the check of its
outputs, one result line.

    python -m voxbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics:

* ``frame_ms`` (``present_frame_ms`` for presented frames): the window's
  seconds (host clock, from the first measured frame's dispatch until the
  last one's completion) over the frames completed in it;
* ``frame_ms_p95`` (``present_frame_ms_p95``): the 95th percentile of
  every frame's completion interval in the window, by CUDA events
  recorded after each frame (the first interval from an event recorded at
  the window's start);
* ``query_mrays_per_s``: rays answered by whole calls in the window over
  its seconds (host clock);
* ``setup_s``: from the process's start until the first measured step
  (host clock), the world's build and the warm-up included.

With ``--trace 1`` the window runs under ``torch.profiler`` (at most
:data:`TRACE_SECONDS`), and the result's metrics are the cell's per-layer
metrics, each from its reader in ``voxbench/metrics/``, with the device's
busy and window seconds and a breakdown.  Either way the run ends with the
check (``voxbench/check.py``) and prints, last, one JSON line.

``--control 1`` (not a driver's option) also computes the control, the
reference in bfloat16 in the program's place, on the same samples, and
prints both readings.  Exit codes: 0 with a result (``correct`` true or
false), 1 without a card, 2 for a bad argument or a world the port cannot
trace (``drivers.world_route``), 3 where the process holds JAX or the JAX
package after the window.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import subprocess
import sys
import time

import torch

from voxbench import check as checking
from voxbench import drivers, manifest, profiling, scene, work

TRACE_SECONDS = 3.0
FORBIDDEN = ("jax", "jaxlib", "flax", "voxelengine_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card_line(dev: torch.device) -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                              f"--id={dev.index or 0}"], capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return f"{torch.cuda.get_device_name(dev)}, power limit not read"


def forbidden_modules(modules=None) -> list:
    """The top-level names of ``modules`` (default: the loaded modules)
    that are JAX's or the JAX package's, compared as whole names."""
    return sorted({m.split(".")[0] for m in (sys.modules if modules is None else modules)} & set(FORBIDDEN))


def p95(values) -> float:
    """The 95th percentile: ``statistics.quantiles(n=20)``'s last cut (the
    value itself where there is one)."""
    return statistics.quantiles(values, n=20, method="inclusive")[18] if len(values) > 1 else values[0]


def window(driver, seconds: float, spans) -> dict:
    """Steps from the driver's next until ``seconds`` have passed, closed
    loop (a step's index is its frame number, so a retaken window goes on
    from where the last one ended): before
    dispatching step k the host waits for step k - ``in_flight``'s
    completion event.  Returns the steps, the window's seconds and each
    step's completion interval (ms; CUDA events on the card, the host clock
    elsewhere)."""
    dev = driver.dev
    cuda = dev.type == "cuda"
    g0 = driver.next_step
    ev = []
    done_host = []
    k = 0
    drivers.sync(dev)
    if cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    while True:
        if k >= driver.in_flight and cuda:
            with spans("wait"):
                ev[k - driver.in_flight].synchronize()
        if time.perf_counter() - t0 >= seconds:
            break
        driver.step(g0 + k, spans)
        if cuda:
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev.append(e)
        else:
            done_host.append(time.perf_counter())
        k += 1
    with spans("wait"):
        drivers.sync(dev)
    secs = time.perf_counter() - t0
    driver.next_step = g0 + k
    if cuda:
        marks = [start] + ev
        intervals = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        marks = [t0] + done_host
        intervals = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return {"steps": k, "seconds": secs, "intervals": intervals, "last": g0 + k - 1}


def run_cell(name: str, config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             e2e: list, layer: list, control: bool = False) -> dict:
    """One run of cell ``name``; returns the result record (the JSON line's
    object) and, under ``"check"``, the compared numbers."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    entry = traffic["entry"]
    driver = drivers.DRIVERS[entry](config, traffic, seed, dev)
    driver.setup()
    warm = int(traffic["warmup_steps"])
    t_warm = time.perf_counter()
    for g in range(warm):
        driver.step(g, profiling.NoSpans())
        if g == 0:
            drivers.sync(dev)
            t_warm = time.perf_counter()
    drivers.sync(dev)
    per_step = (time.perf_counter() - t_warm) / max(warm - 1, 1)
    g0 = driver.next_step = warm
    span_s = min(seconds, TRACE_SECONDS) if trace else seconds
    expect = max(int(span_s / max(per_step, 1e-6) * 0.8), 1)
    # the steps whose outputs the check keeps, besides the window's last:
    # drawn short of the window's end, by the warm-up's pace
    driver.keep_at = set(scene.sample_frames(seed, int(traffic["check"]["steps"]) - 1, g0, g0 + expect))
    setup_s = time.perf_counter() - t_start
    prof = None
    if trace and cuda:
        per = work.expected_launches(config, traffic)
        res, prof, spans, tries = profiling.profiled(
            lambda sp: window(driver, span_s, sp), lambda r: {k: v * r["steps"] for k, v in per.items()})
        if tries > 1:
            log(f"profile taken {tries} times: the earlier ones lost launches")
    else:
        spans = profiling.Spans() if trace else profiling.NoSpans()
        res = window(driver, span_s, spans)
    driver.keep_last(res["last"])
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    bounds = work.bounds(driver, res) if (trace and cuda) else {}
    if bounds:
        log(f"{name}: bound ms a launch: {bounds}")
    driver.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics = {}
    if trace:
        run = work.Run(entry=entry, steps=res["steps"], window_s=res["seconds"], spans=spans.seconds,
                       profile=prof, bounds=bounds, world_build_s=driver.world_build_s)
        for m in layer:
            v = manifest.reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        per_frame, tail = res["seconds"] * 1e3 / res["steps"], p95(res["intervals"])
        values = {"frame_ms": per_frame, "frame_ms_p95": tail, "present_frame_ms": per_frame,
                  "present_frame_ms_p95": tail, "setup_s": setup_s}
        if entry == "raytrace":
            values["query_mrays_per_s"] = res["steps"] * driver.query["rays"] / res["seconds"] / 1e6
        for m in e2e:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    t_check = time.perf_counter()
    result = checking.run(driver, False, dev)
    checks = {result["name"]: {"value": result["value"], "limit": result["limit"]}}
    if control:
        ctl = checking.run(driver, True, dev)
        checks[f"control.{ctl['name']}"] = {"value": ctl["value"], "limit": ctl["limit"]}
    log(f"{name}: check: {result['off']} of {result['samples']} samples off ({time.perf_counter() - t_check:.1f} s)")
    record = {
        "correct": result["value"] <= result["limit"],
        "attempted": res["steps"],
        "failed": 0,
        "metrics": metrics,
        "device": {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                   "count": 1, "memory_peak_bytes": memory_peak},
    }
    if prof is not None:
        busy, _ = prof.busy()
        record["device"].update(busy_s=busy, window_s=prof.window_s)
        record["breakdown"] = prof.breakdown()
    record["check"] = checks
    return record


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python -m voxbench", description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: float = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    bench = manifest.load()
    try:
        cell = manifest.cell(bench, args.workload)
        config = manifest.config_file(cell["config"])
        drivers.world_route(config)
    except (KeyError, ValueError) as e:
        log(f"FATAL: {e.args[0]}")
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"FATAL: the cell needs {cell['chips']} CUDA device(s); torch.cuda.is_available() is "
            f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            "; the benchmark measures the card and does not fall back to the CPU")
        return 1
    dev = torch.device("cuda", 0)
    log(f"device: {card_line(dev)}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    record = run_cell(cell["name"], config, manifest.traffic_file(cell["name"]),
                      args.seed, args.seconds, bool(args.trace), dev, t_start, manifest.end_to_end(bench, cell["name"]),
                      manifest.per_layer(bench, cell["name"]), control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        log(f"FATAL: the process holds {bad} after the window: nothing run on the card may load JAX or the JAX "
            "package")
        return 3
    for k, v in record["check"].items():
        log(f"{k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(record), flush=True)
    return 0
