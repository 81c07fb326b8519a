"""The benchmark's harness, driven by data.

BENCHMARK.json names each cell's configuration and traffic mix. The harness
finds, by those names:

  * benchmark/configs/<config>.json    the deployment: the port's
                                       configuration fields ("gvom") and
                                       the sensor ("sensor");
  * benchmark/traffic/<mix>.json       the traffic: the drive it plays
                                       ("drive") and the loop that plays
                                       it ("loop");
  * benchmark/drives/<drive>.json      the drive: the lap's scans, speed
                                       and seeded features, which
                                       benchmark/scangen.py makes;
  * benchmark/workloads/<cell>.json    the cell's own parameters and the
                                       limits of its comparison;
  * benchmark/loops/<loop>.py          the code that sets up the program,
                                       measures the window and checks the
                                       outputs against the reference;
  * benchmark/metrics/<metric>.py      one reader a metric: read(record)
                                       returns the value, or None where the
                                       record holds nothing to read.

A new cell, configuration, traffic mix or metric is new files and manifest
entries; no file here changes.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Dict

ROOT = Path(__file__).resolve().parent.parent
PKG = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gvom_tpu")   # top-level module names a run may not hold

__all__ = ["Spec", "load_spec", "run_cell", "report", "main", "forbidden_modules"]


@dataclasses.dataclass
class Spec:
    """Everything a loop needs about one run."""

    workload: str
    seed: int
    seconds: float
    trace: bool
    device: object            # torch.device
    t_start: float            # perf_counter at process start
    config: Dict
    traffic: Dict
    drive: Dict
    cell: Dict
    out_dir: Path


def _load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: Path = ROOT) -> Dict:
    return _load_json(root / "BENCHMARK.json")


def load_spec(workload: str, seed: int, seconds: float, trace: bool, device, t_start: float,
              root: Path = ROOT, pkg: Path = PKG) -> Spec:
    m = manifest(root)
    cells = {w["name"]: w for w in m["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in m["configs"]}
    config = _load_json(root / configs[w["config"]]["file"])
    traffic = _load_json(pkg / "traffic" / f"{w['traffic']}.json")
    drive = _load_json(pkg / "drives" / f"{traffic['drive']}.json")
    cell = _load_json(pkg / "workloads" / f"{workload}.json")
    out = root / "bench_out" / workload / f"seed{seed}-trace{int(trace)}"
    return Spec(workload=workload, seed=int(seed), seconds=float(seconds), trace=bool(trace), device=device,
                t_start=t_start, config=config, traffic=traffic, drive=drive, cell=cell, out_dir=out)


def metrics_for(workload: str, trace: bool, root: Path = ROOT):
    """The manifest's metrics that this run reports: the end-to-end ones
    untraced, the per-layer ones traced, each where its `workloads` (if
    any) name the cell."""
    m = manifest(root)
    return [x for x in m["per_layer" if trace else "end_to_end"] if workload in x.get("workloads", [workload])]


def forbidden_modules():
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run_cell(spec: Spec, root: Path = ROOT, pkg: Path = PKG) -> Dict:
    """Run the cell once: set-up, window, comparison, metrics. Returns the
    result object (without printing it)."""
    import torch

    loop = _module(pkg / "loops" / f"{spec.traffic['loop']}.py", f"benchmark_loop_{spec.traffic['loop']}")
    spec.out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    record = loop.run(spec)
    t1 = time.perf_counter()
    tally = loop.check(spec, record)
    t2 = time.perf_counter()
    if spec.trace:
        from benchmark.trace import reduce_trace

        record["trace"] = reduce_trace(str(record["trace_path"]), record["launch_deltas"])
    timings = dict(record.get("timings", {}), run_s=t1 - t0, check_s=t2 - t1, trace_s=time.perf_counter() - t2)
    metrics = {}
    for i, mdef in enumerate(metrics_for(spec.workload, spec.trace, root)):
        reader = _module(pkg / "metrics" / f"{mdef['name']}.py", f"benchmark_metric_{i}")
        value = reader.read(record)
        if value is not None:
            metrics[mdef["name"]] = {"value": value, "unit": mdef["unit"]}
    limits = spec.cell["limits"]
    numbers = tally.numbers()
    correct = all(numbers[k] <= limits[k] for k in limits) and tally.compared > 0
    dev = spec.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(record["memory_peak_bytes"])}
    result = {"correct": bool(correct), "attempted": int(record["attempted"]), "failed": int(record["failed"]),
              "metrics": metrics, "device": device}
    if spec.trace:
        t = record["trace"]
        device["busy_s"] = t["busy_s"]
        device["window_s"] = t["window_s"]
        result["breakdown"] = t["breakdown"]
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    result["_notes"] = tally.notes + record.get("notes", []) + [
        "seconds: " + ", ".join(f"{k} {v:.3f}" for k, v in timings.items())]
    return result


def _card_power() -> str:
    import subprocess

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=20)
        return out.stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main(argv, t_start: float) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f"benchmark: cannot import torch: {e}", file=sys.stderr)
        return 2
    w = next((x for x in manifest()["workloads"] if x["name"] == args.workload), None)
    chips = w["chips"] if w else 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    try:
        import gvom_tpu_torch  # noqa: F401  the program under test
    except ImportError as e:
        print(f"benchmark: the program is not in this checkout: {e}", file=sys.stderr)
        return 2
    spec = load_spec(args.workload, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), t_start)
    return report(spec)


def report(spec: Spec, root: Path = ROOT, pkg: Path = PKG) -> int:
    """Run the cell and print its result line, unless the process then holds
    JAX or the JAX package: that is looked for last, once everything of the
    run (the window, the reference, the trace's reduction, the metrics'
    readers) has run, and ends the run with no result."""
    result = run_cell(spec, root, pkg)
    notes = result.pop("_notes")
    card = _card_power() if spec.device.type == "cuda" else "none"
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the process holds {', '.join(bad)} after the window; no result", file=sys.stderr)
        return 3
    for n in notes:
        print(f"note: {n}", file=sys.stderr)
    print(f"card: {card}; roofline peaks: 3.35 TB/s, 67 TFLOP/s f32 (H100 SXM data sheet)", file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    for k, v in result["check"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return 0
