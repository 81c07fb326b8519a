"""A cell's spec at a size that a CPU test run holds: a 64×64×32 grid, an
8 × 64 lidar, a lap of 32 scans in batches of at most 4, and a window of
0 s, which runs one step or map."""

from __future__ import annotations

import json
import shutil
import time
from pathlib import Path

import torch

from benchmark import harness


def checkout_copy(tmp_path: Path, left_out: bool = True) -> Path:
    """A copy of the manifest and of the benchmark's files; with left_out,
    its manifest also holds the cells of benchmark/left_out.json."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.PKG, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    m = harness.manifest()
    if left_out:
        extra = json.loads((harness.PKG / "left_out.json").read_text())
        m["configs"] += extra["configs"]
        m["workloads"] += extra["workloads"]
        for key in ("end_to_end", "per_layer"):
            have = {x["name"]: x for x in m[key]}
            for x in extra[key]:
                if x["name"] in have:
                    have[x["name"]]["workloads"] += x["workloads"]
                else:
                    m[key].append(x)
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    return root


def tiny_spec(workload: str, seed: int, out: Path, root: Path = harness.ROOT, pkg: Path = harness.PKG) -> harness.Spec:
    spec = harness.load_spec(workload, seed, 0.0, False, torch.device("cpu"), time.perf_counter(), root, pkg)
    spec.config["gvom"].update(xy_size=64, z_size=32, max_points=8 * 64)
    spec.config["sensor"].update(channels=8, azimuth_steps=64, max_range_m=30.0)
    spec.drive.update(scans=32)
    spec.drive["features"]["sectors"] = 16
    if "batch" in spec.cell:
        spec.cell["batch"] = min(spec.cell["batch"], 4)
    spec.out_dir = out
    return spec
