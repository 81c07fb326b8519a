#!/usr/bin/env python3
"""Device time of the port's public per-scan entry points, on one NVIDIA GPU.

    python3 scripts/time_entry_points.py [--root DIR] [--reps N]

Imports gvom_tpu_torch from DIR (default: this checkout), so that two
commits unpacked side by side can be timed in one call, each by its own
code. At the upstream deployment (GvomConfig(): 256×256×64, 131,072 points
of a synthetic OS1-128 scan, the same scan as chip_smoke.py's first) it
times, with CUDA events, the mean of N warm calls of:

  raycast.ray_pass_counts      the whole raycast of the scan, from its points
  raycast.ray_pass_counts(y_window=)   the same for the quarter slab that
                                       holds the window seam
  pipeline.ingest_scan         prepare, raycast, binning, moments
  pipeline.ingest_scan(y_window=)      the same for that slab

These signatures are the same since the slab forms came in, whatever each
commit builds inside them. Prints one JSON line, then the card's name and
power limit.
"""

import argparse
import json
import shutil
import subprocess
import sys
from pathlib import Path


def cuda_ms(fn, reps, warm=3):
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent.parent),
                    help="checkout whose gvom_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_entry_points: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
    from gvom_tpu_torch import GvomConfig
    from gvom_tpu_torch.io import synthetic
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import binning, raycast
    from gvom_tpu_torch.ops import grid as gridops

    dev = torch.device("cuda")
    cfg = GvomConfig()
    ego_np = (0.3, -0.2, 1.5)
    pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego_np, seed=0, channels=128,
                                        azimuth_steps=2048)
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    pts, valid = torch.from_numpy(pad).to(dev), torch.from_numpy(mask).to(dev)
    ego = torch.tensor(ego_np, dtype=torch.float32, device=dev)
    p, keep = binning.prepare_points(cfg, pts, valid, ego)
    origin = gridops.compute_origin(cfg, ego)
    Ys = cfg.xy_size // 4
    yw = ((int(origin[1]) % cfg.xy_size) // Ys * Ys, Ys)

    out = dict(root=str(Path(args.root).resolve()), y_window=list(yw), reps=args.reps)
    calls = {
        "ray_pass_counts": lambda: raycast.ray_pass_counts(cfg, p, keep, ego, origin),
        "ray_pass_counts_slab": lambda: raycast.ray_pass_counts(cfg, p, keep, ego, origin, y_window=yw),
        "ingest_scan": lambda: pipeline.ingest_scan(cfg, pts, valid, ego),
        "ingest_scan_slab": lambda: pipeline.ingest_scan(cfg, pts, valid, ego, y_window=yw),
    }
    for name, fn in calls.items():
        out[name + "_ms"] = cuda_ms(fn, args.reps)
    smi = ""
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    print(smi.splitlines()[0] if smi else "nvidia-smi: no reading")
    return 0


if __name__ == "__main__":
    sys.exit(main())
