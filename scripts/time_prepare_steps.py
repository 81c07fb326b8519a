#!/usr/bin/env python3
"""The point-preparation kernel at one and at two groups of points a thread a step, on one NVIDIA GPU.

    python3 scripts/time_prepare_steps.py [--reps N]

gvom_tpu_torch/csrc/prepare.cu has each thread take STEP groups of four
points a step, all their loads issued before it computes any. This script
builds the source as committed and with STEP set to 1, holds the two builds
bit for bit against each other (keep, the origin and scan_ok, on outputs
allocated over memory filled with 0x02 bytes), and times them in turns
(committed, one, one, committed) with the launches alone captured in a CUDA
graph (chip_smoke.graph_ms): on one 131,072-point scan of the upstream
deployment and on chip_smoke.py's 32-scan batch with its dead scan and the
dead-scan mask. It prints one JSON line and the card's name and power limit.
"""

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

STEP = "constexpr int STEP = 2;"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=500)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_prepare_steps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gvom_tpu_torch import GvomConfig
    from gvom_tpu_torch.ops import kernels

    src = kernels.PREP.source.read_text()
    if STEP not in src:
        raise SystemExit(f"time_prepare_steps: {STEP!r} is not in {kernels.PREP.source}")
    one_src = ROOT / "gvom_tpu_torch" / "_build" / "prepare_step1.cu"
    one_src.parent.mkdir(parents=True, exist_ok=True)
    one_src.write_text(src.replace(STEP, "constexpr int STEP = 1;"))
    one = kernels.CudaKernel("prepare_step1", "prepare.cu", kernels.PREP.entry, kernels.PREP.argtypes,
                             "the committed kernel at one group a thread a step")
    one.source = one_src
    builds = {"committed": kernels.PREP, "one_group": one}
    procs = {name: k.start_build() for name, k in builds.items()}
    for name, k in builds.items():
        for line in k.finish_build(procs[name]).splitlines():
            if "registers" in line:
                print(f"{name}: {line.strip()}", flush=True)

    cfg = GvomConfig()
    dev = torch.device("cuda")
    scans = chip_smoke.make_scans(cfg, 8, chip_smoke.LIDAR)
    bpts, bvalid, begos = chip_smoke.make_batch(chip_smoke.scans_on_device(scans, dev), chip_smoke.BATCH, 1)
    bpts[chip_smoke.DEAD_SCAN, :, 1] += 1000.0 + 3 * cfg.xy_size * cfg.xy_resolution
    cases = {"scan": ((bpts[:1].contiguous(), bvalid[:1].contiguous(), begos[:1].contiguous()), False),
             "batch": ((bpts, bvalid, begos), True)}
    ptr = kernels._ptr

    def runner(k, work, inputs, drop_dead):
        pts, valid, egos = inputs
        S, n = valid.shape

        def run():
            keep = torch.empty((S, n), dtype=torch.bool, device=dev)
            origin = torch.empty(3, dtype=torch.int32, device=dev)
            scan_ok = torch.empty(S, dtype=torch.bool, device=dev)
            k.launch(ptr(pts), ptr(valid), ptr(egos), ptr(egos[-1]), None, None, *kernels._prep_consts(cfg), S, n,
                     *cfg.grid_shape, int(drop_dead), None, ptr(keep), ptr(origin), ptr(scan_ok), ptr(work),
                     kernels._stream())
            return keep.view(torch.uint8), origin, scan_ok.view(torch.uint8)
        return run

    # each build's own workspace (zeros; every call leaves it so)
    works = {name: torch.zeros(chip_smoke.BATCH, dtype=torch.int32, device=dev) for name in builds}
    res = {}
    for case, (inputs, drop_dead) in cases.items():
        fns = {name: runner(k, works[name], inputs, drop_dead) for name, k in builds.items()}
        chip_smoke.poison_free_memory(1 << 28, dev)
        ref = fns["committed"]()
        for name, fn in fns.items():
            chip_smoke.poison_free_memory(1 << 28, dev)
            if not all(torch.equal(a, b) for a, b in zip(fn(), ref)):
                raise SystemExit(f"time_prepare_steps: {name} differs from the committed kernel on the {case}")
        t = {name: [] for name in builds}
        for name in ("committed", "one_group", "one_group", "committed"):
            t[name].append(chip_smoke.graph_ms(fns[name], args.reps)[0])
        res[case] = t
        print(f"{case}: " + ", ".join(f"{name} {v} ms" for name, v in t.items()), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(json.dumps({"prepare_launch_alone_ms": res}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
