"""The comparison's controls: the reference in bfloat16, in the program's place.

The configuration states float32 for the points and their moment sums. The
controls compute in the nearest precision below and must come out not
correct:

  * "sums"    each point's moment terms and their sums held in bfloat16,
              as a port that halved the sums' bytes would (moment_err's
              upper reading);
  * "points"  the prepared points rounded to bfloat16 as well (mismatch's).

A control replaces the batched step (replay cells) or the facade's ingest
and combine (the live cell) and leaves the rest of a run as it is.

    python benchmark/control.py --workload <cell> --seeds 1 2 3 --seconds 3

prints each seed's compared numbers, under each control, beside the cell's
limits. The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import torch

if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from benchmark.reference import pipeline as ref  # noqa: E402
from benchmark.reference.config import GvomConfig as RefConfig  # noqa: E402

__all__ = ["CONTROLS", "control_in_place", "main"]

LOWP = torch.bfloat16
CONTROLS = {"sums": dict(dtype=LOWP), "points": dict(dtype=LOWP, point_dtype=LOWP)}


def _ref_cfg(cfg) -> RefConfig:
    return RefConfig.from_dict(cfg.to_dict())


@contextlib.contextmanager
def control_in_place(control: str = "sums"):
    """Within the block, the program's batched step and the facade's ingest
    and combine are the reference's, computed as CONTROLS[control] says."""
    lowp = CONTROLS[control]
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.parallel import sharding
    from gvom_tpu_torch.types import MapProducts

    saved = sharding.make_batched_step, pipeline.ingest_and_insert, pipeline.combine

    def make_batched_step(cfg, device="cuda", mesh=None, ingest="auto"):
        rcfg = _ref_cfg(cfg)

        def step(world, scans, valid, egos):
            w, p, _ = ref.batched_step(rcfg, world, scans, valid, egos, **lowp)
            return w, MapProducts(**vars(p))
        return step

    def ingest_and_insert(cfg, buf, points, valid, ego, transform=None):
        _, ok, _ = ref.ingest(_ref_cfg(cfg), buf, points[valid], ego, **lowp)
        return buf, ok

    def combine(cfg, buf, world, ego):
        w, p, ok = ref.combine(_ref_cfg(cfg), buf, world, ego)
        return w, MapProducts(**vars(p)), ok

    sharding.make_batched_step, pipeline.ingest_and_insert, pipeline.combine = (make_batched_step, ingest_and_insert,
                                                                                combine)
    try:
        yield
    finally:
        sharding.make_batched_step, pipeline.ingest_and_insert, pipeline.combine = saved


def main(argv) -> int:
    from benchmark import harness

    ap = argparse.ArgumentParser(description="the bfloat16 control of a cell's comparison")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        for control in CONTROLS:
            spec = harness.load_spec(args.workload, seed, args.seconds, False, torch.device("cuda", 0),
                                     time.perf_counter())
            with control_in_place(control):
                r = harness.run_cell(spec)
            print(json.dumps({"workload": args.workload, "seed": seed, "control": control, "correct": r["correct"],
                              "attempted": r["attempted"], "check": r["check"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
