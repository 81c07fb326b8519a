#!/usr/bin/env python3
"""The guess-height kernel's routes on one NVIDIA GPU, and against a parent tree's.

    python3 scripts/time_guess_routes.py [--scans N] [--parent DIR]

gvom_tpu_torch/csrc/guess.cu answers a wedge query in one of two ways,
chosen by the launcher from the map's width X and the search radius R: with
the block's tile, its R-cell halo and each staged row's and column's known
bits in shared memory (the route of the upstream R = 15), or by walking the
wedge cell by cell in global memory (the route when that region would not
fit in 48 KB); a source with the maps' epilogue (the obstacle maps and the
visibility after the delta) gets io.synthetic.map_tail_inputs' seeded band
sums and slopes at origin 0 beside each map, an older one is called by its
own signature, and only the delta map is compared and timed with it. This
script builds the source as committed and with its
shared-memory limit set to 0, so that every launch walks in global memory,
and, with --parent, the guess.cu of the checkout at DIR (unpack the parent
commit there with git archive). It holds the builds bit for bit against
each other and times them in turns (parent, committed, walk, walk,
committed, parent) with the launches alone captured in a CUDA graph: on the
height and inferred-height maps of the upstream deployment's combine (the
Gvom facade after N synthetic OS1-128 scans at 256×256×64) and on the nine
seeded patterns of io.synthetic.stencil_maps at 256×256, R = 15. For each
map it counts the cells that search (no measured height, an inferred one).
It prints one JSON line and the card's name and power limit.
"""


import argparse
import ctypes
import json
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=4)
    ap.add_argument("--parent", help="a checkout whose gvom_tpu_torch/csrc/guess.cu is timed beside this one's")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_guess_routes: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gvom_tpu_torch import Gvom, GvomConfig
    from gvom_tpu_torch.io.synthetic import STENCIL_PATTERNS, map_tail_inputs, stencil_maps
    from gvom_tpu_torch.ops import kernels
    from gvom_tpu_torch.ops.maps2d import f32_value
    from gvom_tpu_torch.types import UNKNOWN_HEIGHT

    from tree_timing import card, parent_build, turns, variant_build

    limit = "constexpr int SHARED_MAX = 48 * 1024 - TILE * TILE * (4 * 8 + 2) - TILE * TILE / 32 * 4;"
    builds = {"committed": None, "walk": variant_build(kernels, kernels.GUESS, "guess_walk_global",
                                                       [(re.escape(limit), "constexpr int SHARED_MAX = 0;")])}
    if args.parent:
        builds["parent"] = parent_build(kernels, kernels.GUESS, args.parent)

    cfg = GvomConfig()
    g = Gvom(config=cfg)
    for pad, mask, ego in chip_smoke.make_scans(cfg, args.scans, chip_smoke.LIDAR):
        g.process_pointcloud(pad[mask], ego)
        g.combine_maps()
    maps = {"combine": (g.products.height.contiguous(), g.products.inferred_height.contiguous())}
    for pattern in STENCIL_PATTERNS:
        maps[pattern] = tuple(torch.from_numpy(a).cuda() for a in stencil_maps(pattern, cfg.xy_size, 0))
    # the epilogue's inputs where a source has it (the maps after the delta): seeded, beside every map
    tail = {k: torch.from_numpy(v).cuda() for k, v in map_tail_inputs(
        cfg.xy_size, cfg.slope_obstacle_threshold, cfg.negative_obstacle_threshold).items()}
    origin = torch.zeros(3, dtype=torch.int32, device="cuda")
    tail_args = (tail["slope_x"], tail["slope_y"], tail["pnum"], tail["pden"], tail["band_ok"], origin)

    def runner(k, hm, ihm):
        """The build's delta map: through the wrapper for the committed
        source, else by its own C signature (with the epilogue or without)."""
        if k is None:
            return lambda: kernels.guess_height(cfg, hm, ihm, *tail_args)[0]
        epilogue = "const void* pnum" in k.source.read_text()
        if epilogue:
            k.argtypes = kernels.GUESS.argtypes
        else:
            k.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_float] + [ctypes.c_void_p] * 2

        def run():
            out = torch.empty_like(hm)
            if epilogue:
                maps = [torch.empty(hm.shape, dtype=torch.int32, device=hm.device) for _ in range(3)]
                k.launch(*map(kernels._ptr, (hm, ihm) + tail_args), cfg.xy_size, cfg.guess_search_radius,
                         UNKNOWN_HEIGHT, f32_value(cfg.slope_obstacle_threshold),
                         f32_value(cfg.negative_obstacle_threshold), kernels._ptr(out), *map(kernels._ptr, maps),
                         kernels._stream())
            else:
                k.launch(kernels._ptr(hm), kernels._ptr(ihm), cfg.xy_size, cfg.guess_search_radius, UNKNOWN_HEIGHT,
                         kernels._ptr(out), kernels._stream())
            return out
        return run

    order = (["parent"] if args.parent else []) + ["committed", "walk", "walk", "committed"] + (
        ["parent"] if args.parent else [])
    res = {}
    for name, (hm, ihm) in maps.items():
        fns = {b: runner(k, hm, ihm) for b, k in builds.items()}
        ref = fns["committed"]()
        for b, fn in fns.items():
            if not torch.equal(fn().view(torch.int32), ref.view(torch.int32)):
                raise SystemExit(f"time_guess_routes: {b} differs from the committed kernel on {name}")
        t = turns(fns, order, 200)
        res[name] = dict(t, cells_that_search=int(((hm <= UNKNOWN_HEIGHT) & (ihm != UNKNOWN_HEIGHT)).sum()))
        print(f"{name}: " + ", ".join(f"{b} {v} ms" for b, v in t.items())
              + f" ({res[name]['cells_that_search']} cells search)", flush=True)
    smi = card()
    print(json.dumps({"guess_routes_ms": res, "R": cfg.guess_search_radius, "X": cfg.xy_size}))
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
