#!/usr/bin/env python3
"""The kernel forms past the upstream shapes on one NVIDIA GPU, against a parent tree's.

    python3 scripts/time_wide_forms.py --parent DIR [--out FILE]

Two kernels take the configurations that the upstream deployment does not
reach: the moments epilogue (K3, K5; gvom_tpu_torch/csrc/epilogue.cu) at
eigen distances past its tiled kernel's box, and the combine (K4;
gvom_tpu_torch/csrc/combine.cu) past 16 ring-buffer slots or 256 z.
chip_smoke.py holds both bitwise (or within the f32 summation bound, the
direct epilogue) at these shapes; this script times them against the same
sources of the checkout at DIR (unpack the parent commit there with git
archive, built by scripts/tree_timing.py) in turns (parent, this tree, this
tree, parent), each launch alone, ten captured in a CUDA graph
(chip_smoke.graph_ms):

  * the epilogue on one upstream scan's sums (256×256×64, an OS1-128 sweep)
    at eigen (xy, z) = (1, 9), (8, 1), (5, 8), mask off and mask on, on the
    full grid and on the quarter slab that holds the window seam, with the
    kernel that takes each (kernels.epilogue_route); a source without the
    workspace argument is called by its own signature;
  * the epilogue with the mask on at the boxes of THRESHOLD_BOXES, full
    grid, built twice: with every such box on the direct kernel and with
    every box on the separable passes (BOX_DIRECT_MAX set to 2^30 and 0),
    in turns direct, passes, passes, direct; the passes held bitwise
    against the plain version, the direct kernel's n too. Where the direct
    kernel stops winning sets BOX_DIRECT_MAX;
  * K4 at buffer_size 17 (256×256×64) and at z_size 320 (B = 4), on the
    state of the Gvom facade after two upstream scans (as chip_smoke.py's
    phase1_wide_configs) and with its ring buffer full (B + 1 scans, the 8
    scans taken in turn), each against chip_smoke.combine_bound.

It prints a line a timing, one JSON line and the card's name and power
limit; with --out it also writes the JSON there.
"""

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

EIGEN_DISTS = ((1, 9), (8, 1), (5, 8))
# mask-on boxes past the tiled kernel, (2rx+1)²(2rz+1) = 171, 225, 297, 369, 475, 625, 825, 867 and 931 voxels
THRESHOLD_BOXES = ((1, 9), (1, 12), (1, 16), (1, 20), (2, 9), (2, 12), (2, 16), (8, 1), (3, 9))
SCANS = 8
WIDE = ((dict(buffer_size=17), 2), (dict(buffer_size=17), 18), (dict(z_size=320), 2), (dict(z_size=320), 5))
BOX_DIRECT_MAX = r"constexpr int BOX_DIRECT_MAX = \d+;"


def swapped(kernels, attr, k, fn):
    """fn with kernels.<attr> set to the build k while it runs."""
    def run():
        this = getattr(kernels, attr)
        setattr(kernels, attr, k)
        try:
            return fn()
        finally:
            setattr(kernels, attr, this)
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a checkout whose epilogue.cu and combine.cu are timed beside")
    ap.add_argument("--out", help="also write the JSON line to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_wide_forms: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from gvom_tpu_torch import Gvom, GvomConfig
    from gvom_tpu_torch.ops import binning, kernels, moments
    from gvom_tpu_torch.utils.compare import bitwise
    from tree_timing import build, card, parent_build, turns, variant_build

    dev = "cuda"
    for k, report in kernels.build_all(GvomConfig(buffer_size=17)).items():
        for line in report.splitlines():
            if any(w in line for w in ("entry function", "registers", "spill")) and k in ("moments_epilogue",
                                                                                          "combine"):
                print(f"ptxas {k}: {line.strip()}")
    pepi, pcmb = parent_build(kernels, kernels.XBOX, args.parent), parent_build(kernels, kernels.CMB, args.parent)
    old_signature = "void* work" not in pepi.source.read_text()
    if old_signature:
        pepi.argtypes = pepi.argtypes[:-2] + pepi.argtypes[-1:]
    forced = {"direct": variant_build(kernels, kernels.XBOX, "epilogue_direct_all",
                                      [(BOX_DIRECT_MAX, "constexpr int BOX_DIRECT_MAX = 1 << 30;")]),
              "passes": variant_build(kernels, kernels.XBOX, "epilogue_passes_all",
                                      [(BOX_DIRECT_MAX, "constexpr int BOX_DIRECT_MAX = 0;")])}
    build(pepi, pcmb, *forced.values())

    cfg = GvomConfig()
    scans = chip_smoke.make_scans(cfg, SCANS, chip_smoke.LIDAR)
    pts, valid, ego = chip_smoke.scan_tensors(scans[0], dev)
    res = {"epilogue": {}, "box_direct_max": {}, "combine": {}}
    for xye, ze in EIGEN_DISTS:
        c = dataclasses.replace(cfg, xy_eigen_dist=xye, z_eigen_dist=ze)
        X, Y, Z = c.grid_shape
        rx, ry, rz = binning.moment_pad(c)
        p, keep, origin, _ = kernels.prepare_points(c, pts[None], valid[None], ego[None], frame_ego=ego)
        Ys = Y // 4
        yw = ((int(origin[1]) % Y) // Ys * Ys, Ys)
        for where, window in (("full", None), (f"slab {yw}", yw)):
            bins = kernels.bin_points(c, p[0], keep[0], origin, window)
            ys0, ys = binning.check_y_window(c, window)
            for mask in (False, True):
                what = f"eigen ({xye}, {ze}) {where} mask {'on' if mask else 'off'}"
                route = kernels.epilogue_route(c, window, mask)

                def parent_run(bins=bins, ys0=ys0, ys=ys, mask=mask):
                    out = torch.empty((10, X, ys, Z), dtype=torch.float32, device=dev)
                    a = [kernels._ptr(bins.sums), kernels._ptr(bins.hit), kernels._ptr(origin), None,
                         X, Y, Z, rx, ry, rz, ys0, ys, int(mask), kernels._ptr(out)]
                    pepi.launch(*a, *([] if old_signature else [None]), kernels._stream())
                    return out

                def this_run(b=bins, w=window, m=mask):
                    return kernels.moments_epilogue(c, b.sums, b.hit, origin, w, m)

                diff = float((parent_run() - this_run()).abs().max())
                t = turns({"parent": parent_run, "this": this_run}, ("parent", "this", "this", "parent"), 20)
                res["epilogue"][what] = dict(t, route=route, parent_max_abs_diff=diff)
                print(f"epilogue {what} ({route}): " + ", ".join(f"{b} {v} ms" for b, v in t.items()), flush=True)
            del bins
        torch.cuda.empty_cache()

    for xye, ze in THRESHOLD_BOXES:
        c = dataclasses.replace(cfg, xy_eigen_dist=xye, z_eigen_dist=ze)
        p, keep, origin, _ = kernels.prepare_points(c, pts[None], valid[None], ego[None], frame_ego=ego)
        bins = kernels.bin_points(c, p[0], keep[0], origin)
        fns = {name: swapped(kernels, "XBOX", k, lambda: kernels.moments_epilogue(c, bins.sums, bins.hit, origin))
               for name, k in forced.items()}
        plain = moments.moments_epilogue_plain(c, bins.sums, bins.hit, origin)
        bitwise(f"the separable passes at eigen ({xye}, {ze}) mask on", fns["passes"](), plain)
        got = fns["direct"]()
        bitwise(f"the direct kernel's n at eigen ({xye}, {ze}) mask on", got[0], plain[0])
        t = turns(fns, ("direct", "passes", "passes", "direct"), 20)
        box = (2 * xye + 1) ** 2 * (2 * ze + 1)
        res["box_direct_max"][f"({xye}, {ze})"] = dict(
            t, box=box, hits=int((bins.hit > 0).sum()), direct_max_abs_diff=float((got - plain).abs().max()),
            route=kernels.epilogue_route(c, None, True))
        print(f"mask on, eigen ({xye}, {ze}), box {box}: " + ", ".join(f"{b} {v} ms" for b, v in t.items()),
              flush=True)
        del bins, plain, got
    torch.cuda.empty_cache()

    for fields, n in WIDE:
        c = dataclasses.replace(cfg, **fields)
        what = ", ".join(f"{k}={v}" for k, v in fields.items()) + f", {n} scans"
        g = Gvom(config=c)
        for i in range(n):
            pad, m, e = scans[i % len(scans)]
            g.process_pointcloud(pad[m], e)
            g.combine_maps()
        buf, world = g._buffer, g._world
        target = buf.grids.origin.index_select(0, buf.last_slot.reshape(1).long())[0]
        e = torch.tensor(scans[(n - 1) % len(scans)][2], dtype=torch.float32, device=dev)
        launch, outs = kernels.combine_launch(c, buf, world, target, e)
        launch()
        nbytes, _ = chip_smoke.combine_bound(c, buf, world, target, outs[0])
        t = turns({"parent": swapped(kernels, "CMB", pcmb, launch), "this": launch},
                  ("parent", "this", "this", "parent"), 20)
        bound = 1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S
        res["combine"][what] = dict(t, bound_ms=bound)
        print(f"combine at {what}: " + ", ".join(f"{b} {v} ms" for b, v in t.items()) + f", bound {bound} ms",
              flush=True)
        del g, buf, world, launch, outs
        torch.cuda.empty_cache()
    smi = card()
    line = json.dumps({"wide_forms_ms": res, "device": smi})
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
