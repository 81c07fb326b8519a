#!/usr/bin/env python3
"""The kernel forms past the upstream shapes, and the plane fit, on one NVIDIA GPU, against a parent tree's.

    python3 scripts/time_wide_forms.py --parent DIR [--out FILE]

Three kernels take the configurations that the upstream deployment does not
reach: the moments epilogue (K3, K5; gvom_tpu_torch/csrc/epilogue.cu) at
eigen distances past its tiled kernel's box, the combine (K4;
gvom_tpu_torch/csrc/combine.cu) past 16 ring-buffer slots or 256 z, and the
batched merge (gvom_tpu_torch/csrc/merge.cu) past 256 z. chip_smoke.py holds
them bitwise (or within the f32 summation bound, the direct epilogue) at
these shapes; this script times them, and the 3×3 plane fit
(gvom_tpu_torch/csrc/planefit.cu) on the upstream maps, against the same
sources of the checkout at DIR (unpack the parent commit there with git
archive, built by scripts/tree_timing.py) in turns (parent, this tree, this
tree, parent), each launch alone, ten captured in a CUDA graph
(chip_smoke.graph_ms), and prints the compiler's registers and spills of
each form, this tree's and the parent's:

  * the epilogue on one upstream scan's sums (256×256×64, an OS1-128 sweep)
    at eigen (xy, z) = (1, 9), (8, 1), (5, 8), mask off and mask on, on the
    full grid and on the quarter slab that holds the window seam, with the
    kernel that takes each (kernels.epilogue_route); a source without the
    workspace argument, or without the `rest` pointer of channels 1-9, is
    called by its own signature;
  * the epilogue with the mask on at the boxes of THRESHOLD_BOXES, full
    grid, built twice: with every such box on the direct kernel and with
    every box on the separable passes (BOX_DIRECT_MAX set to 2^30 and 0),
    in turns direct, passes, passes, direct; the passes held bitwise
    against the plain version, the direct kernel's n too. Where the direct
    kernel stops winning sets BOX_DIRECT_MAX;
  * K4 at buffer_size 17 (256×256×64) and at z_size 320 (B = 4), on the
    state of the Gvom facade after two upstream scans (as chip_smoke.py's
    phase1_wide_configs) and with its ring buffer full (B + 1 scans, the 8
    scans taken in turn), each against chip_smoke.combine_bound;
  * the merge at z_size 320 (256×256×320) on a seeded world and
    contribution (chip_smoke.seeded_merge_inputs), full grid and the quarter
    slab y0 = 64, and on the contribution that the second of two batched
    steps of BATCH scans (the 8 scans repeated) merges into its live world,
    each timed call merging over the previous call's output, against
    chip_smoke.merge_bound;
  * the plane fit on the maps that the upstream facade's combine after two
    scans hands it and on those of a batched step of BATCH scans (the 8
    scans repeated), each against chip_smoke.plane_fit_bound, with its parts
    beside them in the same turns, each a variant build of this tree's
    kernel: the floor (an empty body, the same grid launched ten times a
    graph), the load and the window stores alone, and the fit without its
    tail; and the merge at 256×256×320 without its moment loads and with
    every moment loaded, whether the voxel needs it or not.

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
# the parts of the committed plane fit and merge that the diagnostic builds change
PLANE_FIT_BODY = r"plane_fit_kernel\([^{]*\{"   # the kernel's signature, up to its body
PLANE_FIT_STORES = r"    ihm\[i\] = ih;\n"   # its last window store
PLANE_FIT_TAIL = r"    fit_tail\(ok, err, a0n, a1n, im, rough \+ i, slope_x \+ i, slope_y \+ i\);"
MERGE_MOMENT_LOADS = (r"            ld2<PAIR>\(a\.mom \+ ch \* V, v, [^;]*;\n"
                      r"            ld2<PAIR>\(a\.omom \+ ch \* V, v, [^;]*;\n")
MERGE_Z = 320
PTXAS_ENTRIES = {"moments_epilogue": ("box_pass_z", "box_pass", "epilogue_direct_kernel"),
                 "combine": ("combine_any_kernel",), "merge_batch": ("merge_any_kernel",),
                 "plane_fit": ("plane_fit_kernel",)}


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


def recorded(kernels, name, fn, keep):
    """keep(*args) of the last call of kernels.<name> that fn() makes."""
    calls, wrapped = [], getattr(kernels, name)

    def record(*args):
        calls.append(keep(*args))
        return wrapped(*args)

    setattr(kernels, name, record)
    try:
        fn()
    finally:
        setattr(kernels, name, wrapped)
    return calls[-1]


def facade_maps(cfg, scans):
    """(hm_t, ihm_t, origin) that the Gvom facade's combine_maps hands the
    plane fit after two scans."""
    from gvom_tpu_torch import Gvom
    from gvom_tpu_torch.ops import kernels

    g = Gvom(config=cfg)

    def drive():
        for pad, m, e in scans[:2]:
            g.process_pointcloud(pad[m], e)
            g.combine_maps()

    return recorded(kernels, "plane_fit", drive, lambda cfg, *args: args)


def batch_steps(cfg, scans, dev, n):
    """A function that runs n batched steps of chip_smoke.BATCH scans (the
    scans repeated) from an empty world."""
    import chip_smoke
    from gvom_tpu_torch import make_batched_step
    from gvom_tpu_torch.types import empty_world_state

    scans_dev = chip_smoke.scans_on_device(scans, dev)
    batches = [chip_smoke.make_batch(scans_dev, chip_smoke.BATCH, i) for i in range(n)]
    step = make_batched_step(chip_smoke.batched_cfg(cfg, batches[0]))

    def run():
        world = empty_world_state(cfg, dev)
        for b in batches:
            world, _ = step(world, *b)

    return run


def batch_maps(cfg, scans, dev):
    """(hm_t, ihm_t, origin) that a batched step hands the plane fit."""
    from gvom_tpu_torch.ops import kernels

    return recorded(kernels, "plane_fit", batch_steps(cfg, scans, dev, 1), lambda cfg, *args: args)


def batch_merge_inputs(cfg, scans, dev):
    """(world, contrib, ego) that the second of two batched steps hands the
    merge (its contribution copied before the merge writes over it)."""
    import chip_smoke
    from gvom_tpu_torch.ops import kernels

    return recorded(kernels, "merge_batch", batch_steps(cfg, scans, dev, 2),
                    lambda cfg, world, contrib, ego, y0=0: (world, chip_smoke.copy_grid(contrib), ego.clone()))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, help="a checkout whose kernel sources are timed beside this tree's")
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
    from tree_timing import build, card, parent_build, ptxas, turns, variant_build

    dev = "cuda"
    reports = kernels.build_all(GvomConfig(buffer_size=17))
    parents = {k.name: parent_build(kernels, k, args.parent)
               for k in (kernels.XBOX, kernels.CMB, kernels.MERGE, kernels.PLANEFIT)}
    pepi, pcmb, pmerge, ppf = parents.values()
    parent_text = pepi.source.read_text()
    old_signature = "void* work" not in parent_text
    rest_apart = "const void* rest" in parent_text
    if not rest_apart:
        pepi.argtypes = pepi.argtypes[:1] + pepi.argtypes[2:]
    if old_signature:
        pepi.argtypes = pepi.argtypes[:-2] + pepi.argtypes[-1:]
    forced = {"direct": variant_build(kernels, kernels.XBOX, "epilogue_direct_all",
                                      [(BOX_DIRECT_MAX, "constexpr int BOX_DIRECT_MAX = 1 << 30;")]),
              "passes": variant_build(kernels, kernels.XBOX, "epilogue_passes_all",
                                      [(BOX_DIRECT_MAX, "constexpr int BOX_DIRECT_MAX = 0;")])}
    # the plane fit's parts, for where its time goes: the floor (no work, the same grid), the load and
    # the window stores alone, the fit without its tail; the merge without its moment loads
    parts = {"floor": variant_build(kernels, kernels.PLANEFIT, "plane_fit_floor",
                                    [(PLANE_FIT_BODY, r"\g<0>\n    return;")]),
             "load": variant_build(kernels, kernels.PLANEFIT, "plane_fit_load",
                                   [(PLANE_FIT_STORES, r"\g<0>    return;\n")]),
             "fit": variant_build(kernels, kernels.PLANEFIT, "plane_fit_no_tail",
                                  [(PLANE_FIT_TAIL, "    rough[i] = err;\n    slope_x[i] = a0n;\n"
                                                    "    slope_y[i] = ok ? a1n : im;")])}
    # the merge without its moment loads, and with every moment loaded (its result the same): what the
    # moments' sectors cost
    moment_loads = {"no moment loads": variant_build(
        kernels, kernels.MERGE, "merge_no_moment_loads",
        [(MERGE_MOMENT_LOADS, "            cm[ch][0] = cm[ch][1] = ov[ch][0] = ov[ch][1] = 0.0f;\n")]),
                    "every moment loaded": variant_build(
        kernels, kernels.MERGE, "merge_every_moment_loaded",
        [(MERGE_MOMENT_LOADS, "            ld2<PAIR>(a.mom + ch * V, v, q.in[0], q.in[1], cm[ch][0], cm[ch][1]);\n"
                              "            ld2<PAIR>(a.omom + ch * V, v, q.in[0], q.in[1], ov[ch][0], ov[ch][1]);\n")])}
    for name, report in zip(parents, build(*parents.values(), *forced.values(), *parts.values(),
                                           *moment_loads.values())):
        for tree, rep in (("this", reports[name]), ("parent", report)):
            for line in ptxas(rep, PTXAS_ENTRIES[name]):
                print(f"ptxas {name}, {tree}: {line}")

    cfg = GvomConfig()
    scans = chip_smoke.make_scans(cfg, SCANS, chip_smoke.LIDAR)
    pts, valid, ego = chip_smoke.scan_tensors(scans[0], dev)
    res = {"epilogue": {}, "box_direct_max": {}, "combine": {}, "merge": {}, "plane_fit": {}}
    for xye, ze in EIGEN_DISTS:
        c = dataclasses.replace(cfg, xy_eigen_dist=xye, z_eigen_dist=ze)
        X, Y, Z = c.grid_shape
        rx, ry, rz = binning.moment_pad(c)
        p, keep, origin, _ = kernels.prepare_points(c, pts[None], valid[None], ego[None], frame_ego=ego)
        Ys = Y // 4
        yw = ((int(origin[1]) % Y) // Ys * Ys, Ys)
        for where, window in (("full", None), (f"slab {yw}", yw)):
            bins = kernels.bin_points(c, p[0], keep[0], origin, window)
            ten = None if rest_apart else bins.sums    # a parent's epilogue reads the ten channels in one tensor
            ys0, ys = binning.check_y_window(c, window)
            for mask in (False, True):
                what = f"eigen ({xye}, {ze}) {where} mask {'on' if mask else 'off'}"
                route = kernels.epilogue_route(c, window, mask)

                def parent_run(bins=bins, ten=ten, ys0=ys0, ys=ys, mask=mask):
                    out = torch.empty((10, X, ys, Z), dtype=torch.float32, device=dev)
                    a = [*((kernels._ptr(bins.n), kernels._ptr(bins.rest)) if rest_apart else (kernels._ptr(ten),)),
                         kernels._ptr(bins.hit), kernels._ptr(origin), None,
                         X, Y, Z, rx, ry, rz, ys0, ys, int(mask), kernels._ptr(out)]
                    if not old_signature:
                        work = kernels._epilogue_workspace(pepi, X, Y, Z, rx, ry, rz, ys0, ys, mask, dev)
                        a.append(None if work is None else kernels._ptr(work))
                    pepi.launch(*a, kernels._stream())
                    return out

                def this_run(b=bins, w=window, m=mask):
                    return kernels.moments_epilogue(c, b.n, b.rest, b.hit, origin, w, m)

                diff = float((parent_run() - this_run()).abs().max())
                t = turns({"parent": parent_run, "this": this_run}, ("parent", "this", "this", "parent"), 20)
                res["epilogue"][what] = dict(t, route=route, parent_max_abs_diff=diff)
                print(f"epilogue {what} ({route}): " + ", ".join(f"{b} {v} ms" for b, v in t.items()), flush=True)
            del bins, ten
        torch.cuda.empty_cache()

    for xye, ze in THRESHOLD_BOXES:
        c = dataclasses.replace(cfg, xy_eigen_dist=xye, z_eigen_dist=ze)
        p, keep, origin, _ = kernels.prepare_points(c, pts[None], valid[None], ego[None], frame_ego=ego)
        bins = kernels.bin_points(c, p[0], keep[0], origin)
        fns = {name: swapped(kernels, "XBOX", k, lambda: kernels.moments_epilogue(c, bins.n, bins.rest, bins.hit, origin))
               for name, k in forced.items()}
        plain = moments.moments_epilogue_plain(c, bins.n, bins.rest, bins.hit, origin)
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
    # ---- the merge past 256 z: full grid and the quarter slab, and a batched step's ----
    c = dataclasses.replace(cfg, z_size=MERGE_Z)
    world, contrib, ego = chip_smoke.seeded_merge_inputs(c, dev, 200, (3, -2, 1), True)
    Y = c.xy_size
    cases = {"full": (0, world, contrib, ego),
             f"slab y0 = {Y // 4}": (Y // 4, *chip_smoke.merge_slab(world, contrib, Y // 4, Y // 4), ego),
             f"a {chip_smoke.BATCH}-scan batched step's": (0, *batch_merge_inputs(c, scans, dev))}
    for where, (y0, w, cb, e) in cases.items():
        nbytes, _ = chip_smoke.merge_bound(c, w, cb, y0)
        fns, order = {}, ("parent", "this", "this", "parent")
        trees = (("parent", pmerge), ("this", kernels.MERGE))
        if where == "full":   # and the two moment-load builds (where its time goes)
            trees += tuple(moment_loads.items())
            order = ("parent", "this", *moment_loads, *reversed(list(moment_loads)), "this", "parent")
        for tree, k in trees:
            timed = chip_smoke.copy_grid(cb)   # each timed call merges over the previous call's output
            fns[tree] = swapped(kernels, "MERGE", k, lambda t=timed: kernels.merge_batch(c, w, t, e, y0))
        t = turns(fns, order, 20)
        bound = 1e3 * nbytes / chip_smoke.HBM_BYTES_PER_S
        res["merge"][f"{c.xy_size}×{Y}×{MERGE_Z} {where}"] = dict(t, bound_ms=bound)
        print(f"merge at {c.xy_size}×{Y}×{MERGE_Z} {where}: " + ", ".join(f"{b} {v} ms" for b, v in t.items())
              + f", bound {bound} ms", flush=True)
        del fns
    del world, contrib, cases
    torch.cuda.empty_cache()

    # ---- the plane fit on the maps that a combine and a batched step hand it ----
    maps = {"the upstream combine's maps": facade_maps(cfg, scans),
            f"a {chip_smoke.BATCH}-scan batched step's maps": batch_maps(cfg, scans, dev)}
    for what, fit_in in maps.items():
        fns = {tree: swapped(kernels, "PLANEFIT", k, lambda f=fit_in: kernels.plane_fit(cfg, *f))
               for tree, k in (("parent", ppf), ("this", kernels.PLANEFIT), *parts.items())}
        t = turns(fns, ("floor", "load", "fit", "parent", "this", "this", "parent", "fit", "load", "floor"), 200)
        nbytes, ops_s = chip_smoke.plane_fit_bound(fit_in[0].numel())
        bound = 1e3 * max(nbytes / chip_smoke.HBM_BYTES_PER_S, ops_s)
        res["plane_fit"][what] = dict(t, bound_ms=bound)
        print(f"plane fit on {what}: " + ", ".join(f"{b} {v} ms" for b, v in t.items()) + f", bound {bound} ms",
              flush=True)
    smi = card()
    line = json.dumps({"wide_forms_ms": res, "device": smi})
    if args.out:
        Path(args.out).write_text(line + "\n")
    print(line)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
