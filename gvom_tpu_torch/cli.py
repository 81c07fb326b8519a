"""Command-line tools of the port (the counterpart of gvom_tpu/cli.py).

    python -m gvom_tpu_torch.cli replay --scans 32 --batch 8      # batched replay on the GPU
    python -m gvom_tpu_torch.cli replay --scans 16 --sequential   # facade replay (the live node's path)
    python -m gvom_tpu_torch.cli convert-bag drive.bag drive.npz  # rosbag -> .npz scan log, no ROS needed
    python -m gvom_tpu_torch.cli parity --scans 5                 # engine vs NumPy-oracle report
    python -m gvom_tpu_torch.cli selftest                         # CUDA kernels vs their plain versions

`replay` and `parity` run on the CUDA GPU unless `--device cpu` is passed;
`replay` prints one JSON line with its metrics and each kernel's launches,
`parity` the JAX package's per-combine report of agreement with the NumPy
oracle (gvom_tpu_torch.oracle). `selftest` needs the GPU: it holds every
kernel against its plain PyTorch version at the upstream shapes, prints one
JSON verdict line and exits non-zero on a mismatch or when there is no GPU.
The benchmark is a module of its own, `python -m gvom_tpu_torch.bench`.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _launches():
    from gvom_tpu_torch.ops import kernels

    return {k.name: k.launches for k in kernels.KERNELS if k.launches}


def cmd_replay(args):
    from gvom_tpu_torch.config import GvomConfig
    from gvom_tpu_torch.engine.replay import batched_replay, sequential_replay
    from gvom_tpu_torch.io.logio import synthesize_log
    from gvom_tpu_torch.types import resolve_device

    try:
        resolve_device(args.device)   # no GPU: refuse before the log is made
    except RuntimeError as e:
        print(f"replay: {e}", file=sys.stderr)
        return 2
    cfg = GvomConfig(xy_size=args.grid, z_size=args.grid_z, max_points=args.points)
    log = synthesize_log(args.scans, channels=args.channels, azimuth_steps=args.azimuth)
    if args.sequential:
        engine, outputs, metrics = sequential_replay(cfg, log, device=args.device)
        out = {"mode": "sequential", "scans": len(log)}
    else:
        world, products, metrics = batched_replay(cfg, log, batch_size=args.batch, device=args.device)
        out = {"mode": "batched", "scans": len(log), "batches": len(products)}
    print(json.dumps({**out, "device": args.device, "launches": _launches(), **metrics.snapshot()}, default=float))
    return 0


def cmd_convert_bag(args):
    from gvom_tpu_torch.io.logio import save_log
    from gvom_tpu_torch.io.rosbag import bag_to_scanlog

    tf = None
    if args.transform is not None:
        tf = np.loadtxt(args.transform).reshape(-1, 4)
    log = bag_to_scanlog(
        args.bag, cloud_topic=args.cloud_topic, odom_topic=args.odom_topic,
        transform=tf, max_scans=args.max_scans,
    )
    save_log(args.out, log)
    pts = [len(p) for p, _, _ in log]
    print(json.dumps({
        "bag": args.bag, "out": args.out, "scans": len(log),
        "points_min": min(pts) if pts else 0, "points_max": max(pts) if pts else 0,
    }))
    return 0


def cmd_parity(args):
    """Replay a synthetic drive through the port's ingest_and_insert and
    combine and through the NumPy oracle, and print the JAX package's report
    of their agreement after each combine (gvom_tpu/cli.py cmd_parity)."""
    import torch

    from gvom_tpu_torch.config import GvomConfig
    from gvom_tpu_torch.io.logio import synthesize_log
    from gvom_tpu_torch.io.synthetic import nudge_off_grid, pad_scan
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.oracle import NumpyOracle
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state, resolve_device
    from gvom_tpu_torch.utils.parity import singular_fit_mask

    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        print(f"parity: {e}", file=sys.stderr)
        return 2
    cfg = GvomConfig(xy_size=args.grid, z_size=args.grid_z, max_points=args.points, buffer_size=3)
    log = synthesize_log(args.scans, channels=args.channels, azimuth_steps=args.azimuth, max_range=25.0)
    oracle = NumpyOracle(cfg)
    buf = empty_buffer_state(cfg, dev)
    world = empty_world_state(cfg, dev)
    report = []
    for pts, ego, _ in log:
        pts = nudge_off_grid(pts, cfg.xy_resolution, cfg.z_resolution)
        oracle.process_pointcloud(pts, ego)
        o_out = oracle.combine_maps()
        pad, mask = pad_scan(pts, cfg.max_points)
        e = torch.tensor(np.float32(ego), device=dev)
        buf, _ = pipeline.ingest_and_insert(cfg, buf, torch.from_numpy(pad).to(dev), torch.from_numpy(mask).to(dev), e)
        world, products, _ = pipeline.combine(cfg, buf, world, e)
        _, o_pos, o_neg, o_rough, o_vis = o_out
        pos = products.positive_obstacle.cpu().numpy()
        # (near-)singular 3x3 plane fits are left out: their det != 0 guard
        # keys off f32-vs-f64 rounding noise; the raw_* fields include them
        ok = ~singular_fit_mask(oracle.height_map, cfg.xy_resolution)
        rough = products.roughness.cpu().numpy()
        rdef = ok & (o_rough > -1) & (rough > -1)
        report.append({
            "vis_equal": bool(np.array_equal(products.visibility.cpu().numpy(), o_vis)),
            "neg_equal": bool(np.array_equal(products.negative_obstacle.cpu().numpy(), o_neg)),
            "pos_mismatch_frac": float((pos != o_pos)[ok].mean()),
            "pos_max_diff": int(np.abs(pos - o_pos)[ok].max()),
            "rough_max_diff_defined": float(np.abs(rough - o_rough)[rdef].max() if rdef.any() else 0.0),
            "height_max_diff": float(np.abs(products.height.cpu().numpy() - oracle.height_map).max()),
            "singular_fit_frac": float((~ok).mean()),
            "raw_pos_mismatch_frac": float((pos != o_pos).mean()),
            "raw_pos_max_diff": int(np.abs(pos - o_pos).max()),
        })
    print(json.dumps({"config": {"grid": args.grid, "scans": args.scans}, "per_combine": report}, indent=2))
    return 0


def _selftest_checks(cfg, scan, ego_np, Ys, checks):
    """Every kernel against its plain version on one scan on the card: the
    point preparation, K1, K2, K5 (mask on and off) on the full grid and on
    the quarter slab that holds the window seam, K3 into a ring-buffer
    slot."""
    import torch

    from gvom_tpu_torch.ops import binning, kernels, moments, raycast
    from gvom_tpu_torch.utils.compare import bitwise, exact, moments_close, sums_close

    dev = torch.device("cuda")
    pts, valid = (torch.from_numpy(a).to(dev) for a in scan)
    ego = torch.tensor(ego_np, dtype=torch.float32, device=dev)
    prep = kernels.prepare_points(cfg, pts[None], valid[None], ego[None], frame_ego=ego)
    for name, a, b in zip(("p", "keep", "origin", "scan_ok"), prep,
                          binning.prepare_plain(cfg, pts[None], valid[None], ego[None], frame_ego=ego)):
        bitwise(f"prepare {name}", a, b)
    p, keep, origin = prep[0][0], prep[1][0], prep[2]
    m = raycast.march_inputs(cfg, p, keep, ego, origin)
    seam = int(origin[1]) % cfg.xy_size // Ys * Ys
    X, Y, Z = cfg.grid_shape

    def keep_max(name, err):
        checks[name] = max(checks.get(name, 0.0), err)

    for yw, tag in ((None, ""), ((seam, Ys), "_slab")):
        exact(f"K1{tag}", raycast.ray_pass_counts(cfg, p, keep, ego, origin, y_window=yw),
              raycast.ray_pass_counts_plain(cfg, m, origin, yw))
        kb, pb = kernels.bin_points(cfg, p, keep, origin, yw), binning.bin_points(cfg, p, keep, origin, yw)
        exact(f"K2{tag} hit", kb.hit, pb.hit)
        exact(f"K2{tag} min_height", kb.min_height, pb.min_height)
        keep_max(f"bin_points{tag}_max_abs_err", sums_close(f"K2{tag}", kb.sums, pb.sums))
        for mask in (True, False):
            km = kernels.moments_epilogue(cfg, kb.sums, kb.hit, origin, yw, mask)
            pm = moments.moments_epilogue_plain(cfg, kb.sums, kb.hit, origin, yw, mask)
            keep_max(f"moments_epilogue{tag}_max_abs_err", moments_close(f"K5{tag} mask={mask}", km, pm))
        if yw is None:
            slot = torch.zeros((1,), dtype=torch.int32, device=dev)
            ko = torch.zeros((1, 10, X, Y, Z), dtype=torch.float32, device=dev)
            po = torch.zeros_like(ko)
            kernels.ingest_epilogue(cfg, kb.sums, kb.hit, origin, ko, slot)
            moments.ingest_epilogue_plain(cfg, kb.sums, kb.hit, origin, po, slot)
            keep_max("ingest_epilogue_max_abs_err", moments_close("K3", ko[0], po[0]))


def cmd_selftest(args):
    """The compiled CUDA kernels against their plain PyTorch versions on the
    card, at the upstream shapes (the counterpart of the JAX package's
    compiled-Pallas-vs-XLA selftest): the point preparation, pass counts,
    hit, min_height, n, every combine output, the 2-D maps (the plane fit
    with the window layout, its tail alone, the guess height with the
    obstacle maps and the visibility) and the batched merge (its moments
    too) bitwise, the other moment channels within
    compare.MOM_RTOL / MOM_ATOL. One JSON verdict line; exit 1 on a
    mismatch, 2 without a GPU."""
    import torch

    if not torch.cuda.is_available():
        print("selftest: no CUDA device is available; the kernels run only on the GPU, so nothing was checked",
              file=sys.stderr)
        return 2
    from gvom_tpu_torch.config import GvomConfig
    from gvom_tpu_torch.io import synthetic
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import kernels, maps2d
    from gvom_tpu_torch.parallel.sharding import merge_and_columns_plain
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state
    from gvom_tpu_torch.utils.compare import Failed, bitwise, check, exact

    cfg = GvomConfig(xy_size=args.grid, z_size=args.grid_z, max_points=args.points, buffer_size=4)
    kernels.build_all(cfg)
    kernels.reset_launches()
    dev = torch.device("cuda")
    terrain = synthetic.composite_terrain()
    checks, error = {}, None
    buf, world = empty_buffer_state(cfg, dev), empty_world_state(cfg, dev)
    try:
        for seed in range(max(args.scans, cfg.buffer_size + 1)):
            ego = np.array([0.5 + 0.45 * seed, 0.25 * seed, 1.6])
            pts = synthetic.simulate_lidar_scan(terrain, ego, channels=64, azimuth_steps=max(64, args.points // 64),
                                                max_range=60.0, seed=seed)
            pad, mask = synthetic.pad_scan(synthetic.nudge_off_grid(pts, cfg.xy_resolution, cfg.z_resolution),
                                           cfg.max_points)
            if seed < args.scans:
                _selftest_checks(cfg, (pad, mask), ego, max(1, cfg.xy_size // 4), checks)
            e = torch.tensor(ego, dtype=torch.float32, device=dev)
            buf, _ = pipeline.ingest_and_insert(cfg, buf, torch.from_numpy(pad).to(dev),
                                                torch.from_numpy(mask).to(dev), e)
            if seed >= cfg.buffer_size - 1:
                # K4 against fuse_plain: every output bitwise, the moments too
                target = buf.grids.origin.index_select(0, buf.last_slot.reshape(1).long())[0]
                ko = kernels.combine(cfg, buf, world, target, e)
                for i, (a, b) in enumerate(zip(ko, pipeline.fuse_plain(cfg, buf, world, target, e))):
                    exact(f"K4 output {i} after scan {seed}", a, b)
                world, products, ok = pipeline.combine(cfg, buf, world, e)
                check(bool(ok), f"combine after scan {seed} reports an empty buffer")
                # the batched merge of this scan's grid into the new world, bit for bit
                contrib, _ = pipeline.ingest_scan(cfg, torch.from_numpy(pad).to(dev), torch.from_numpy(mask).to(dev),
                                                  e)
                ref = merge_and_columns_plain(cfg, world, contrib, e)
                got = kernels.merge_batch(cfg, world, contrib, e)
                for name in ("hit", "miss", "min_height", "mom"):
                    bitwise(f"merge {name} after scan {seed}", getattr(got[0], name), getattr(ref[0], name))
                for name, a, b in zip(("evidence", "column maps", "band sums"), got[1:], ref[1:]):
                    bitwise(f"merge {name} after scan {seed}", a, b)
                # the 2-D maps on K4's column maps, bit for bit: the plane fit
                # (from the torus-layout maps), then the guess height and its epilogue
                fit_in = (ko[5], ko[6], target)
                fitted = kernels.plane_fit(cfg, *fit_in)
                for name, a, b in zip(("height", "inferred height", "roughness", "slope_x", "slope_y"), fitted,
                                      maps2d.plane_fit_window_plain(cfg, *fit_in)):
                    bitwise(f"plane fit {name} after scan {seed}", a, b)
                hm = products.height
                guess_in = (hm, products.inferred_height, products.slope_x, products.slope_y, ko[7], ko[8], ko[9],
                            target)
                for name, a, b in zip(("guessed height delta", "positive", "negative", "visibility"),
                                      kernels.guess_height(cfg, *guess_in), maps2d.guess_products_plain(cfg, *guess_in)):
                    bitwise(f"guess height {name} after scan {seed}", a, b)
                # and the fit's tail alone (its own entry) on this fit's inputs
                fit = maps2d.plane_fit_inputs(cfg, hm)
                for name, a, b in zip(("roughness", "slope_x", "slope_y"), kernels.plane_fit_tail(*fit),
                                      maps2d.plane_fit_tail_plain(*fit)):
                    bitwise(f"plane fit tail {name} after scan {seed}", a, b)
    except Failed as exc:
        error = str(exc)
    verdict = {
        "selftest": "cuda_vs_plain",
        "device": torch.cuda.get_device_name(0),
        "grid": [args.grid, args.grid, args.grid_z],
        "points": args.points,
        "scans": args.scans,
        "ok": error is None,
        "error": error,
        "launches": _launches(),
        "checks": checks,
    }
    print(json.dumps(verdict))
    return 0 if error is None else 1


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="gvom_tpu_torch",
        description="gvom_tpu_torch tools. The benchmark is `python -m gvom_tpu_torch.bench`.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    rp = sub.add_parser("replay", help="replay a synthetic drive")
    rp.add_argument("--scans", type=int, default=16)
    rp.add_argument("--batch", type=int, default=8)
    rp.add_argument("--sequential", action="store_true")
    rp.add_argument("--grid", type=int, default=128)
    rp.add_argument("--grid-z", type=int, default=64)
    rp.add_argument("--points", type=int, default=65536)
    rp.add_argument("--channels", type=int, default=64)
    rp.add_argument("--azimuth", type=int, default=1024)
    rp.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    rp.set_defaults(fn=cmd_replay)

    cb = sub.add_parser("convert-bag", help="rosbag → .npz ScanLog (no ROS needed)")
    cb.add_argument("bag")
    cb.add_argument("out")
    cb.add_argument("--cloud-topic", default=None)
    cb.add_argument("--odom-topic", default=None)
    cb.add_argument("--max-scans", type=int, default=None)
    cb.add_argument("--transform", default=None,
                    help="optional 3x4/4x4 sensor→odom matrix file (np.loadtxt)")
    cb.set_defaults(fn=cmd_convert_bag)

    pp = sub.add_parser("parity", help="engine vs oracle parity report")
    pp.add_argument("--scans", type=int, default=5)
    pp.add_argument("--grid", type=int, default=64)
    pp.add_argument("--grid-z", type=int, default=32)
    pp.add_argument("--points", type=int, default=8192)
    pp.add_argument("--channels", type=int, default=32)
    pp.add_argument("--azimuth", type=int, default=64)
    pp.add_argument("--device", default="cuda", help="cuda (default) or cpu (the plain versions)")
    pp.set_defaults(fn=cmd_parity)

    st = sub.add_parser("selftest", help="CUDA kernels against their plain versions on the GPU")
    st.add_argument("--grid", type=int, default=256)
    st.add_argument("--grid-z", type=int, default=64)
    st.add_argument("--points", type=int, default=131072)
    st.add_argument("--scans", type=int, default=2)
    st.set_defaults(fn=cmd_selftest)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
