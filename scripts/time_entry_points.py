#!/usr/bin/env python3
"""Device time of the port's public per-scan entry points, and of each of
its kernels' launches beside the kernel's bound, on one NVIDIA GPU.

    python3 scripts/time_entry_points.py [--root DIR] [--reps N] [--batch-cache FILE.npz]

Imports gvom_tpu_torch from DIR (default: this checkout; tree_timing.use_root),
so that two commits unpacked side by side can be timed in one call, each by
its own code; the timers and the bounds are this checkout's
(scripts/tree_timing.py, benchmark/roofline.py). At the upstream deployment
(GvomConfig(): 256×256×64, 131,072 points of a synthetic OS1-128 scan) it
times, with CUDA events, the mean of N warm calls of:

  raycast.ray_pass_counts      the whole raycast of the scan, from its points
  raycast.ray_pass_counts(y_window=)   the same for the quarter slab that
                                       holds the window seam
  pipeline.ingest_scan         prepare, raycast, binning, moments
  pipeline.ingest_scan(y_window=)      the same for that slab
  pipeline.combine             the combine of a ring buffer that holds the
                               scan (B = 4), with the device work it
                               launches counted by torch.profiler over one
                               warm call (kernels, copies and fills), and
                               its float64 launches among them
  the batched step             make_batched_step on a 32-scan batch into the
                               live world of a first step, also on the host
                               clock (synchronized), with its launches and
                               float64 launches counted the same way

and, on the host clock, the Gvom facade's combine_maps (median of 20 warm
calls). Then each kernel at the shapes of its path, as a row: `ms`, what
the card takes for its launches alone (tree_timing.graph_ms: fills and
small launches included, the host's pace left out); `wrapper_ms`, its
wrapper called back to back as the host paces it (tree_timing.cuda_ms);
`bound_ms`, the least time of what this data needs (benchmark/roofline.py,
or tree_timing's bounds where roofline.py has none), and `share`,
bound_ms / ms. K1's and K2's rows also give `atomic_floor_ms`: one int32
atomic a pass (K1), tree_timing.k2_atomic_floor_ms (K2), at the rates of
the probe csrc/atomic_rate.cu. The rows:

  prepare_scan, prepare_batch     the point preparation of the scan, and of
                                  the batch with the dead-scan mask
  K1_scan, K1_slab, K1_batch      the raycast of the scan, of its seam slab,
                                  and of the batch in one launch
  K2_scan, K2_slab, K2_batch      binning, each on a scratch kept across its
                                  calls, as the ring buffer and the batched
                                  step keep one; the batch's merged points
  K3_scan                         the epilogue into a ring-buffer slot
  K5_batch_mask_off               the epilogue of the batch's sums
  K5_<lap>_mask_off, K5_<lap>_mask_on, K5_<lap>_targets   the epilogue
                                  of a batch of the benchmark's lap
                                  (tree_timing.lap_batch; LAPS: lap, the
                                  64 scans of os1_128.replay64; lap32 and
                                  lap32_os1_64, the 32 of the batch-32
                                  cells) with the mask off, on, and in
                                  targets only (the one-rank batched
                                  step's form, tree_timing.targets_bound),
                                  which is timed only in this checkout
  K5_slab_mask_on                 the slab epilogue (ingest_scan's)
  K2_then_K3_scan, K2_then_K5_batch   the pairs (tree_timing.pair_bound)
  K4_combine                      the combine's launch alone
                                  (kernels.combine_launch); its wrapper
                                  kernels.combine
  merge_batch                     the merge of the batch's contribution into
                                  the first step's live world, as the step
                                  calls it, each timed call over the
                                  previous call's output
  plane_fit, guess_height, maps_chain   the two stencils on the combine's
                                  maps, and the two as the combine launches
                                  them

The batch is 8 synthetic scans made in worker processes, repeated to 32
with moving egos (tree_timing.batch_points, make_batch); --batch-cache
keeps its points in a file, written when it is missing. Prints a line a
row, one JSON line, then the card's name and power limit.
"""

import argparse
import functools
import json
import math
import statistics
import sys
import time

import tree_timing as tt

# the lap's batches of the K5 rows: (tag, configuration, scans), each a batch of its cell's replay
LAPS = (("lap", "os1_128", (128, 192)), ("lap32", "os1_128", (128, 160)), ("lap32_os1_64", "os1_64", (128, 160)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(tt.ROOT), help="checkout whose gvom_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--batch-cache", help="npz file of the batch's eight distinct scans (read, or written if missing)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_entry_points: no CUDA device is available", file=sys.stderr)
        return 2
    root = tt.use_root(args.root)
    from benchmark.reference.grid import torus_to_window
    from gvom_tpu_torch import Gvom, GvomConfig, make_batched_step
    from gvom_tpu_torch.io import synthetic
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import binning, kernels, raycast
    from gvom_tpu_torch.ops import grid as gridops
    from gvom_tpu_torch.parallel.sharding import prepare_batch
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state
    from torch.profiler import ProfilerActivity, profile

    dev = torch.device("cuda")
    cfg = GvomConfig()
    ego_np = (0.3, -0.2, 1.5)
    pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego_np, seed=0, **tt.LIDAR)
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    pts, valid = torch.from_numpy(pad).to(dev), torch.from_numpy(mask).to(dev)
    ego = torch.tensor(ego_np, dtype=torch.float32, device=dev)
    p, keep = binning.prepare_points(cfg, pts, valid, ego)
    origin = gridops.compute_origin(cfg, ego)
    X, Y, Z = cfg.grid_shape
    Ys = Y // 4
    yw = ((int(origin[1]) % Y) // Ys * Ys, Ys)

    out = dict(root=str(root), y_window=list(yw), reps=args.reps)
    calls = {
        "ray_pass_counts": lambda: raycast.ray_pass_counts(cfg, p, keep, ego, origin),
        "ray_pass_counts_slab": lambda: raycast.ray_pass_counts(cfg, p, keep, ego, origin, y_window=yw),
        "ingest_scan": lambda: pipeline.ingest_scan(cfg, pts, valid, ego),
        "ingest_scan_slab": lambda: pipeline.ingest_scan(cfg, pts, valid, ego, y_window=yw),
    }
    for name, fn in calls.items():
        out[name + "_ms"] = tt.cuda_ms(fn, args.reps)

    # ---- the combine: its device time and the device work it launches ----
    kernels.build_all()
    buf, _ = pipeline.ingest_and_insert(cfg, empty_buffer_state(cfg, dev), pts, valid, ego)
    world = empty_world_state(cfg, dev)
    out["combine_ms"] = tt.cuda_ms(lambda: pipeline.combine(cfg, buf, world, ego), 10)

    def count_launches(fn):
        """(launches, float64 launches: PyTorch's kernels whose name names
        double) of one warm call, by torch.profiler."""
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kern = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        return len(kern), sum("double" in ev.name for ev in kern)

    out["combine_launches"], out["combine_f64_launches"] = count_launches(
        lambda: pipeline.combine(cfg, buf, world, ego))
    target = buf.grids.origin.index_select(0, buf.last_slot.reshape(1).long())[0]
    k4_launch, k4_out = kernels.combine_launch(cfg, buf, world, target, ego)
    k4_launch()
    _, products, _ = pipeline.combine(cfg, buf, world, ego)
    hm, ihm = products.height.contiguous(), products.inferred_height.contiguous()
    sx, sy = products.slope_x.contiguous(), products.slope_y.contiguous()
    hm_t, ihm_t, pnum, pden, bok = k4_out[5:10]

    def maps_chain():
        w, iw, _, fx, fy = kernels.plane_fit(cfg, hm_t, ihm_t, target)
        return kernels.guess_height(cfg, w, iw, fx, fy, pnum, pden, bok, target)

    # ---- combine_maps on the facade, on the host clock ----
    g = Gvom(config=cfg)
    g.process_pointcloud(pad[mask], ego_np)
    host = []
    for _ in range(23):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g.combine_maps()
        host.append(1e3 * (time.perf_counter() - t0))
    out["combine_maps_host_ms_median"] = statistics.median(host[3:])
    del g

    # ---- the inputs of each kernel's row ----
    V, Vs, cells = X * Y * Z, X * Ys * Z, hm.numel()
    bp, bv, be = (torch.from_numpy(a).to(dev) for a in tt.batch_points(root, cfg, args.batch_cache))
    batch = tt.make_batch(bp, bv, be)
    S, NB = batch[1].shape
    borigin, bpw, bkeep = prepare_batch(cfg, *batch)
    scratches = {}

    def k2(q, k, o, w=None):
        """K2 on the scratch that this shape keeps across its calls."""
        key = (id(q), w)
        if key not in scratches:
            scratches[key] = binning.moment_scratch(cfg, dev, w)
        return kernels.bin_points(cfg, q, k, o, w, scratches[key])

    laps = {}
    for tag, config, scans in LAPS:
        lcfg, lorigin, lpw, lkeep = tt.lap_batch(config, scans, dev)
        lbins = kernels.bin_points(lcfg, lpw, lkeep, lorigin, scratch=binning.moment_scratch(lcfg, dev))
        laps[tag] = (lcfg, lorigin, lbins, torus_to_window(lbins.hit > 0, lorigin))
        del lpw, lkeep
    p1, k1, e1 = p[None], keep[None], ego.reshape(1, 3)
    bp3, bk3 = bpw.view(S, NB, 3), bkeep.view(S, NB)
    N, n_kept, n_kept_b = p.shape[0], int(keep.sum()), int(bkeep.sum())
    n_pass = int(kernels.ray_pass_counts(cfg, p1, k1, e1, origin).sum())
    n_pass_s = int(kernels.ray_pass_counts(cfg, p1, k1, e1, origin, y_window=yw).sum())
    n_pass_b = int(kernels.ray_pass_counts(cfg, bp3, bk3, batch[2], borigin).sum())
    scan_bins, slab_bins, batch_bins = k2(p, keep, origin), k2(p, keep, origin, yw), k2(bpw, bkeep, borigin)
    ring = torch.empty((2, 10, X, Y, Z), dtype=torch.float32, device=dev)
    slot = torch.ones((1,), dtype=torch.int32, device=dev)
    in_slab = torch.zeros((Y,), dtype=torch.bool, device=dev)
    in_slab[yw[0]:yw[0] + Ys] = True
    k3_bound = tt.epilogue_bound(cfg, scan_bins.n[0], torus_to_window(scan_bins.hit > 0, origin), V, True)
    k5_bound = tt.epilogue_bound(cfg, batch_bins.n[0], torch.ones((X, Y, Z), dtype=torch.bool, device=dev), V, False)
    k5_slab_bound = tt.epilogue_bound(cfg, scan_bins.n[0], torus_to_window(
        (scan_bins.hit > 0) & in_slab[None, :, None], origin), Vs, True)

    def k2_bound_of(b, n_points, kept, n_out):
        return tt.k2_bound(n_points, kept, n_out, b.n.numel(), int((b.n > 0).sum()))

    def k2_k3():
        b = k2(p, keep, origin)
        kernels.ingest_epilogue(cfg, b.n, b.rest, b.hit, origin, ring, slot)

    def k2_k5():
        b = k2(bpw, bkeep, borigin)
        return kernels.moments_epilogue(cfg, b.n, b.rest, b.hit, borigin, occupancy_mask=False)

    # ---- the batched step: the batch into the live world of a first step ----
    step = make_batched_step(cfg)
    live, _ = step(empty_world_state(cfg, dev), *tt.make_batch(bp, bv, be, step_index=0))
    out["batched_step_ms"] = tt.cuda_ms(lambda: step(live, *batch), 10)
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(live, *batch)
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    out["batched_step_host_ms_median"] = statistics.median(host)
    out["batched_step_launches"], out["batched_step_f64_launches"] = count_launches(lambda: step(live, *batch))
    mcfg, mworld, mcontrib, mego, _ = tt.recorded(
        kernels, "merge_batch", lambda: step(live, *batch),
        lambda c, w, contrib, e, y0=0: (c, w, tt.copy_grid(contrib), e.clone(), y0))
    timed = tt.copy_grid(mcontrib)    # each timed call merges over the previous call's output
    del live

    # name: (the launches, the wrapper where it is another call, (bytes, seconds of operations) or bound_ms)
    rows = {
        "prepare_scan": (lambda: kernels.prepare_points(cfg, pts[None], valid[None], ego[None], frame_ego=ego), None,
                         tt.prep_bound(N, 1)),
        "prepare_batch": (lambda: kernels.prepare_points(cfg, *batch, frame_ego=batch[2][-1], drop_dead=True), None,
                          tt.prep_bound(S * NB, S)),
        "K1_scan": (lambda: kernels.ray_pass_counts(cfg, p1, k1, e1, origin), None,
                    tt.k1_bound(N, 1, n_kept, n_pass, V)),
        "K1_slab": (lambda: kernels.ray_pass_counts(cfg, p1, k1, e1, origin, y_window=yw), None,
                    tt.k1_bound(N, 1, n_kept, n_pass_s, Vs)),
        "K1_batch": (lambda: kernels.ray_pass_counts(cfg, bp3, bk3, batch[2], borigin), None,
                     tt.k1_bound(S * NB, S, n_kept_b, n_pass_b, V)),
        "K2_scan": (lambda: k2(p, keep, origin), None, k2_bound_of(scan_bins, N, n_kept, V)),
        "K2_slab": (lambda: k2(p, keep, origin, yw), None, k2_bound_of(slab_bins, N, n_kept, Vs)),
        "K2_batch": (lambda: k2(bpw, bkeep, borigin), None, k2_bound_of(batch_bins, S * NB, n_kept_b, V)),
        "K3_scan": (lambda: kernels.ingest_epilogue(cfg, scan_bins.n, scan_bins.rest, scan_bins.hit, origin, ring,
                                                    slot), None, k3_bound),
        "K5_batch_mask_off": (lambda: kernels.moments_epilogue(cfg, batch_bins.n, batch_bins.rest, batch_bins.hit,
                                                               borigin, occupancy_mask=False), None, k5_bound),
        "K5_slab_mask_on": (lambda: kernels.moments_epilogue(cfg, slab_bins.n, slab_bins.rest, slab_bins.hit, origin,
                                                             yw), None, k5_slab_bound),
        "K2_then_K3_scan": (k2_k3, None, tt.pair_bound(N, n_kept, V, k3_bound[1])),
        "K2_then_K5_batch": (k2_k5, None, tt.pair_bound(S * NB, n_kept_b, V, k5_bound[1])),
        "K4_combine": (k4_launch, lambda: kernels.combine(cfg, buf, world, target, ego),
                       tt.combine_bound(cfg, buf, world, target, k4_out[0])),
        "merge_batch": (lambda: kernels.merge_batch(mcfg, mworld, timed, mego), None,
                        tt.merge_bound(mcfg, mworld, mcontrib)),
        "plane_fit": (lambda: kernels.plane_fit(cfg, hm_t, ihm_t, target), None, tt.plane_fit_bound(cells)),
        "guess_height": (lambda: kernels.guess_height(cfg, hm, ihm, sx, sy, pnum, pden, bok, target), None,
                         tt.guess_bound(cells)),
        "maps_chain": (maps_chain, None, tt.bound_ms(*tt.plane_fit_bound(cells)) + tt.bound_ms(
            *tt.guess_bound(cells))),
    }
    rates = tt.atomic_rates(kernels, dev)
    floors = {"K1_scan": 1e3 * n_pass / rates["int32"], "K1_slab": 1e3 * n_pass_s / rates["int32"],
              "K1_batch": 1e3 * n_pass_b / rates["int32"]}
    for name, b in (("K2_scan", scan_bins), ("K2_slab", slab_bins), ("K2_batch", batch_bins)):
        floors[name] = tt.k2_atomic_floor_ms(int(b.hit.sum()), int(b.n.sum()), rates)
    for tag, (lcfg, lorigin, lbins, occ) in laps.items():
        n_out = math.prod(lcfg.grid_shape)
        form = functools.partial(kernels.moments_epilogue, lcfg, lbins.n, lbins.rest, lbins.hit, lorigin, None)
        rows[f"K5_{tag}_mask_off"] = (functools.partial(form, False), None,
                                      tt.epilogue_bound(lcfg, lbins.n[0], torch.ones_like(occ), n_out, False))
        rows[f"K5_{tag}_mask_on"] = (functools.partial(form, True), None,
                                     tt.epilogue_bound(lcfg, lbins.n[0], occ, n_out, True))
        if root == tt.ROOT:    # this checkout's mode: the parent's row to read it against is the mask on
            rows[f"K5_{tag}_targets"] = (functools.partial(form, "targets"), None,
                                         tt.targets_bound(lcfg, lbins.n[0], occ, n_out))
    out.update(batch_points=S * NB, lap_hit_voxels={tag: int(lap[3].sum()) for tag, lap in laps.items()},
               atomic_rates_per_s=rates, kernels={})
    for name, (fn, wrapper, bound) in rows.items():
        b_ms = bound if isinstance(bound, float) else tt.bound_ms(*bound)
        ms = tt.graph_ms(fn, args.reps)
        r = dict(ms=ms, wrapper_ms=tt.cuda_ms(wrapper or fn, args.reps, warm=5), bound_ms=b_ms, share=b_ms / ms)
        if name in floors:
            r["atomic_floor_ms"] = floors[name]
        out["kernels"][name] = r
        print(f"{name}: launch alone {ms:.5f} ms, wrapper {r['wrapper_ms']:.5f} ms, bound {b_ms:.5f} ms, "
              f"{100 * r['share']:.1f} % of it" + (f", atomic floor {floors[name]:.5f} ms" if name in floors else ""),
              flush=True)
    print(json.dumps(out))
    print(tt.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
