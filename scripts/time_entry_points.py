#!/usr/bin/env python3
"""Device time of the port's public per-scan entry points and of its
kernels' launches, on one NVIDIA GPU.

    python3 scripts/time_entry_points.py [--root DIR] [--reps N] [--batch-cache FILE.npz]

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
  pipeline.combine             the combine of a ring buffer that holds the
                               scan (B = 4), with the device work it
                               launches counted by torch.profiler over one
                               warm call (kernels, copies and fills), and
                               its float64 launches among them
  the batched step             make_batched_step on the 32-scan batch below
                               into the live world of a first step, also on
                               the host clock (synchronized), with its
                               launches and float64 launches counted the
                               same way

and, as the card runs them alone (the launches of GRAPH_CALLS calls captured
once in a CUDA graph and replayed: fills and small launches included, the
host's pace left out), each kernel wrapper of ops/kernels.py at the shapes
of its path: the point preparation of the scan and of the batch (with the
dead-scan mask), where the commit has it; K1 on the scan and on the slab; K2
on the scan, on the slab and on a batch's merged points; K3 into a
ring-buffer slot; K5 with the mask off on the batch's sums; the slab
epilogue (mask on); the pairs K2 then K3 (the scan) and K2 then K5 (the
batch); K4 on the ring buffer that holds the scan (its launch alone,
kernels.combine_launch); on that combine's maps the plane fit, the guess
height, and the 2-D chain after K4 as the commit launches it (maps_chain:
the maps' tail's two entries around the two stencils where the commit has
them, else the plane fit and the guess height that took the tail over);
and, on the host clock, the Gvom facade's combine_maps (median of 20 warm
calls). The preparations, the chain and the stencils are also timed as
their wrappers called back to back (wrapper_ms). Each epilogue takes its own commit's K2 sums. The batch is
chip_smoke.py's second batched step: 8 scans made in worker processes,
repeated to 32 with moving egos; --batch-cache keeps its points in a file,
written when it is missing.

These signatures are the same since the slab forms came in, whatever each
commit builds inside them, but for K2's points and sums: a commit with
kernels.prepare_points gives K2 world-frame points, an older one the
map-local coordinates (grid.map_local); a commit with
binning.moment_scratch keeps channels 1-9 of K2's sums in a scratch kept
across the calls of one shape, and its epilogues take n and that scratch's
channels, an older one's the ten channels in one tensor. Prints one JSON line, then the
card's name and power limit.
"""

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

LIDAR = dict(channels=128, azimuth_steps=2048)
BATCH, DISTINCT = 32, 8
GRAPH_CALLS = 10


def _scan(job):
    """(points [max_points,3] f32, valid) of chip_smoke.py's scan i."""
    root, i, ego, max_points = job
    sys.path.insert(0, root)
    from gvom_tpu_torch.io import synthetic

    return synthetic.pad_scan(synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego, seed=i, **LIDAR),
                              max_points)


def batch_points(root, cfg, cache):
    """(points [8,N,3], valid [8,N], egos [8,3]) numpy: chip_smoke.py's eight
    distinct scans, loaded from or written to `cache`."""
    import numpy as np

    if cache and os.path.exists(cache):
        z = np.load(cache)
        return z["points"], z["valid"], z["egos"]
    egos = [(0.3 + 1.3 * i, -0.2 + 0.7 * i, 1.5 + 0.02 * i) for i in range(DISTINCT)]
    with ProcessPoolExecutor(max_workers=min(DISTINCT, os.cpu_count() or 1), mp_context=get_context("spawn")) as ex:
        scans = list(ex.map(_scan, [(root, i, e, cfg.max_points) for i, e in enumerate(egos)]))
    out = (np.stack([p for p, _ in scans]), np.stack([v for _, v in scans]), np.asarray(egos, np.float32))
    if cache:
        np.savez(cache, points=out[0], valid=out[1], egos=out[2])
    return out


def make_batch(pts, valid, egos, step_index=1):
    """chip_smoke.make_batch: the distinct scans repeated to BATCH, egos
    advancing (0.02, 0.01, 0) m a scan from a start moved (0.3, 0.15, 0) m a
    step, each scan's points moved with its ego."""
    import torch

    dev = pts.device
    reps = torch.arange(BATCH, device=dev) % pts.shape[0]
    ego0 = egos[0] + step_index * torch.tensor([0.3, 0.15, 0.0], device=dev)
    begos = ego0[None, :] + torch.arange(BATCH, dtype=torch.float32, device=dev)[:, None] * torch.tensor(
        [0.02, 0.01, 0.0], device=dev)
    shift = begos - egos[reps]
    return (pts[reps] + shift[:, None, :]).contiguous(), valid[reps].contiguous(), begos.contiguous()


_CAPTURE = []   # graph_ms's capture stream, made at its first call


def graph_ms(fn, reps):
    """The card's time for what fn() launches, alone: GRAPH_CALLS calls
    captured in one CUDA graph, replayed until about reps calls ran. fn runs
    once on the capture stream first, so that what a wrapper keeps a stream
    exists before the capture."""
    import torch

    if not _CAPTURE:
        _CAPTURE.append(torch.cuda.Stream())
    stream = _CAPTURE[0]
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g, stream=stream):
        for _ in range(GRAPH_CALLS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    n = max(2, reps // GRAPH_CALLS)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * GRAPH_CALLS)


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
    ap.add_argument("--batch-cache", help="npz file of the batch's eight distinct scans (read, or written if missing)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_entry_points: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve()))
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
    pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego_np, seed=0, channels=128,
                                        azimuth_steps=2048)
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    pts, valid = torch.from_numpy(pad).to(dev), torch.from_numpy(mask).to(dev)
    ego = torch.tensor(ego_np, dtype=torch.float32, device=dev)
    p, keep = binning.prepare_points(cfg, pts, valid, ego)
    origin = gridops.compute_origin(cfg, ego)
    world_k2 = hasattr(kernels, "prepare_points")    # this commit's K2 takes world-frame points
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

    # ---- the combine: its device time and the device work it launches ----
    kernels.build_all()
    buf, _ = pipeline.ingest_and_insert(cfg, empty_buffer_state(cfg, dev), pts, valid, ego)
    world = empty_world_state(cfg, dev)
    out["combine_ms"] = cuda_ms(lambda: pipeline.combine(cfg, buf, world, ego), 10)

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
    # the 2-D chain after K4, as this commit launches it: four launches where
    # the maps' tail has entries of its own, two where the plane fit and the
    # guess height took it over
    tail_entries = hasattr(kernels, "maps_to_window")
    if tail_entries:
        def maps_chain():
            w, iw = kernels.maps_to_window(hm_t, ihm_t, target)
            r, fx, fy = kernels.plane_fit(cfg, w)
            g = kernels.guess_height(cfg, w, iw)
            return kernels.map_products(cfg, pnum, pden, bok, fx, fy, g, w, target)
        stencils = {"plane_fit": lambda: kernels.plane_fit(cfg, hm),
                    "guess_height": lambda: kernels.guess_height(cfg, hm, ihm),
                    "maps_to_window": lambda: kernels.maps_to_window(hm_t, ihm_t, target),
                    "map_products": lambda: kernels.map_products(cfg, pnum, pden, bok, sx, sy,
                                                                 products.guessed_height_delta, hm, target)}
    else:
        def maps_chain():
            w, iw, _, fx, fy = kernels.plane_fit(cfg, hm_t, ihm_t, target)
            return kernels.guess_height(cfg, w, iw, fx, fy, pnum, pden, bok, target)
        stencils = {"plane_fit": lambda: kernels.plane_fit(cfg, hm_t, ihm_t, target),
                    "guess_height": lambda: kernels.guess_height(cfg, hm, ihm, sx, sy, pnum, pden, bok, target)}
    out["maps_chain_launches"] = 4 if tail_entries else 2

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

    # ---- each kernel's launches alone ----
    X, Y, Z = cfg.grid_shape
    bp, bv, be = (torch.from_numpy(a).to(dev) for a in batch_points(str(Path(args.root).resolve()), cfg,
                                                                    args.batch_cache))
    batch = make_batch(bp, bv, be)
    borigin, bpw, bkeep = prepare_batch(cfg, *batch)
    # K2's input: world-frame points, or an older commit's map-local coordinates
    pn = p if world_k2 else gridops.map_local(cfg, p, origin)
    bpn = bpw if world_k2 else gridops.map_local(cfg, bpw, borigin)
    # a commit whose K2 keeps channels 1-9 in a scratch of the caller's (binning.MomentScratch) gets one
    # kept scratch a shape, as its batched step and ring buffer keep one; an older one its fresh [10, P] sums
    kept_scratch = hasattr(binning, "moment_scratch")
    scratches = {}

    def k2(q, k, o, w=None):
        if not kept_scratch:
            return kernels.bin_points(cfg, q, k, o, w)
        key = (id(q), w)
        if key not in scratches:
            scratches[key] = binning.moment_scratch(cfg, dev, w)
        return kernels.bin_points(cfg, q, k, o, w, scratches[key])

    def sums(b):
        """An epilogue's sums arguments, by the commit's signature."""
        return (b.n, b.rest) if kept_scratch else (b.sums,)

    scan_bins = k2(pn, keep, origin)
    slab_bins = k2(pn, keep, origin, yw)
    batch_bins = k2(bpn, bkeep, borigin)
    ring = torch.empty((2, 10, X, Y, Z), dtype=torch.float32, device=dev)
    slot = torch.ones((1,), dtype=torch.int32, device=dev)
    p1, k1, e1 = p[None], keep[None], ego.reshape(1, 3)

    def k2_k3():
        b = k2(pn, keep, origin)
        kernels.ingest_epilogue(cfg, *sums(b), b.hit, origin, ring, slot)

    def k2_k5():
        b = k2(bpn, bkeep, borigin)
        return kernels.moments_epilogue(cfg, *sums(b), b.hit, borigin, occupancy_mask=False)

    launches = {
        "K1_scan": lambda: kernels.ray_pass_counts(cfg, p1, k1, e1, origin),
        "K1_slab": lambda: kernels.ray_pass_counts(cfg, p1, k1, e1, origin, y_window=yw),
        "K2_scan": lambda: k2(pn, keep, origin),
        "K2_slab": lambda: k2(pn, keep, origin, yw),
        "K2_batch": lambda: k2(bpn, bkeep, borigin),
        "K3_scan": lambda: kernels.ingest_epilogue(cfg, *sums(scan_bins), scan_bins.hit, origin, ring, slot),
        "K5_batch_mask_off": lambda: kernels.moments_epilogue(cfg, *sums(batch_bins), batch_bins.hit, borigin,
                                                              occupancy_mask=False),
        "K5_slab_mask_on": lambda: kernels.moments_epilogue(cfg, *sums(slab_bins), slab_bins.hit, origin, yw),
        "K2_then_K3_scan": k2_k3,
        "K2_then_K5_batch": k2_k5,
        "K4_combine": k4_launch,
        "maps_chain": maps_chain,
        **stencils,
    }
    if world_k2:
        launches["prepare_scan"] = lambda: kernels.prepare_points(cfg, pts[None], valid[None], ego[None], frame_ego=ego)
        launches["prepare_batch"] = lambda: kernels.prepare_points(cfg, *batch, frame_ego=batch[2][-1], drop_dead=True)
    # ---- the batched step: the batch into the live world of a first step ----
    step = make_batched_step(cfg)
    live, _ = step(empty_world_state(cfg, dev), *make_batch(bp, bv, be, step_index=0))
    out["batched_step_ms"] = cuda_ms(lambda: step(live, *batch), 10)
    host = []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(live, *batch)
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t0))
    out["batched_step_host_ms_median"] = statistics.median(host)
    out["batched_step_launches"], out["batched_step_f64_launches"] = count_launches(lambda: step(live, *batch))
    del live
    out["batch_points"] = int(bpn.shape[0])
    out["launch_alone_ms"] = {name: graph_ms(fn, args.reps) for name, fn in launches.items()}
    # the wrappers back to back, as the host paces them
    out["wrapper_ms"] = {name: cuda_ms(launches[name], args.reps, warm=5) for name in
                         ("prepare_scan", "prepare_batch", "maps_chain", *stencils) if name in launches}
    smi = ""
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(out))
    print(smi.splitlines()[0] if smi else "nvidia-smi: no reading")
    return 0


if __name__ == "__main__":
    sys.exit(main())
