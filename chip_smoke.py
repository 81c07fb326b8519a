#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gvom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json] [--scans N]

Builds the port's CUDA kernels from gvom_tpu_torch/csrc (one nvcc per source,
all started together), then, at the upstream deployment (a 256×256×64 grid
at 0.4 m, a ring buffer of 4 scans, 131,072 points per scan from a
synthetic OS1-128 sweep of the composite terrain, made from fixed seeds):

  1. holds each kernel against its plain PyTorch version on the card, on the
     same inputs, over a drive with a moving ego (re-origin, decay veto):
     K1 pass counts (from points: the kernel builds the ray geometry), K2 hit
     and min_height and the moment count n, and every K4 output bitwise (its
     moments too); the other moment channels within MOM_RTOL / MOM_ATOL (f32
     sums in another order), K2's where n > 0, the only voxels where its
     scratch defines them. Every epilogue form (K3, K5 with the mask on and
     off, the slab form) gives bitwise the same output on sums whose
     channels 1-9 are NaN where n == 0: it never reads them. K4 also at
     B = 2 (Z = 96) and B = 7 (Z = 31) on a small grid, each B a library of
     its own. K5 (the epilogue into a fresh tensor) with the occupancy mask
     on and off. The slab forms of
     K1, K2 and K5 for the four quarter slabs of a scan whose window seam
     falls inside a slab, each against its plain version AND against the
     rows of the full-grid kernel's output, and ingest_scan(y_window=) side
     by side against ingest_scan(). K1 on a near-tier scene (every ray
     shorter than 30 steps, the tier of the JAX package's step-pair kernel);
  2. drives the port's Gvom facade (process_pointcloud, then combine_maps
     after each scan) with every kernel's launch count set to 0 just before
     and read just after, and checks the 5-tuple it returns;
  3. checks the facade's outputs and ring buffer on a small grid (B = 3,
     whose K4 library the facade builds when it is made), over a
     drive with one degenerate scan, against the same facade on the CPU,
     which runs the plain versions (the CPU tests pin those to the JAX
     package);
  4. times each kernel, its plain version and, where one exists, a PyTorch
     call that computes the same function, with CUDA events, and computes
     each kernel's bound from this run's inputs: the bytes it must move
     over the memory rate, or its operations over their rate, whichever is
     larger. A kernel's ms is the card's time for what its wrapper launches,
     alone: the launches (fills included) captured in a CUDA graph and
     replayed; wrapper_ms beside it is the wrapper called back to back, as
     the host paces it. K1's and K2's one-atomic-a-pass (a point) floor at
     the rate of a probe kernel (csrc/atomic_rate.cu) is reported beside the
     bound as atomic_floor_ms. K4's bytes are counted from what this data
     makes it read. Two pairs, K2 then K3 on one scan and K2 then K5 on a
     batch, are timed against a bound that no design moves (pair_bound);
  5. drives the batched step (make_batched_step): two steps of 4 scans held
     against the same step with every kernel swapped for its plain version,
     then two steps of 32 scans of 131,072 points (the second merges with a
     live world at a moved origin), timed, with the launch counts set to 0
     just before and read just after (K1: one launch a step); then K1 on a
     whole 32-scan batch, timed and held bitwise against the sum of its
     one-scan launches over the same scans, and K2 and K5 on its merged
     points against their plain versions, timed;
  6. runs batched_replay over a synthesized log of 8 scans on a small grid,
     batch 4, against the same replay on the CPU, with a checkpoint written,
     loaded, and the resumed run's world equal to the straight run's.

Prints the timings, one JSON line {"kernels": [...]}, the card's name and
power limit, and as its last line {"ok": true, "device": {...}}. Exits
non-zero without that line when there is no CUDA device or a phase fails.
--out also writes every number to a JSON file.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# f32 moment sums taken in another order (atomics, the 27-voxel box) than the
# plain version's: relative error grows with the number of terms, up to a few
# thousand near the ego
MOM_RTOL = 1e-4
MOM_ATOL = 1e-3
# a batched step sums every scan of its batch into one voxel: up to 32 times
# the terms, and the absolute error of an unordered f32 sum grows with them.
# Seen on an H100 (700 W): max abs error 9.8e-4 for one scan, 3.9e-3 for a
# batch of 4 (8 to 16 % of rtol·|b| + atol where it is largest) and 1.6e-2 to
# 2.3e-2 for a batch of 32, at a voxel of 7,432 points (5 to 6 %)
MOM_ATOL_BATCH = 1e-2
BATCH = 32                   # scans per batched step, the JAX package's bench default
BATCH_CHECK = 4              # scans per step of the batched step held against the plain versions
NEAR_TIER_STEPS = 30         # the step-pair kernel of the JAX package covers steps 1..30
# log and atan2 of CUDA and of the CPU may differ by an ulp or so
ROUGH_ATOL = 1e-4

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
# The atomic-rate probe (csrc/atomic_rate.cu): 2^26 scattered atomics into
# 2^22 words, the size of one 256×256×64 int32 grid (L2-resident, as K1's
# and K2's targets mostly are). The data sheet gives no atomic rate.
ATOMIC_PROBE_WORDS = 1 << 22
ATOMIC_PROBE_OPS = 1 << 26

LIDAR = dict(channels=128, azimuth_steps=2048)   # OS1-128 sweep; its returns are cut to max_points
DEVICE = "cuda"


def _scan(args):
    """(points [max_points,3] f32, mask, ego) of one synthetic scan."""
    i, ego, max_points, lidar = args
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from gvom_tpu_torch.io import synthetic

    pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego, seed=i, **lidar)
    pad, mask = synthetic.pad_scan(pts, max_points)
    return pad, mask, np.asarray(ego, np.float64)


def make_scans(cfg, n, lidar):
    egos = [(0.3 + 1.3 * i, -0.2 + 0.7 * i, 1.5 + 0.02 * i) for i in range(n)]
    jobs = [(i, e, cfg.max_points, lidar) for i, e in enumerate(egos)]
    with ProcessPoolExecutor(max_workers=min(n, os.cpu_count() or 1), mp_context=get_context("spawn")) as ex:
        return list(ex.map(_scan, jobs))


class Failed(Exception):
    pass


def check(cond, what):
    if not cond:
        raise Failed(what)


def exact(name, a, b):
    check(a.shape == b.shape and a.dtype == b.dtype, f"{name}: {a.shape}/{a.dtype} vs {b.shape}/{b.dtype}")
    n = int((a != b).sum())
    check(n == 0, f"{name}: {n} elements differ from the plain version")
    return 0.0


def close(name, a, b, atol=MOM_ATOL):
    import torch

    check(a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}")
    ok = torch.isclose(a, b, rtol=MOM_RTOL, atol=atol)
    n = int((~ok).sum())
    err = float((a - b).abs().max()) if a.numel() else 0.0
    check(n == 0, f"{name}: {n} elements outside rtol={MOM_RTOL} atol={atol} (max abs err {err})")
    return err


def tol_share(a, b, atol):
    """The largest |a − b| as a share of its tolerance atol + MOM_RTOL·|b|."""
    return float(((a - b).abs() / (atol + MOM_RTOL * b.abs())).max())


def moments_close(name, a, b, atol=MOM_ATOL):
    """[10, ...] moments: the count n bitwise, the nine sums within tolerance."""
    exact(f"{name} n", a[0], b[0])
    return close(f"{name} moments", a, b, atol)


def sums_close(name, a, b, atol=MOM_ATOL):
    """K2's own-voxel sums [10, ...]: n bitwise, the nine other channels
    within tolerance where n > 0, the only voxels where they are defined
    (binning.PointBins)."""
    exact(f"{name} n", a[0], b[0])
    nz = b[0] > 0
    return close(f"{name} sums where n > 0", a[:, nz], b[:, nz], atol)


def clean_sums(sums):
    """The sums with channels 1-9 set to 0 where n == 0, as the plain twins
    read them."""
    import torch

    return torch.where(sums[:1] > 0, sums, torch.zeros((), dtype=sums.dtype, device=sums.device))


def nan_blind(name, fn, sums):
    """fn (an epilogue) on sums whose channels 1-9 are NaN where n == 0 gives
    bitwise what it gives on the clean sums: it never reads them."""
    import torch

    bad = sums.clone()
    bad[1:] = torch.where(sums[:1] > 0, sums[1:], torch.full((), float("nan"), device=sums.device))
    ref = fn(clean_sums(sums)).clone()
    got = fn(bad)
    check(bool(torch.isfinite(got).all()), f"{name}: not finite on NaN-poisoned sums")
    exact(f"{name} on NaN-poisoned sums vs clean sums", got, ref)


def cuda_ms(fn, reps, warm=1):
    """Mean device time of fn() over reps calls, after warm calls, paced by
    the host: allocations and launch overhead included."""
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


GRAPH_CALLS = 10    # calls of fn captured in one graph by graph_ms


def graph_ms(fn, reps):
    """The card's time for what fn() launches, alone: GRAPH_CALLS calls
    captured in one CUDA graph (fills and small launches included, no host in
    between), replayed until about reps calls ran, timed with CUDA events.
    Returns (ms per call, what the last captured call returned)."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(GRAPH_CALLS):
            last = fn()
    g.replay()
    torch.cuda.synchronize()
    n = max(2, reps // GRAPH_CALLS)
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / (n * GRAPH_CALLS), last


def box_conv_weights(cfg, dev):
    """[10, 10, 2rx+1, 2ry+1, 2rz+1] weights under which conv3d of the padded
    own-voxel sums is the ±r box of moments translated into the target's
    frame (ops/moments.translate_raw: the translate is linear in the sums)."""
    import torch

    from gvom_tpu_torch.ops.binning import PAIRS, moment_pad

    r = moment_pad(cfg)
    w = torch.zeros((10, 10) + tuple(2 * q + 1 for q in r), dtype=torch.float32)
    for i in range(2 * r[0] + 1):
        for j in range(2 * r[1] + 1):
            for k in range(2 * r[2] + 1):
                t = (i - r[0], j - r[1], k - r[2])
                w[0, 0, i, j, k] = 1.0
                for a in range(3):
                    w[1 + a, 1 + a, i, j, k] = 1.0
                    w[1 + a, 0, i, j, k] = t[a]
                for q, (a, b) in enumerate(PAIRS):
                    w[4 + q, 4 + q, i, j, k] = 1.0
                    w[4 + q, 1 + b, i, j, k] += t[a]
                    w[4 + q, 1 + a, i, j, k] += t[b]
                    w[4 + q, 0, i, j, k] = t[a] * t[b]
    return w.to(dev)


def phase1_kernels_vs_plain(cfg, scans, dev, log):
    """Each kernel against its plain version on the same inputs, over a drive
    with a moving ego. Returns the max abs error per kernel and the last
    scan's inputs (for the timings)."""
    import torch

    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import binning, kernels, moments, raycast
    from gvom_tpu_torch.ops import grid as gridops
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

    err = {k.name: 0.0 for k in kernels.KERNELS}
    buf, world = empty_buffer_state(cfg, dev), empty_world_state(cfg, dev)
    X, Y, Z = cfg.grid_shape
    last = None
    for i, (pad, mask, ego_np) in enumerate(scans):
        pts, valid = torch.from_numpy(pad).to(dev), torch.from_numpy(mask).to(dev)
        ego = torch.tensor(ego_np, dtype=torch.float32, device=dev)
        p, keep = binning.prepare_points(cfg, pts, valid, ego)
        origin = gridops.compute_origin(cfg, ego)
        pn = gridops.map_local(cfg, p, origin)
        m = raycast.march_inputs(cfg, p, keep, ego, origin)

        passes = raycast.ray_pass_counts(cfg, p, keep, ego, origin)
        exact("K1 passes", passes, raycast.ray_pass_counts_plain(cfg, m, origin))

        kb, pb = kernels.bin_points(cfg, pn, keep, origin), binning.bin_points(cfg, pn, keep, origin)
        exact("K2 hit", kb.hit, pb.hit)
        exact("K2 min_height", kb.min_height, pb.min_height)
        err["bin_points"] = max(err["bin_points"], sums_close("K2", kb.sums, pb.sums))

        slot = torch.ones((1,), dtype=torch.int32, device=dev)
        ko = torch.zeros((2, 10, X, Y, Z), dtype=torch.float32, device=dev)
        po = torch.zeros_like(ko)
        kernels.ingest_epilogue(cfg, kb.sums, kb.hit, origin, ko, slot)
        moments.ingest_epilogue_plain(cfg, kb.sums, kb.hit, origin, po, slot)
        exact("K3 untouched slot", ko[0], po[0])
        exact("K3 n", ko[1, 0], po[1, 0])
        err["ingest_epilogue"] = max(err["ingest_epilogue"], close("K3 moments", ko[1], po[1]))
        # K5: the same box into a fresh tensor, the occupancy mask on and off
        for mask in (True, False):
            km = kernels.moments_epilogue(cfg, kb.sums, kb.hit, origin, occupancy_mask=mask)
            pm = moments.moments_epilogue_plain(cfg, kb.sums, kb.hit, origin, occupancy_mask=mask)
            err["moments_epilogue"] = max(err["moments_epilogue"], moments_close(f"K5 mask={mask}", km, pm))
            if mask:
                exact("K5 masked vs K3's slot", km, ko[1])
            else:
                check(bool((km[:, kb.hit == 0] != 0).any()), "K5 mask off: no moments at voxels without a hit")
            del km, pm
        if i == 0:
            nan_blind("K3", lambda s: kernels.ingest_epilogue(cfg, s, kb.hit, origin, ko, slot), kb.sums)
            for mask in (True, False):
                nan_blind(f"K5 mask={mask}", lambda s: kernels.moments_epilogue(cfg, s, kb.hit, origin,
                                                                               occupancy_mask=mask), kb.sums)
        del ko, po, pb

        buf, scan_ok = pipeline.ingest_and_insert(cfg, buf, pts, valid, ego)
        check(bool(scan_ok), f"scan {i} has no occupied voxel")
        target = buf.grids.origin.index_select(0, buf.last_slot.reshape(1).long())[0]
        combine_vs_plain(cfg, buf, world, ego, "K4")
        world, products, ok = pipeline.combine(cfg, buf, world, ego)
        check(bool(ok), f"combine after scan {i} reports an empty buffer")
        revived = int(((world.grid.hit > 0) & (buf.grids.hit[buf.last_slot.long()] == 0)).sum())
        log(f"phase 1 scan {i}: origin {origin.tolist()}, {int(keep.sum())} points kept, "
            f"{int((kb.hit > 0).sum())} occupied voxels, {int(passes.sum())} passes, "
            f"world occupied {int((world.grid.hit > 0).sum())} ({revived} not in the newest scan): "
            "K1-K5 agree with their plain versions" + (", K3 and K5 (mask on, off) bitwise the same on NaN-poisoned "
                                                         "sums" if i == 0 else ""))
        last = dict(pts=pts, valid=valid, ego=ego, p=p, origin=origin, pn=pn, keep=keep, bins=kb, target=target)
    return err, buf, world, last


COMBINE_OUTPUTS = ("hit", "miss", "min_height", "evidence", "mom", "height", "inferred_height",
                   "band_hit_sum", "band_total_sum", "band_ok")


def combine_vs_plain(cfg, buf, world, ego, what):
    """K4 against fuse_plain on the same inputs, at the newest slot's origin:
    every output bitwise, the moments too (both add slots 0..B-1, then the
    old world, in f32 with one rounding each)."""
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import kernels

    target = buf.grids.origin.index_select(0, buf.last_slot.reshape(1).long())[0]
    ko = kernels.combine(cfg, buf, world, target, ego)
    po = pipeline.fuse_plain(cfg, buf, world, target, ego)
    for name, a, b in zip(COMBINE_OUTPUTS, ko, po):
        exact(f"{what} {name}", a, b)


def phase1_combine_other_b(dev, log):
    """K4 at two other ring-buffer depths on a small grid, each a library of
    its own: B = 2 at Z = 96 and B = 7 at Z = 31 (both the four-chunk path
    with 4-byte accesses, where the upstream Z = 64 takes the 8-byte one),
    over a drive of 4 scans, held against fuse_plain after each ingest."""
    from gvom_tpu_torch import GvomConfig
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

    scans = make_scans(GvomConfig(max_points=4096), 4, dict(channels=32, azimuth_steps=128))
    for B, Z in ((2, 96), (7, 31)):
        cfg = GvomConfig(xy_size=64, z_size=Z, max_points=4096, buffer_size=B)
        buf, world = empty_buffer_state(cfg, dev), empty_world_state(cfg, dev)
        for i, scan in enumerate(scans):
            pts, valid, ego = scan_tensors(scan, dev)
            buf, _ = pipeline.ingest_and_insert(cfg, buf, pts, valid, ego)
            combine_vs_plain(cfg, buf, world, ego, f"K4 B={B} Z={Z}")
            world, _, ok = pipeline.combine(cfg, buf, world, ego)
            check(bool(ok), f"K4 B={B}: combine after scan {i} reports an empty buffer")
        log(f"phase 1 K4 at B = {B}, 64×64×{Z}: every output bitwise against fuse_plain over 4 scans, world "
            f"occupied {int((world.grid.hit > 0).sum())}")


def scan_tensors(scan, dev):
    import torch

    pad, mask, ego_np = scan
    return (torch.from_numpy(pad).to(dev), torch.from_numpy(mask).to(dev),
            torch.tensor(ego_np, dtype=torch.float32, device=dev))


def phase1_slabs(cfg, scan, dev, log, err):
    """The slab forms (y_window) of K1, K2 and K5 on one scan whose window
    seam falls inside a slab: each of the four quarter slabs against its
    plain version and against the rows of the full-grid kernel's output;
    then ingest_scan(y_window=) side by side against ingest_scan(), with the
    launch counts set to 0 just before and read just after. Returns the
    launches and the inputs of the slab that holds the seam (for the
    timings)."""
    import torch

    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import binning, kernels, moments, raycast
    from gvom_tpu_torch.ops import grid as gridops

    pts, valid, ego = scan_tensors(scan, dev)
    p, keep = binning.prepare_points(cfg, pts, valid, ego)
    origin = gridops.compute_origin(cfg, ego)
    pn = gridops.map_local(cfg, p, origin)
    m = raycast.march_inputs(cfg, p, keep, ego, origin)
    Y = cfg.xy_size
    Ys = Y // 4
    seam = int(origin[1]) % Y          # the torus row of window row 0
    check(seam % Ys != 0, f"the window seam (torus row {seam}) lies on a slab boundary, not inside a slab")
    full_pass = raycast.ray_pass_counts(cfg, p, keep, ego, origin)
    full_bins = kernels.bin_points(cfg, pn, keep, origin)
    full_mom = {mask: kernels.moments_epilogue(cfg, full_bins.sums, full_bins.hit, origin, occupancy_mask=mask)
                for mask in (True, False)}
    for k in range(4):
        yw = (k * Ys, Ys)
        rows = slice(k * Ys, (k + 1) * Ys)
        kp = raycast.ray_pass_counts(cfg, p, keep, ego, origin, y_window=yw)
        exact(f"K1 slab {k} vs plain", kp, raycast.ray_pass_counts_plain(cfg, m, origin, yw))
        exact(f"K1 slab {k} vs the full grid's rows", kp, full_pass[:, rows].contiguous())
        kb, pb = kernels.bin_points(cfg, pn, keep, origin, yw), binning.bin_points(cfg, pn, keep, origin, yw)
        for name in ("hit", "min_height"):
            exact(f"K2 slab {k} {name} vs plain", getattr(kb, name), getattr(pb, name))
            exact(f"K2 slab {k} {name} vs the full grid's rows", getattr(kb, name),
                  getattr(full_bins, name)[:, rows].contiguous())
        err["bin_points_slab"] = max(err["bin_points_slab"], sums_close(f"K2 slab {k}", kb.sums, pb.sums))
        has_seam = k * Ys <= seam < (k + 1) * Ys
        for mask in (True, False):
            km = kernels.moments_epilogue(cfg, kb.sums, kb.hit, origin, yw, mask)
            pm = moments.moments_epilogue_plain(cfg, kb.sums, kb.hit, origin, yw, mask)
            e1 = moments_close(f"K5 slab {k} mask={mask} vs plain", km, pm)
            e2 = moments_close(f"K5 slab {k} mask={mask} vs the full grid's rows", km,
                               full_mom[mask][:, :, rows].contiguous())
            err["moments_epilogue_slab"] = max(err["moments_epilogue_slab"], e1, e2)
            if has_seam:
                nan_blind(f"K5 slab {k} mask={mask}",
                          lambda s: kernels.moments_epilogue(cfg, s, kb.hit, origin, yw, mask), kb.sums)
        if has_seam:
            last = dict(p=p, ego=ego, origin=origin, pn=pn, keep=keep, bins=kb, y_window=yw,
                        full_n=full_bins.sums[0], full_hit=full_bins.hit)
    del full_mom, full_pass

    kernels.reset_launches()
    grid, ok = pipeline.ingest_scan(cfg, pts, valid, ego)
    slabs = [pipeline.ingest_scan(cfg, pts, valid, ego, y_window=(k * Ys, Ys)) for k in range(4)]
    launches = {k.name: k.launches for k in kernels.KERNELS}
    for name in ("ray_pass_counts", "bin_points", "moments_epilogue"):
        check(launches[name] == 1 and launches[name + "_slab"] == 4,
              f"ingest_scan: {name} launched {launches[name]} times, its slab form {launches[name + '_slab']}")
    check(bool(ok), "ingest_scan: scan_ok is False")
    for name in ("hit", "miss", "min_height"):
        exact(f"ingest_scan slabs side by side: {name}", torch.cat([getattr(g, name) for g, _ in slabs], dim=1),
              getattr(grid, name))
    e = moments_close("ingest_scan slabs side by side", torch.cat([g.mom for g, _ in slabs], dim=2), grid.mom)
    err["moments_epilogue_slab"] = max(err["moments_epilogue_slab"], e)
    for k, (g, sok) in enumerate(slabs):
        check(bool(sok) == bool((grid.hit[:, k * Ys:(k + 1) * Ys] > 0).any()), f"ingest_scan slab {k}: scan_ok")
    log(f"phase 1 slabs: origin {origin.tolist()} (seam at torus row {seam}), four slabs of {Ys} rows: K1, K2, K5 "
        f"agree with their plain versions and with the full grid's rows, the slab epilogue bitwise the same on "
        f"NaN-poisoned sums; ingest_scan(y_window=) side by side "
        f"equals ingest_scan(); launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}")
    return launches, last


def phase1_near_tier(cfg, scan, dev, log):
    """K1 on a near-tier scene: the scan's returns pulled in until every ray
    ends before step NEAR_TIER_STEPS, the tier that the JAX package's
    step-pair kernel covers. csrc/raycast.cu is that kernel's counterpart,
    and it is held here from the points, its geometry inside."""
    import torch

    from gvom_tpu_torch.ops import binning, raycast
    from gvom_tpu_torch.ops import grid as gridops

    pts, valid, ego = scan_tensors(scan, dev)
    d = pts - ego
    lim = (NEAR_TIER_STEPS - 1.5) * min(cfg.xy_resolution, cfg.z_resolution)
    near = ego + d * torch.clamp(lim / d.norm(dim=1).clamp(min=1e-6), max=1.0)[:, None]
    p, keep = binning.prepare_points(cfg, near, valid, ego)
    origin = gridops.compute_origin(cfg, ego)
    m = raycast.march_inputs(cfg, p, keep, ego, origin)
    k = raycast.ray_pass_counts(cfg, p, keep, ego, origin)
    exact("K1 near tier vs plain", k, raycast.ray_pass_counts_plain(cfg, m, origin))
    short = dataclasses.replace(cfg, ray_steps_override=NEAR_TIER_STEPS)
    exact(f"K1 near tier: a ray goes beyond step {NEAR_TIER_STEPS}",
          raycast.ray_pass_counts(short, p, keep, ego, origin), k)
    check(int(k.sum()) > int(keep.sum()), "near tier: no passes")
    log(f"phase 1 near tier: {int(keep.sum())} rays of under {NEAR_TIER_STEPS} steps, {int(k.sum())} passes: K1 "
        "agrees with its plain version")


def phase2_facade(cfg, scans, log):
    """The main path through the user's entry points, with the launch counts
    set to 0 just before and read just after."""
    import numpy as np
    import torch

    from gvom_tpu_torch import Gvom
    from gvom_tpu_torch.ops import kernels

    g = Gvom(config=cfg)
    torch.cuda.synchronize()
    ingest_s, combine_s = [], []
    kernels.reset_launches()
    for i, (pad, mask, ego) in enumerate(scans):
        pts = pad[mask]
        t0 = time.perf_counter()
        scan_ok = g.process_pointcloud(pts, ego)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = g.combine_maps()
        t2 = time.perf_counter()
        ingest_s.append(t1 - t0)
        combine_s.append(t2 - t1)
        check(bool(scan_ok), f"facade scan {i}: scan_ok is False")
        check(out is not None and len(out) == 5, f"facade combine {i}: no 5-tuple")
        origin_world, pos, neg, rough, vis = out
        check(origin_world.shape == (3,) and origin_world.dtype == np.float64, "origin_world")
        for name, a, dt in (("positive", pos, np.int32), ("negative", neg, np.int32),
                            ("roughness", rough, np.float32), ("visibility", vis, np.int32)):
            check(a.shape == cfg.map_shape and a.dtype == dt, f"{name}: {a.shape} {a.dtype}")
            check(bool(np.isfinite(a).all()), f"{name} is not finite")
        check(int(vis.sum()) > 0 and int((pos > 0).sum()) > 0, f"facade combine {i}: empty maps")
    launches = {k.name: k.launches for k in kernels.KERNELS}
    for name in ("ray_pass_counts", "bin_points", "ingest_epilogue", "combine"):
        check(launches[name] == len(scans), f"kernel {name} was launched {launches[name]} times on the facade's path, "
              f"not once per scan")
    occ = g.get_map_as_occupancy_grid()
    check(occ.shape == cfg.grid_shape and occ.any(), "occupancy grid")
    warm = slice(1, None)
    res = dict(
        scans=len(scans),
        ingest_wall_ms=[1e3 * s for s in ingest_s],
        combine_wall_ms=[1e3 * s for s in combine_s],
        ingest_wall_ms_median_warm=1e3 * statistics.median(ingest_s[warm]),
        combine_wall_ms_median_warm=1e3 * statistics.median(combine_s[warm]),
        visible_cells=int(vis.sum()), positive_cells=int((pos > 0).sum()),
        negative_cells=int((neg > 0).sum()),
    )
    log(f"phase 2 facade: {len(scans)} scans, launches {launches}; per scan (warm median, host clock "
        f"with sync): process_pointcloud {res['ingest_wall_ms_median_warm']:.3f} ms, combine_maps "
        f"{res['combine_wall_ms_median_warm']:.3f} ms")
    return launches, res, g


def phase3_small_reference(log):
    """The facade on a small grid on the GPU against the same facade on the
    CPU, where every wrapper runs its plain version. The third scan's points
    all lie inside min_distance of the world origin, so it is degenerate
    and goes to the write-off slot, which the GPU picks on the device."""
    import numpy as np

    from gvom_tpu_torch import Gvom, GvomConfig
    from gvom_tpu_torch.ops import kernels
    from gvom_tpu_torch.utils import convert

    cfg = GvomConfig(xy_size=64, z_size=32, max_points=4096, buffer_size=3)
    scans = make_scans(cfg, 5, dict(channels=32, azimuth_steps=128))
    near = np.random.default_rng(0).uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
    scans[2] = (near, np.ones(len(near), bool), scans[2][2])
    gpu, cpu = Gvom(config=cfg), Gvom(config=cfg, device="cpu")
    check(kernels.CMB.library((f"-DGVOM_COMBINE_B={cfg.buffer_size}",)).exists(),
          f"Gvom(buffer_size={cfg.buffer_size}) did not build its combine library when it was made")
    for i, (pad, mask, ego) in enumerate(scans):
        ok_gpu = bool(gpu.process_pointcloud(pad[mask], ego))
        ok_cpu = bool(cpu.process_pointcloud(pad[mask], ego))
        check(ok_gpu == ok_cpu == (i != 2), f"small grid scan {i}: scan_ok {ok_gpu} on the GPU, {ok_cpu} on the CPU")
        a, b = gpu.combine_maps(), cpu.combine_maps()
        for name, x, y in zip(("origin", "positive", "negative", "visibility"), a[:3] + a[4:], b[:3] + b[4:]):
            check(np.array_equal(x, y), f"small grid scan {i}: {name} differs from the CPU")
        err = float(np.abs(a[3] - b[3]).max())
        check(err <= ROUGH_ATOL, f"small grid scan {i}: roughness differs by {err}")
    check(np.array_equal(gpu.get_map_as_occupancy_grid(), cpu.get_map_as_occupancy_grid()), "small occupancy")
    bg, bc = convert.to_numpy(gpu._buffer), convert.to_numpy(cpu._buffer)
    for k in bg:
        if k == "mom":
            check(bool(np.array_equal(bg[k][:, 0], bc[k][:, 0])), "small grid buffer: moment n differs")
            check(bool(np.allclose(bg[k], bc[k], rtol=MOM_RTOL, atol=MOM_ATOL)), "small grid buffer: moments")
        else:
            check(bool(np.array_equal(bg[k], bc[k])), f"small grid buffer: {k} differs from the CPU")
    log("phase 3: the GPU facade matches the CPU facade on a 64×64×32 grid over 5 scans, one of them "
        "degenerate (write-off slot), ring buffer included")


def atomic_rates(probe, dev, log):
    """Scattered, uncontended global atomics per second on this card, int32
    and float32 (csrc/atomic_rate.cu), into a buffer of ATOMIC_PROBE_WORDS
    words."""
    import torch

    from gvom_tpu_torch.ops import kernels

    rates = {}
    for name, dtype, is_float in (("int32", torch.int32, False), ("float32", torch.float32, True)):
        buf = torch.zeros(ATOMIC_PROBE_WORDS, dtype=dtype, device=dev)
        ms = cuda_ms(lambda: probe.launch(kernels._ptr(buf), ATOMIC_PROBE_WORDS.bit_length() - 1,
                                          ATOMIC_PROBE_OPS, int(is_float), kernels._stream()), 5)
        rates[name] = ATOMIC_PROBE_OPS / (1e-3 * ms)
        log(f"atomic rate probe {name}: {ATOMIC_PROBE_OPS} scattered atomics in {ms:.4f} ms, "
            f"{rates[name] / 1e9:.2f} G/s")
    return rates


def kernel_row(k, fn, plain, reps, plain_reps, lib, bytes_moved, ops_s, log):
    """One row of the kernels line: ms, the card's time for what the wrapper
    fn launches, alone (graph_ms); wrapper_ms, fn called back to back as the
    host paces it; the plain version's and the library call's ms; and the
    bound from bytes_moved and ops_s, the least time of the kernel's
    operations (float32 arithmetic at the published rate)."""
    ms, _ = graph_ms(fn, reps)
    wms = cuda_ms(fn, reps, warm=5)
    pms = cuda_ms(plain, plain_reps)
    lms = cuda_ms(lib, reps) if lib is not None else None
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    b_ms = 1e3 * max(bytes_s, ops_s)
    r = dict(name=k.name, route="cuda", source=str(k.source.relative_to(ROOT)),
             replaces=", ".join(re.findall(r"[\w/]+\.py:\d+", k.replaces)), ms=ms, wrapper_ms=wms, plain_ms=pms,
             bound_ms=b_ms, bound_by="bytes" if bytes_s >= ops_s else "operations",
             library_ms=lms, bytes=bytes_moved, bytes_ms=1e3 * bytes_s, ops_ms=1e3 * ops_s)
    log(f"timing {k.name}: launch alone {ms:.4f} ms, wrapper {wms:.4f} ms, plain {pms:.4f} ms, library "
        f"{'n/a' if lms is None else f'{lms:.4f} ms'}, bound {b_ms:.4f} ms ({r['bound_by']}; "
        f"bytes {1e3 * bytes_s:.4f} ms, operations {1e3 * ops_s:.4f} ms)")
    return r


def binned(cfg, pn, keep, origin):
    """(sums, hit) of K2 on a point set, for an epilogue."""
    from gvom_tpu_torch.ops import kernels

    b = kernels.bin_points(cfg, pn, keep, origin)
    return b.sums, b.hit


def index_add_inputs(cfg, pn, keep, origin, y_window=None):
    """(flat scratch index [n], values [10, n]) of the points that K2 sums:
    the inputs of the one index_add_ that computes K2's ten own-voxel sums."""
    import torch

    from gvom_tpu_torch.ops import binning

    vox = torch.floor(pn).to(torch.int32)
    pieces = binning.scratch_pieces(cfg, vox, keep, origin, y_window)
    flat = torch.cat([f[sel].long() for sel, f in pieces])
    lk = torch.cat([(pn - vox.float())[sel] for sel, _ in pieces])
    vals = torch.stack([torch.ones_like(lk[:, 0]), lk[:, 0], lk[:, 1], lk[:, 2]]
                       + [lk[:, a] * lk[:, b] for a, b in binning.PAIRS], dim=0).contiguous()
    return flat, vals


def k2_bound(n_points, n_kept, n_out, n_scratch, n_scratch_nz):
    """(bytes, seconds of operations) of K2 on this data, under the contract
    of its scratch (binning.PointBins): it reads the points (12 bytes) and
    keep (1 byte), writes hit and min_height over the n_out voxels of the
    grid, n over the n_scratch voxels of the scratch and the nine other
    channels where n > 0 (n_scratch_nz); about 30 f32 operations a kept
    point."""
    return n_points * 13 + 2 * n_out * 4 + n_scratch * 4 + 9 * n_scratch_nz * 4, 30 * n_kept / F32_OPS_PER_S


def k2_atomic_floor_ms(n_grid, n_win, rates):
    """One int32 atomic a point for hit and for min_height and ten float32
    ones a point in the window, at the probe's uncontended rate: the floor of
    a design that merges no adds (not a bound of the function)."""
    return 1e3 * (2 * n_grid / rates["int32"] + 10 * n_win / rates["float32"])


def pair_bound(n_points, n_kept, n_out, terms):
    """(bytes, seconds of operations) of K2 then an epilogue, whatever
    implements them: the points and keep read, hit, min_height and the ten
    moment channels written; the sums scratch between the two is the
    implementation's choice. Operations: K2's 30 a kept point and 52 a box
    term."""
    return n_points * 13 + 12 * n_out * 4, (30 * n_kept + 52 * terms) / F32_OPS_PER_S


def pair_row(name, fn, reps, n_points, n_kept, n_out, terms, log):
    """K2 then an epilogue, launched alone (graph_ms), against pair_bound."""
    ms, _ = graph_ms(fn, reps)
    nbytes, ops_s = pair_bound(n_points, n_kept, n_out, terms)
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops_s
    r = dict(name=name, ms=ms, bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             bytes=nbytes, bytes_ms=bytes_ms, ops_ms=ops_ms)
    log(f"timing the pair {name}: launch alone {ms:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}; "
        f"{nbytes / 1e6:.1f} MB), {100 * r['bound_ms'] / ms:.0f} % of it")
    return r


def k1_bound(n_points, n_scans, n_rays, n_pass, n_out):
    """(bytes, seconds of operations) of K1 on this data, the same whatever
    implements it: it reads the points (12 bytes), keep (1 byte) and each
    scan's ego, and writes the grid of n_out voxels once; about 40 f32
    operations a ray for the geometry and 8 a live step, at the f32 rate."""
    return n_points * 13 + n_scans * 12 + n_out * 4, (40 * n_rays + 8 * n_pass) / F32_OPS_PER_S


def epilogue_bound(cfg, n_w, targets_w, n_out, mask):
    """What the moments epilogue (K3, K5) must move and compute on this data.
    n_w: the own-voxel count n on the padded window [Xp, Yp, Zp]; targets_w:
    bool [X, Y, Z], window layout, the voxels whose box is taken (the
    occupied ones with the mask on, all of them with it off; of a slab, only
    its rows); n_out: voxels of the output. It writes ten channels, reads
    hit when it masks, reads n over the voxels that a target's box reaches
    and the nine other channels where n > 0 there; about 52 operations per
    (target, non-empty neighbour) term. Returns (bytes, terms, reach,
    reach_nonempty)."""
    import torch

    from gvom_tpu_torch.ops import binning

    r = binning.moment_pad(cfg)
    box = tuple(2 * q + 1 for q in r)
    tp = torch.nn.functional.pad(targets_w.float(), (r[2], r[2], r[1], r[1], r[0], r[0]))
    reach = torch.nn.functional.max_pool3d(tp[None], box, stride=1, padding=r)[0] > 0
    nz = n_w > 0
    n_reach, n_reach_nz = int(reach.sum()), int((reach & nz).sum())
    counts = torch.nn.functional.avg_pool3d(nz[None].float(), box, stride=1)[0] * (box[0] * box[1] * box[2])
    terms = int(counts.round()[targets_w].sum())
    f32 = 4
    return ((n_out * f32 if mask else 0) + 10 * n_out * f32 + n_reach * f32 + 9 * n_reach_nz * f32, terms,
            n_reach, n_reach_nz)


def combine_bound(cfg, buf, world, target, new_hit):
    """(bytes, voxel counts) that K4 must move on this data, as fuse_plain
    reads its inputs: each slot's hit, miss and ten moment channels where it
    is aligned and valid, its min_height where it is also occupied; the old
    world's hit and evidence where it is aligned, its miss and min_height
    where its occupied voxel stays occupied (new_hit > 0: the new world's
    occupancy), its moments where it is aligned and the new world occupied;
    all fourteen of its channels when no slot is valid (it passes through);
    the meta vector and the ego; and the 14 channels and five [X, Y] maps
    written."""
    from gvom_tpu_torch.ops import grid as gridops

    X, Y, Z = cfg.grid_shape
    V, B, f32 = X * Y * Z, cfg.buffer_size, 4
    g, w = buf.grids, world.grid
    counts = dict(slot_aligned=[], slot_occupied=[])
    if not bool(buf.slot_valid.any()):
        words = 14 * V
    else:
        words = 0
        for i in range(B):
            al = gridops.overlap_mask(cfg, target, g.origin[i]) & buf.slot_valid[i]
            n_al, n_occ = int(al.sum()), int((al & (g.hit[i] > 0)).sum())
            counts["slot_aligned"].append(n_al)
            counts["slot_occupied"].append(n_occ)
            words += 12 * n_al + n_occ
        oal = gridops.overlap_mask(cfg, target, w.origin) & world.valid
        occ = new_hit > 0
        counts.update(old_aligned=int(oal.sum()), old_kept=int((oal & (w.hit > 0) & occ).sum()),
                      old_aligned_occupied=int((oal & occ).sum()))
        words += 2 * counts["old_aligned"] + 2 * counts["old_kept"] + 10 * counts["old_aligned_occupied"]
    words += (B + 2) * 4 + 3 + 14 * V + 5 * X * Y
    return words * f32, counts


def phase4_timings(cfg, buf, world, last, slab, rates, dev, log):
    """ms, plain_ms, library_ms and bound_ms of each kernel at the upstream
    shapes, on the last phase-1 scan and the phase-1 buffer and world, and of
    the slab forms on phase 1's slab."""
    import torch

    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import binning, kernels, moments, raycast
    from gvom_tpu_torch.ops import grid as gridops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    X, Y, Z = cfg.grid_shape
    V = X * Y * Z
    B = cfg.buffer_size
    p, origin, pn, keep, bins, target, ego = (last[k] for k in ("p", "origin", "pn", "keep", "bins", "target",
                                                                 "ego"))
    N = pn.shape[0]
    P = bins.sums[0].numel()
    passes = raycast.ray_pass_counts(cfg, p, keep, ego, origin)
    n_pass = int(passes.sum())
    n_kept = int(keep.sum())
    n_occ = int((bins.hit > 0).sum())
    slot = torch.zeros((1,), dtype=torch.int32, device=dev)
    out = torch.empty((1, 10, X, Y, Z), dtype=torch.float32, device=dev)

    # the same function in one PyTorch call, where there is one: K2's ten
    # own-voxel sums are one index_add_ of the points' values
    pflat, vals = index_add_inputs(cfg, pn, keep, origin)
    sums_lib = torch.zeros((10, P), dtype=torch.float32, device=dev)
    wconv = box_conv_weights(cfg, dev)
    conv_in = clean_sums(bins.sums)[None]
    conv = torch.nn.functional.conv3d(conv_in, wconv)[0]
    err_conv = float((conv - moments.box_aggregate_moments(cfg, bins.sums)).abs().max())
    log(f"library yardstick check: conv3d box vs plain box max abs err {err_conv}")

    rows = []

    def row(*a):
        rows.append(kernel_row(*a, log))

    # K1: reads the points, keep and the ego, builds each ray's geometry and
    # writes the grid (k1_bound); beside it the floor of one int32 atomic
    # per pass at the probe's rate, the bound of a design that merges no adds
    p1, k1, e1 = p[None], keep[None], ego.reshape(1, 3)
    row(kernels.RAY, lambda: kernels.ray_pass_counts(cfg, p1, k1, e1, origin),
        lambda: raycast.pass_counts_plain(cfg, p1, k1, e1, origin), 100, 3, None,
        *k1_bound(N, 1, n_kept, n_pass, V))
    rows[-1]["atomic_floor_ms"] = 1e3 * n_pass / rates["int32"]
    # K2: reads points and keep, writes hit, min_height, n and the nine
    # other channels where n > 0 (k2_bound); its library call is the
    # index_add_ of the ten sums into a buffer zeroed outside the timing: it
    # leaves out hit, min_height and every fill
    n_grid = int(bins.hit.sum())
    n_win = int(bins.sums[0].sum())
    n_nz = int((bins.sums[0] > 0).sum())
    row(kernels.BIN, lambda: kernels.bin_points(cfg, pn, keep, origin),
        lambda: binning.bin_points(cfg, pn, keep, origin), 20, 5,
        lambda: sums_lib.index_add_(1, pflat, vals), *k2_bound(N, n_kept, V, P, n_nz))
    rows[-1]["atomic_floor_ms"] = k2_atomic_floor_ms(n_grid, n_win, rates)
    # the timed launches computed what the wrapper computes
    _, timed = graph_ms(lambda: kernels.bin_points(cfg, pn, keep, origin), 10)
    exact("K2 timed launch vs the wrapper: hit", timed.hit, bins.hit)
    exact("K2 timed launch vs the wrapper: n", timed.sums[0], bins.sums[0])
    del timed
    # K3: reads hit and writes the slot's ten channels everywhere; reads the
    # sums only inside the ±r box of an occupied voxel (epilogue_bound)
    occ_w = gridops.torus_to_window(bins.hit > 0, origin)
    k3_bytes, terms, n_reach, n_reach_nz = epilogue_bound(cfg, bins.sums[0], occ_w, V, True)
    row(kernels.EPI, lambda: kernels.ingest_epilogue(cfg, bins.sums, bins.hit, origin, out, slot),
        lambda: moments.ingest_epilogue_plain(cfg, bins.sums, bins.hit, origin, out, slot), 20, 5,
        lambda: torch.nn.functional.conv3d(conv_in, wconv), k3_bytes, 52 * terms / F32_OPS_PER_S)
    # K2 then K3, one scan into the slot, against a bound that no design moves
    pair = pair_row("K2 then K3", lambda: kernels.ingest_epilogue(cfg, *binned(cfg, pn, keep, origin), origin, out,
                                                                  slot),
                    20, N, n_kept, V, terms, log)
    # K4: the kernel alone (its meta vector and outputs made once, outside
    # the timing), and the wrapper beside it; what the data makes it read
    # (combine_bound), 4 + 10 channels and five [X, Y] maps written
    launch, k4_out = kernels.combine_launch(cfg, buf, world, target, ego)
    launch()
    k4_bytes, k4_counts = combine_bound(cfg, buf, world, target, k4_out[0])
    row(kernels.CMB, launch, lambda: pipeline.fuse_plain(cfg, buf, world, target, ego), 20, 3, None,
        k4_bytes, 40 * V / F32_OPS_PER_S)
    rows[-1]["wrapper_ms"] = cuda_ms(lambda: kernels.combine(cfg, buf, world, target, ego), 20, warm=5)
    # the timed launches computed what the wrapper computes
    for name, a, b in zip(COMBINE_OUTPUTS, k4_out[:-1] + (k4_out[-1].bool(),),
                          kernels.combine(cfg, buf, world, target, ego)):
        exact(f"K4 timed launch vs the wrapper: {name}", a, b)
    log(f"timing combine wrapper (meta vector, outputs, launch): {rows[-1]['wrapper_ms']:.4f} ms; K4 reads "
        f"{k4_counts}")
    del k4_out

    # ---- the slab forms, on the slab that holds the window seam ----
    sp, sego, so, spn, skeep, sbins, yw = (slab[k] for k in ("p", "ego", "origin", "pn", "keep", "bins", "y_window"))
    ys0, Ys = yw
    Vs = X * Ys * Z
    Ps = sbins.sums[0].numel()
    # K1 slab: the same rays, the slab's grid; its passes are the steps that
    # land in the slab (the march itself walks every step of every ray)
    sp1, sk1, se1 = sp[None], skeep[None], sego.reshape(1, 3)
    n_pass_s = int(kernels.ray_pass_counts(cfg, sp1, sk1, se1, so, y_window=yw).sum())
    row(kernels.RAY_SLAB, lambda: kernels.ray_pass_counts(cfg, sp1, sk1, se1, so, y_window=yw),
        lambda: raycast.pass_counts_plain(cfg, sp1, sk1, se1, so, yw), 100, 3, None,
        *k1_bound(N, 1, int(skeep.sum()), n_pass_s, Vs))
    rows[-1]["atomic_floor_ms"] = 1e3 * n_pass_s / rates["int32"]
    # K2 slab: the same points, the slab's hit, min_height and scratch
    sflat, svals = index_add_inputs(cfg, spn, skeep, so, yw)
    s_lib = torch.zeros((10, Ps), dtype=torch.float32, device=dev)
    n_grid_s, n_win_s = int(sbins.hit.sum()), int(sbins.sums[0].sum())
    row(kernels.BIN_SLAB, lambda: kernels.bin_points(cfg, spn, skeep, so, yw),
        lambda: binning.bin_points(cfg, spn, skeep, so, yw), 20, 5,
        lambda: s_lib.index_add_(1, sflat, svals),
        *k2_bound(N, int(skeep.sum()), Vs, Ps, int((sbins.sums[0] > 0).sum())))
    rows[-1]["atomic_floor_ms"] = k2_atomic_floor_ms(n_grid_s, n_win_s, rates)
    # K5 slab, mask on (as ingest_scan calls it): K3's count on the slab's rows
    in_slab = torch.zeros((Y,), dtype=torch.bool, device=dev)
    in_slab[ys0:ys0 + Ys] = True
    targets = gridops.torus_to_window((slab["full_hit"] > 0) & in_slab[None, :, None], so)
    s_bytes, s_terms, _, _ = epilogue_bound(cfg, slab["full_n"], targets, Vs, True)
    s_conv_in = clean_sums(sbins.sums)[None]
    row(kernels.XBOX_SLAB, lambda: kernels.moments_epilogue(cfg, sbins.sums, sbins.hit, so, yw),
        lambda: moments.moments_epilogue_plain(cfg, sbins.sums, sbins.hit, so, yw), 20, 5,
        lambda: torch.nn.functional.conv3d(s_conv_in, wconv), s_bytes, 52 * s_terms / F32_OPS_PER_S)
    return rows, dict(slab=dict(y_window=list(yw), passes=n_pass_s, points_in_grid=n_grid_s,
                                points_in_scratch=n_win_s, box_terms=s_terms),
                      points_kept=n_kept, points_in_grid=n_grid, points_in_window=n_win, passes=n_pass,
                      scratch_nonempty=n_nz, pair_k2_k3=pair, occupied_voxels=n_occ, box_reach_voxels=n_reach, box_reach_nonempty=n_reach_nz,
                      box_terms=terms, atomic_rates_per_s=rates, conv_vs_plain_max_abs_err=err_conv)


def batched_cfg(cfg, batch):
    """cfg with the static DDA budget of a batched step over this batch's
    egos, as batched_replay derives it from a log's: the centered bound plus
    the worst in-batch ego drift."""
    from gvom_tpu_torch.engine.replay import batched_ray_steps

    egos = batch[2].cpu().numpy()
    return dataclasses.replace(cfg, ray_steps_override=batched_ray_steps(cfg, egos, len(egos)))


def make_batch(scans_dev, batch, step_index):
    """(scans [B,N,3], valid [B,N], egos [B,3]) of one batched step: the
    drive's distinct scans repeated, egos advancing (0.02, 0.01, 0) m per
    scan from a start that moves (0.3, 0.15, 0) m per step, each scan's
    points shifted rigidly with its ego (a replayed log's scans are captured
    AT their ego, so the work per step stays constant)."""
    import torch

    pts, masks, egos = scans_dev
    dev = pts.device
    reps = torch.arange(batch, device=dev) % pts.shape[0]
    ego0 = egos[0] + step_index * torch.tensor([0.3, 0.15, 0.0], device=dev)
    begos = ego0[None, :] + torch.arange(batch, dtype=torch.float32, device=dev)[:, None] * torch.tensor(
        [0.02, 0.01, 0.0], device=dev)
    shift = begos - egos[reps]
    return (pts[reps] + shift[:, None, :]).contiguous(), masks[reps].contiguous(), begos.contiguous()


@contextlib.contextmanager
def plain_kernels():
    """Inside, the batched step's two kernel wrappers run their plain
    versions on whatever device the tensors are on."""
    from gvom_tpu_torch.ops import kernels, moments, raycast

    saved = kernels.ray_pass_counts, kernels.point_moments
    kernels.ray_pass_counts = raycast.pass_counts_plain
    kernels.point_moments = moments.point_moments
    try:
        yield
    finally:
        kernels.ray_pass_counts, kernels.point_moments = saved


PRODUCT_FIELDS = ("origin", "height", "inferred_height", "slope_x", "slope_y", "roughness",
                  "guessed_height_delta", "positive_obstacle", "negative_obstacle", "visibility")


def same_world(what, a, b, atol, err=None):
    """Two worlds of the port: every channel bitwise but the nine non-n
    moments. Returns the moments' max abs error."""
    for name in ("hit", "miss", "min_height", "origin"):
        exact(f"{what}: {name}", getattr(a.grid, name), getattr(b.grid, name))
    exact(f"{what}: evidence", a.evidence, b.evidence)
    check(bool(a.valid) == bool(b.valid), f"{what}: valid")
    return moments_close(f"{what}:", a.grid.mom, b.grid.mom, atol)


def phase5_batched(cfg, scans, rates, dev, log, err, profile=False):
    """The batched step at the upstream config. Two steps of BATCH_CHECK
    scans against the same step with the kernels swapped for their plain
    versions; then two steps of BATCH scans, timed, with the launch counts
    set to 0 just before and read just after; then K2 and K5 against their
    plain versions, and their times and bounds, on the merged points of a
    whole batch."""
    import numpy as np
    import torch

    from gvom_tpu_torch import make_batched_step
    from gvom_tpu_torch.parallel.sharding import prepare_batch
    from gvom_tpu_torch.ops import binning, kernels, moments
    from gvom_tpu_torch.ops import grid as gridops
    from gvom_tpu_torch.types import empty_world_state

    scans_dev = (torch.stack([torch.from_numpy(p) for p, _, _ in scans]).to(dev),
                 torch.stack([torch.from_numpy(v) for _, v, _ in scans]).to(dev),
                 torch.from_numpy(np.stack([e for _, _, e in scans]).astype(np.float32)).to(dev))
    X, Y, Z = cfg.grid_shape
    V = X * Y * Z

    # ---- against the plain versions, a batch small enough for the plain raycast ----
    # (at the full batch's ray budget, so the kernel configuration that is held here is the one timed below)
    batches = [make_batch(scans_dev, BATCH, i) for i in range(2)]
    cb = batched_cfg(cfg, batches[0])
    step4 = make_batched_step(cb)
    wk = wp = empty_world_state(cfg, dev)
    for i in range(2):
        b = make_batch(scans_dev, BATCH_CHECK, i)
        wk, pk = step4(wk, *b)
        with plain_kernels():
            wp, pp = step4(wp, *b)
        e = same_world(f"batched step {i} of {BATCH_CHECK} scans", wk, wp, MOM_ATOL_BATCH)
        share4 = tol_share(wk.grid.mom, wp.grid.mom, MOM_ATOL_BATCH)
        err["moments_epilogue"] = max(err["moments_epilogue"], e)
        for name in PRODUCT_FIELDS:
            exact(f"batched step {i} product {name}", getattr(pk, name), getattr(pp, name))
    log(f"phase 5: two batched steps of {BATCH_CHECK} scans (ray_steps {cb.ray_steps}, the full batch's) agree with the same steps on "
        f"the plain versions; world occupied {int((wk.grid.hit > 0).sum())}, moments max abs err {e} "
        f"({100 * share4:.1f} % of the tolerance rtol={MOM_RTOL} atol={MOM_ATOL_BATCH})")
    del wk, wp, pk, pp

    # ---- the full batch ----
    step = make_batched_step(cb)
    step(empty_world_state(cfg, dev), *batches[0])      # warm: allocator and kernels
    torch.cuda.synchronize()
    world = empty_world_state(cfg, dev)
    step_ms, step_wall_ms = [], []
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    for i, b in enumerate(batches):
        a, z = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        a.record()
        world, products = step(world, *b)
        z.record()
        torch.cuda.synchronize()
        step_wall_ms.append(1e3 * (time.perf_counter() - t0))
        step_ms.append(a.elapsed_time(z))
        if i == 0:
            first_origin = world.grid.origin
    launches = {k.name: k.launches for k in kernels.KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = dict(ray_pass_counts=2, bin_points=2, moments_epilogue=2)
    for name, n in want.items():
        check(launches[name] == n, f"batched path: {name} launched {launches[name]} times, expected {n}")
    for name in PRODUCT_FIELDS[1:]:
        a = getattr(products, name)
        check(tuple(a.shape) == cfg.map_shape and bool(torch.isfinite(a.float()).all()), f"batched product {name}")
    fresh, _ = step(empty_world_state(cfg, dev), *batches[1])
    kept = int(((world.grid.hit > 0) & ~(fresh.grid.hit > 0)).sum())
    check(not torch.equal(first_origin, world.grid.origin), "batched path: the origin did not move between steps")
    check(kept > 0, "batched path: the second step kept no voxel of the first step's world")
    check(int(products.visibility.sum()) > 0 and int((products.positive_obstacle > 0).sum()) > 0,
          "batched path: empty maps")
    check(bool((world.grid.mom[:, world.grid.hit == 0] == 0).all()), "batched path: moments outside the occupancy")
    res = dict(batch=BATCH, ray_steps=cb.ray_steps, check_tolerance_share=share4, step_ms=step_ms, step_wall_ms=step_wall_ms,
               scans_per_s=[1e3 * BATCH / t for t in step_wall_ms], peak_bytes=peak,
               world_occupied=int((world.grid.hit > 0).sum()), kept_from_first_step=kept,
               visible_cells=int(products.visibility.sum()))
    log(f"phase 5 batched path: two steps of {BATCH} scans of {scans_dev[0].shape[1]} points (ray_steps "
        f"{cb.ray_steps}); launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}; step "
        f"{step_ms[0]:.2f} and {step_ms[1]:.2f} ms (CUDA events), {step_wall_ms[0]:.2f} and {step_wall_ms[1]:.2f} ms "
        f"(host clock with sync) = {res['scans_per_s'][1]:.1f} scans/s; peak device memory {peak / 2**30:.3f} GiB; "
        f"world occupied {res['world_occupied']} ({kept} kept from the first step)")
    del fresh, world

    # ---- K5 and K2 on a whole batch's merged points ----
    origin, pw, keep = prepare_batch(cb, *batches[1])
    k1 = phase5_raycast_batch(cb, pw, keep, batches[1][2], origin, rates, log)
    pn = gridops.map_local(cb, pw, origin)
    bins = kernels.bin_points(cb, pn, keep, origin)
    pb = binning.bin_points(cb, pn, keep, origin)
    what = f"K2 on {BATCH} scans' merged points"
    exact(f"{what}: hit", bins.hit, pb.hit)
    exact(f"{what}: min_height", bins.min_height, pb.min_height)
    e2 = sums_close(what, bins.sums, pb.sums, MOM_ATOL_BATCH)
    err["bin_points"] = max(err["bin_points"], e2)
    nz = pb.sums[0] > 0
    log(f"{what} vs plain: hit, min_height and n bitwise, sums where n > 0 max abs err {e2}, "
        f"{100 * tol_share(bins.sums[:, nz], pb.sums[:, nz], MOM_ATOL_BATCH):.1f} % of the tolerance (largest "
        f"voxel hit count {int(bins.hit.max())})")
    del pb, nz
    pm = moments.moments_epilogue_plain(cb, bins.sums, bins.hit, origin, occupancy_mask=False)
    km = kernels.moments_epilogue(cb, bins.sums, bins.hit, origin, occupancy_mask=False)
    e = moments_close(f"K5 mask off on {BATCH} scans' merged points", km, pm, MOM_ATOL_BATCH)
    err["moments_epilogue"] = max(err["moments_epilogue"], e)
    log(f"K5 mask off on {BATCH} scans' merged points vs plain: max abs err {e}, "
        f"{100 * tol_share(km, pm, MOM_ATOL_BATCH):.1f} % of the tolerance (largest voxel count "
        f"{int(bins.sums[0].max())})")
    del pm, km
    nan_blind(f"K5 mask off on {BATCH} scans' merged points",
              lambda s: kernels.moments_epilogue(cb, s, bins.hit, origin, occupancy_mask=False), bins.sums)
    wconv = box_conv_weights(cb, dev)
    conv_in = clean_sums(bins.sums)[None]
    everywhere = torch.ones((X, Y, Z), dtype=torch.bool, device=dev)
    k5_bytes, k5_terms, _, k5_nz = epilogue_bound(cb, bins.sums[0], everywhere, V, False)
    row = kernel_row(kernels.XBOX,
                     lambda: kernels.moments_epilogue(cb, bins.sums, bins.hit, origin, occupancy_mask=False),
                     lambda: moments.moments_epilogue_plain(cb, bins.sums, bins.hit, origin, occupancy_mask=False),
                     20, 5, lambda: torch.nn.functional.conv3d(conv_in, wconv), k5_bytes,
                     52 * k5_terms / F32_OPS_PER_S, log)
    # K2 at N = BATCH · max_points (its row in the kernels line is one scan's)
    N, P = pn.shape[0], bins.sums[0].numel()
    n_kept, n_grid, n_win = int(keep.sum()), int(bins.hit.sum()), int(bins.sums[0].sum())
    n_nz = int((bins.sums[0] > 0).sum())
    k2_ms, _ = graph_ms(lambda: kernels.bin_points(cb, pn, keep, origin), 20)
    k2_wrapper_ms = cuda_ms(lambda: kernels.bin_points(cb, pn, keep, origin), 10)
    k2_plain_ms = cuda_ms(lambda: binning.bin_points(cb, pn, keep, origin), 3)
    k2_bytes, k2_ops_s = k2_bound(N, n_kept, V, P, n_nz)
    k2_bound_ms = 1e3 * max(k2_bytes / HBM_BYTES_PER_S, k2_ops_s)
    pflat, vals = index_add_inputs(cb, pn, keep, origin)
    sums_lib = torch.zeros((10, P), dtype=torch.float32, device=dev)
    k2_lib_ms = cuda_ms(lambda: sums_lib.index_add_(1, pflat, vals), 10)
    del pflat, vals, sums_lib
    k5_on_ms, _ = graph_ms(lambda: kernels.moments_epilogue(cb, bins.sums, bins.hit, origin), 20)
    log(f"timing bin_points on {N} merged points: launch alone {k2_ms:.4f} ms, wrapper {k2_wrapper_ms:.4f} ms; "
        f"plain {k2_plain_ms:.4f} ms; index_add_ of the ten sums (hit, min_height and the fills left out) "
        f"{k2_lib_ms:.4f} ms; bound {k2_bound_ms:.4f} ms (bytes {1e3 * k2_bytes / HBM_BYTES_PER_S:.4f} ms); one "
        f"atomic a point and channel at the probe's rate {k2_atomic_floor_ms(n_grid, n_win, rates):.4f} ms; "
        f"moments_epilogue with the mask on, same sums: launch alone {k5_on_ms:.4f} ms")
    # K2 then K5, as the batched step launches them, against a bound that no design moves
    pair = pair_row("K2 then K5 (mask off)",
                    lambda: kernels.moments_epilogue(cb, *binned(cb, pn, keep, origin), origin,
                                                     occupancy_mask=False),
                    20, N, n_kept, V, k5_terms, log)
    res.update(merged=dict(points=N, points_kept=n_kept, points_in_grid=n_grid, points_in_window=n_win,
                           scratch_nonempty=n_nz, nonempty_voxels=k5_nz, box_terms=k5_terms,
                           max_voxel_count=int(bins.sums[0].max()),
                           bin_points_ms=k2_ms, bin_points_wrapper_ms=k2_wrapper_ms,
                           bin_points_plain_ms=k2_plain_ms, bin_points_bound_ms=k2_bound_ms,
                           bin_points_index_add_ms=k2_lib_ms,
                           bin_points_atomic_floor_ms=k2_atomic_floor_ms(n_grid, n_win, rates),
                           moments_epilogue_mask_on_ms=k5_on_ms, pair_k2_k5=pair),
               ray_pass_counts_batch=k1)
    if profile:
        w0 = empty_world_state(cfg, dev)    # the step leaves its input world untouched
        res["profile"] = profile_calls(dict(batched_step=lambda: step(w0, *batches[0])), log)
    return launches, row, res


def phase5_raycast_batch(cfg, pw, keep, egos, origin, rates, log):
    """K1 on a whole batch of S scans in one launch: timed, with its bound,
    and held bitwise against the sum of its S one-scan launches over the
    same scans (those are held against the plain twin in phase 1 and in the
    4-scan step; the plain twin would take about a second a scan here)."""
    import torch

    from gvom_tpu_torch.ops import kernels

    S = egos.shape[0]
    pts, kp = pw.view(S, -1, 3), keep.view(S, -1)
    N = pts.shape[1]
    V = cfg.voxel_count
    whole = kernels.ray_pass_counts(cfg, pts, kp, egos, origin)
    summed = torch.zeros_like(whole)
    for s in range(S):
        kernels.ray_pass_counts(cfg, pts[s:s + 1], kp[s:s + 1], egos[s:s + 1], origin, out=summed)
    exact(f"K1 on {S} scans in one launch vs the sum of {S} one-scan launches", whole, summed)
    n_pass, n_rays = int(whole.sum()), int(kp.sum())
    ms = cuda_ms(lambda: kernels.ray_pass_counts(cfg, pts, kp, egos, origin), 10)
    ms_per_scan = cuda_ms(lambda: [kernels.ray_pass_counts(cfg, pts[s:s + 1], kp[s:s + 1], egos[s:s + 1], origin,
                                                           out=summed) for s in range(S)], 3)
    nbytes, ops_s = k1_bound(S * N, S, n_rays, n_pass, V)
    bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops_s
    r = dict(scans=S, rays=n_rays, passes=n_pass, ms=ms, one_launch_per_scan_ms=ms_per_scan,
             bound_ms=max(bytes_ms, ops_ms), bound_by="bytes" if bytes_ms >= ops_ms else "operations",
             bytes_ms=bytes_ms, ops_ms=ops_ms, atomic_floor_ms=1e3 * n_pass / rates["int32"])
    log(f"timing ray_pass_counts on {S} scans ({n_rays} rays, {n_pass} passes, ray_steps {cfg.ray_steps}): one "
        f"launch {ms:.4f} ms, {S} one-scan launches {ms_per_scan:.4f} ms, bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']}; bytes {bytes_ms:.4f} ms, operations {ops_ms:.4f} ms), one atomic a pass at the "
        f"probe's rate {r['atomic_floor_ms']:.4f} ms; bitwise equal to the sum of the one-scan launches")
    return r


def phase6_replay(log):
    """batched_replay over a synthesized log on a small grid, on the card
    against the CPU (which runs the plain versions), with a checkpoint
    written after every batch, loaded, and the resumed run's world equal to
    the straight run's."""
    import numpy as np

    from gvom_tpu_torch import GvomConfig, batched_replay
    from gvom_tpu_torch.engine.replay import batched_ray_steps
    from gvom_tpu_torch.io.logio import synthesize_log
    from gvom_tpu_torch.utils import convert
    from gvom_tpu_torch.utils.checkpoint import load_world

    cfg = GvomConfig(xy_size=64, z_size=32, max_points=4096, buffer_size=3)
    slog = synthesize_log(8, channels=32, azimuth_steps=128, max_range=25.0, seed=1)
    # pin the budget, so a resumed run rasterizes as the straight one did
    egos = np.stack([e for _, e, _ in slog])
    cfg = dataclasses.replace(cfg, ray_steps_override=batched_ray_steps(cfg, egos, 4))
    with tempfile.TemporaryDirectory() as tmp:
        world, prods, met = batched_replay(cfg, slog, 4, checkpoint_dir=tmp, checkpoint_every=1)
        files = sorted(os.listdir(tmp))
        check(files == ["world_b1.npz", "world_b2.npz"], f"replay checkpoints: {files}")
        resumed, prods2, met2 = batched_replay(cfg, slog, 4, resume_from=os.path.join(tmp, "world_b1.npz"),
                                               skip_batches=1)
        final = load_world(os.path.join(tmp, "world_b2.npz"))
    cpu_world, cpu_prods, _ = batched_replay(cfg, slog, 4, device="cpu")
    check(len(prods) == 2 and len(prods2) == 1 and met2.snapshot()["counters"]["skipped_batches"] == 1,
          "replay: batch counts")
    same_world("resumed replay vs straight", resumed, world, MOM_ATOL)
    exact("checkpoint of the last batch: hit", final.grid.hit, world.grid.hit)
    exact("checkpoint of the last batch: moments", final.grid.mom, world.grid.mom)
    a, b = convert.to_numpy(world), convert.to_numpy(cpu_world)
    for k in a:
        if k == "mom":
            check(bool(np.array_equal(a[k][0], b[k][0])), "replay vs CPU: moment n differs")
            check(bool(np.allclose(a[k], b[k], rtol=MOM_RTOL, atol=MOM_ATOL)), "replay vs CPU: moments")
        else:
            check(bool(np.array_equal(a[k], b[k])), f"replay vs CPU: {k} differs")
    for name in ("positive_obstacle", "negative_obstacle", "visibility", "height"):
        check(bool(np.array_equal(getattr(prods[-1], name).cpu().numpy(), getattr(cpu_prods[-1], name).numpy())),
              f"replay vs CPU: product {name}")
    log(f"phase 6: batched_replay of 8 scans in batches of 4 on a 64×64×32 grid matches the CPU replay; resumed "
        f"from the first checkpoint it ends in the straight run's world ({int((world.grid.hit > 0).sum())} occupied)")


def phase_end_to_end(cfg, scans, dev, log):
    """Device time (CUDA events) of the warmed per-scan ingest and combine,
    called through the pipeline on tensors already on the card."""
    import torch

    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

    buf, world = empty_buffer_state(cfg, dev), empty_world_state(cfg, dev)
    inputs = [(torch.from_numpy(p).to(dev), torch.from_numpy(v).to(dev),
               torch.tensor(e, dtype=torch.float32, device=dev)) for p, v, e in scans]
    state = dict(world=world, i=0)

    def ingest():
        p, v, e = inputs[state["i"] % len(inputs)]
        state["i"] += 1
        pipeline.ingest_and_insert(cfg, buf, p, v, e)

    def combine():
        state["world"] = pipeline.combine(cfg, buf, state["world"], inputs[0][2])[0]

    ingest_ms = cuda_ms(ingest, 2 * len(inputs), warm=len(inputs))
    combine_ms = cuda_ms(combine, 10, warm=2)
    torch.cuda.reset_peak_memory_stats()
    ingest()
    combine()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"end to end (CUDA events, warm): ingest_and_insert {ingest_ms:.4f} ms/scan, combine "
        f"{combine_ms:.4f} ms, peak device memory {peak / 2**30:.3f} GiB")
    return dict(ingest_ms=ingest_ms, combine_ms=combine_ms, peak_bytes=peak)


def profile_calls(steps, log):
    """torch.profiler over one warm call of each function in `steps`: device
    time by kernel, kernel launches, and the device's busy share of the
    host-clock span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in steps.items():
        fn()
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0)
        kern = [ev for ev in prof.events() if ev.device_type == torch.autograd.DeviceType.CUDA]
        dev_us = sum(ev.time_range.elapsed_us() for ev in kern)
        by_name = {}
        for ev in kern:
            by_name.setdefault(ev.name, [0, 0.0])
            by_name[ev.name][0] += 1
            by_name[ev.name][1] += ev.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        out[name] = dict(wall_us=wall_us, device_us=dev_us, launches=len(kern), busy_share=dev_us / wall_us,
                         top=[dict(kernel=k[:120], count=c, device_us=t) for k, (c, t) in top])
        log(f"profile {name}: host span {wall_us:.1f} us, device busy {dev_us:.1f} us "
            f"({100 * dev_us / wall_us:.1f} %), {len(kern)} kernel launches; top by device time:")
        for k, (c, t) in top[:8]:
            log(f"    {t:10.1f} us  x{c:<5d} {k[:100]}")
    return out


def phase_profile(cfg, scans, dev, log):
    """torch.profiler over one warm ingest_and_insert and one warm combine."""
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

    buf, world = empty_buffer_state(cfg, dev), empty_world_state(cfg, dev)
    p, v, e = scan_tensors(scans[0], dev)
    return profile_calls(dict(ingest=lambda: pipeline.ingest_and_insert(cfg, buf, p, v, e),
                              combine=lambda: pipeline.combine(cfg, buf, world, e)), log)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--scans", type=int, default=8, help="scans of the facade drive (default 8)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one ingest, one combine and one batched step with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        from gvom_tpu_torch import GvomConfig
        from gvom_tpu_torch.ops import kernels
    except ImportError as e:
        print(f"chip_smoke: the gvom_tpu_torch package is not beside this script: {e}", file=sys.stderr)
        return 3

    def log(msg):
        print(msg, flush=True)

    report = {}
    t0 = time.perf_counter()
    probe = kernels.CudaKernel("atomic_rate", "atomic_rate.cu", "gvom_atomic_rate",
                               [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
                               "not a TPU kernel: a probe of the card's atomic rate")
    probe_build = probe.start_build()
    reports = kernels.build_all()
    reports[probe.name] = probe.finish_build(probe_build)
    report["build_s"] = time.perf_counter() - t0
    for source, text in sorted({k.source.name: reports[k.name] for k in kernels.KERNELS + [probe]}.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {source}: {line.strip()}")
    log(f"built {len({k.source for k in kernels.KERNELS + [probe]})} kernel libraries in {report['build_s']:.1f} s")

    dev = torch.device(DEVICE)
    cfg = GvomConfig()
    t0 = time.perf_counter()
    scans = make_scans(cfg, max(args.scans, 4), LIDAR)
    log(f"made {len(scans)} scans of {int(scans[0][1].sum())} points in {time.perf_counter() - t0:.1f} s "
        f"(grid {cfg.grid_shape}, buffer {cfg.buffer_size})")

    err, buf, world, last = phase1_kernels_vs_plain(cfg, scans[:4], dev, log)
    phase1_combine_other_b(dev, log)
    slab_launches, slab = phase1_slabs(cfg, scans[0], dev, log, err)
    phase1_near_tier(cfg, scans[1], dev, log)
    launches, report["facade"], _ = phase2_facade(cfg, scans, log)
    phase3_small_reference(log)
    rates = atomic_rates(probe, dev, log)
    rows, report["inputs"] = phase4_timings(cfg, buf, world, last, slab, rates, dev, log)
    del buf, world, last, slab
    report["end_to_end"] = phase_end_to_end(cfg, scans, dev, log)
    batched_launches, k5_row, report["batched"] = phase5_batched(cfg, scans, rates, dev, log, err, args.profile)
    phase6_replay(log)
    if args.profile:
        report["profile"] = phase_profile(cfg, scans, dev, log)

    # each kernel's launches on the path that is its own: the facade's for
    # K1-K4, the batched step's for K5, ingest_scan(y_window=)'s for the slabs
    rows.insert(4, k5_row)
    for r in rows:
        own = (slab_launches if r["name"].endswith("_slab") else
               batched_launches if r["name"] == "moments_epilogue" else launches)
        r["launches"] = own[r["name"]]
        r["launches_batched_path"] = batched_launches[r["name"]]
        r["launches_slab_path"] = slab_launches[r["name"]]
        r["max_abs_err"] = err[r["name"]]
        check(r["launches"] > 0, f"kernel {r['name']} was launched no time on its path")
    check([r["name"] for r in rows] == [k.name for k in kernels.KERNELS], "the kernels line misses a kernel")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    line = {"kernels": [{k: r[k] for k in keys + ("atomic_floor_ms", "wrapper_ms") if k in r} for r in rows]}
    smi = []
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip().splitlines()
    report.update(kernels=rows, nvidia_smi=smi[0] if smi else None, torch=torch.__version__,
                  cuda=torch.version.cuda, device=torch.cuda.get_device_name(0))
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(report, indent=1))
    print(json.dumps(line))
    print(smi[0] if smi else "nvidia-smi: no reading")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
