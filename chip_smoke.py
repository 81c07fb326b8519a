#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gvom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json] [--scans N]

Builds the main path's four CUDA kernels from gvom_tpu_torch/csrc (one nvcc
per source, all started together), then, at the upstream deployment (a
256×256×64 grid at 0.4 m, a ring buffer of 4 scans, 131,072 points per
scan from a synthetic OS1-128 sweep of the composite terrain, made from
fixed seeds):

  1. holds each kernel against its plain PyTorch version on the card, on the
     same inputs, over a drive with a moving ego (re-origin, decay veto):
     K1 pass counts, K2 hit and min_height and the moment count n, and every
     K4 output but the moments bitwise; the other moment channels within
     MOM_RTOL / MOM_ATOL (f32 sums in another order);
  2. drives the port's Gvom facade (process_pointcloud, then combine_maps
     after each scan) with every kernel's launch count set to 0 just before
     and read just after, and checks the 5-tuple it returns;
  3. checks the facade's outputs and ring buffer on a small grid, over a
     drive with one degenerate scan, against the same facade on the CPU,
     which runs the plain versions (the CPU tests pin those to the JAX
     package);
  4. times each kernel, its plain version and, where one exists, a PyTorch
     call that computes the same function, with CUDA events, and computes
     each kernel's bound from this run's inputs: the bytes it must move
     over the memory rate, or its operations over their rate, whichever is
     larger. K1's and K2's operations are atomics, whose rate the script
     measures with a probe kernel (csrc/atomic_rate.cu).

Prints the timings, one JSON line {"kernels": [...]}, the card's name and
power limit, and as its last line {"ok": true, "device": {...}}. Exits
non-zero without that line when there is no CUDA device or a phase fails.
--out also writes every number to a JSON file.
"""

from __future__ import annotations

import argparse
import ctypes
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

ROOT = Path(__file__).resolve().parent

# f32 moment sums taken in another order (atomics, the 27-voxel box) than the
# plain version's: relative error grows with the number of terms, up to a few
# thousand near the ego
MOM_RTOL = 1e-4
MOM_ATOL = 1e-3
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


def close(name, a, b):
    import torch

    check(a.shape == b.shape, f"{name}: shape {a.shape} vs {b.shape}")
    ok = torch.isclose(a, b, rtol=MOM_RTOL, atol=MOM_ATOL)
    n = int((~ok).sum())
    err = float((a - b).abs().max()) if a.numel() else 0.0
    check(n == 0, f"{name}: {n} elements outside rtol={MOM_RTOL} atol={MOM_ATOL} (max abs err {err})")
    return err


def cuda_ms(fn, reps, warm=1):
    """Mean device time of fn() over reps calls, after warm calls."""
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

        passes = kernels.ray_pass_counts(cfg, m, origin)
        exact("K1 passes", passes, raycast.ray_pass_counts_plain(cfg, m, origin))

        kb, pb = kernels.bin_points(cfg, pn, keep, origin), binning.bin_points(cfg, pn, keep, origin)
        exact("K2 hit", kb.hit, pb.hit)
        exact("K2 min_height", kb.min_height, pb.min_height)
        exact("K2 n", kb.sums[0], pb.sums[0])
        err["bin_points"] = max(err["bin_points"], close("K2 sums", kb.sums, pb.sums))

        slot = torch.ones((1,), dtype=torch.int32, device=dev)
        ko = torch.zeros((2, 10, X, Y, Z), dtype=torch.float32, device=dev)
        po = torch.zeros_like(ko)
        kernels.ingest_epilogue(cfg, kb.sums, kb.hit, origin, ko, slot)
        moments.ingest_epilogue_plain(cfg, kb.sums, kb.hit, origin, po, slot)
        exact("K3 untouched slot", ko[0], po[0])
        exact("K3 n", ko[1, 0], po[1, 0])
        err["ingest_epilogue"] = max(err["ingest_epilogue"], close("K3 moments", ko[1], po[1]))
        del ko, po, pb

        buf, scan_ok = pipeline.ingest_and_insert(cfg, buf, pts, valid, ego)
        check(bool(scan_ok), f"scan {i} has no occupied voxel")
        target = buf.grids.origin.index_select(0, buf.last_slot.reshape(1).long())[0]
        ko = kernels.combine(cfg, buf, world, target, ego)
        po = pipeline.fuse_plain(cfg, buf, world, target, ego)
        names = ("hit", "miss", "min_height", "evidence", "mom", "height", "inferred_height",
                 "band_hit_sum", "band_total_sum", "band_ok")
        for name, a, b in zip(names, ko, po):
            if name == "mom":
                err["combine"] = max(err["combine"], close("K4 mom", a, b))
            else:
                exact(f"K4 {name}", a, b)
        del ko, po
        world, products, ok = pipeline.combine(cfg, buf, world, ego)
        check(bool(ok), f"combine after scan {i} reports an empty buffer")
        revived = int(((world.grid.hit > 0) & (buf.grids.hit[buf.last_slot.long()] == 0)).sum())
        log(f"phase 1 scan {i}: origin {origin.tolist()}, {int(keep.sum())} points kept, "
            f"{int((kb.hit > 0).sum())} occupied voxels, {int(passes.sum())} passes, "
            f"world occupied {int((world.grid.hit > 0).sum())} ({revived} not in the newest scan): "
            "K1-K4 agree with their plain versions")
        last = dict(pts=pts, valid=valid, ego=ego, m=m, origin=origin, pn=pn, keep=keep, bins=kb,
                    target=target)
    return err, buf, world, last


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
    for name, n in launches.items():
        check(n > 0, f"kernel {name} was not launched on the main path")
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
    from gvom_tpu_torch.utils import convert

    cfg = GvomConfig(xy_size=64, z_size=32, max_points=4096, buffer_size=3)
    scans = make_scans(cfg, 5, dict(channels=32, azimuth_steps=128))
    near = np.random.default_rng(0).uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
    scans[2] = (near, np.ones(len(near), bool), scans[2][2])
    gpu, cpu = Gvom(config=cfg), Gvom(config=cfg, device="cpu")
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


def phase4_timings(cfg, buf, world, last, rates, dev, log):
    """ms, plain_ms, library_ms and bound_ms of each kernel at the upstream
    shapes, on the last phase-1 scan and the phase-1 buffer and world."""
    import torch

    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import binning, kernels, moments, raycast
    from gvom_tpu_torch.ops import grid as gridops

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    X, Y, Z = cfg.grid_shape
    V = X * Y * Z
    B = cfg.buffer_size
    m, origin, pn, keep, bins, target, ego = (last[k] for k in ("m", "origin", "pn", "keep", "bins", "target",
                                                                 "ego"))
    N = pn.shape[0]
    P = bins.sums[0].numel()
    passes = kernels.ray_pass_counts(cfg, m, origin)
    n_pass = int(passes.sum())
    n_kept = int(keep.sum())
    n_occ = int((bins.hit > 0).sum())
    slot = torch.zeros((1,), dtype=torch.int32, device=dev)
    out = torch.empty((1, 10, X, Y, Z), dtype=torch.float32, device=dev)

    # the same function in one PyTorch call, where there is one: K2's ten
    # own-voxel sums are one index_add_ of the points' values
    vox = torch.floor(pn).to(torch.int32)
    vp = vox + torch.tensor(binning.moment_pad(cfg), dtype=torch.int32, device=dev)
    pshape = torch.tensor(binning.padded_shape(cfg), dtype=torch.int32, device=dev)
    sel = keep & torch.all((vp >= 0) & (vp < pshape), dim=1)
    vp = vp[sel].long()
    Yp, Zp = binning.padded_shape(cfg)[1:]
    pflat = (vp[:, 0] * Yp + vp[:, 1]) * Zp + vp[:, 2]
    lk = pn[sel] - vox[sel].float()
    vals = torch.stack([torch.ones_like(lk[:, 0]), lk[:, 0], lk[:, 1], lk[:, 2]]
                       + [lk[:, a] * lk[:, b] for a, b in binning.PAIRS], dim=0).contiguous()
    sums_lib = torch.zeros((10, P), dtype=torch.float32, device=dev)
    wconv = box_conv_weights(cfg, dev)
    conv_in = bins.sums[None]
    conv = torch.nn.functional.conv3d(conv_in, wconv)[0]
    err_conv = float((conv - moments.box_aggregate_moments(cfg, bins.sums)).abs().max())
    log(f"library yardstick check: conv3d box vs plain box max abs err {err_conv}")

    f32 = 4
    rows = []

    def row(k, fn, plain, reps, plain_reps, lib, bytes_moved, ops_s):
        """ops_s: the least time of the kernel's operations (float32 arithmetic
        at the published rate, or atomics at the probed rate)."""
        ms = cuda_ms(fn, reps)
        pms = cuda_ms(plain, plain_reps)
        lms = cuda_ms(lib, reps) if lib is not None else None
        bytes_s = bytes_moved / HBM_BYTES_PER_S
        b_ms = 1e3 * max(bytes_s, ops_s)
        rows.append(dict(name=k.name, route="cuda", source=str(k.source.relative_to(ROOT)),
                         replaces=k.replaces.split(" ")[0], ms=ms, plain_ms=pms, bound_ms=b_ms,
                         bound_by="bytes" if bytes_s >= ops_s else "operations",
                         library_ms=lms, bytes=bytes_moved, bytes_ms=1e3 * bytes_s, ops_ms=1e3 * ops_s))
        log(f"timing {k.name}: kernel {ms:.4f} ms, plain {pms:.4f} ms, library "
            f"{'n/a' if lms is None else f'{lms:.4f} ms'}, bound {b_ms:.4f} ms ({rows[-1]['bound_by']}; "
            f"bytes {1e3 * bytes_s:.4f} ms, operations {1e3 * ops_s:.4f} ms)")

    # K1: reads the per-ray march inputs, writes the grid; one int32 atomic
    # (and about 8 float operations) per live ray step
    row(kernels.RAY, lambda: kernels.ray_pass_counts(cfg, m, origin),
        lambda: raycast.ray_pass_counts_plain(cfg, m, origin), 20, 3, None,
        N * (3 + 1 + 1 + 1) * f32 + V * f32,
        max(8 * n_pass / F32_OPS_PER_S, n_pass / rates["int32"]))
    # K2: reads points and keep, writes hit, min_height and the padded sums;
    # two int32 atomics per in-grid point (hit, min_height), ten float32
    # atomics per point inside the padded window
    n_grid = int(bins.hit.sum())
    n_win = int(bins.sums[0].sum())
    row(kernels.BIN, lambda: kernels.bin_points(cfg, pn, keep, origin),
        lambda: binning.bin_points(cfg, pn, keep, origin), 20, 5,
        lambda: sums_lib.index_add_(1, pflat, vals),
        N * (3 * f32 + 1) + 2 * V * f32 + 10 * P * f32,
        max(30 * n_kept / F32_OPS_PER_S, 2 * n_grid / rates["int32"] + 10 * n_win / rates["float32"]))
    # K3: reads hit and writes the slot's ten channels everywhere; reads the
    # sums only inside the ±r box of an occupied voxel: n there, and the
    # other nine channels where n > 0. About 52 operations per (occupied
    # voxel, non-empty neighbour) term
    r = binning.moment_pad(cfg)
    box = tuple(2 * q + 1 for q in r)
    occ_w = gridops.torus_to_window((bins.hit > 0).float(), origin)
    occ_p = torch.nn.functional.pad(occ_w, (r[2], r[2], r[1], r[1], r[0], r[0]))
    reach = torch.nn.functional.max_pool3d(occ_p[None], box, stride=1, padding=r)[0] > 0
    nz = bins.sums[0] > 0
    n_reach, n_reach_nz = int(reach.sum()), int((reach & nz).sum())
    terms = int((torch.nn.functional.avg_pool3d(nz[None].float(), box, stride=1)[0] * (box[0] * box[1] * box[2])
                 ).round()[occ_w > 0].sum())
    row(kernels.EPI, lambda: kernels.ingest_epilogue(cfg, bins.sums, bins.hit, origin, out, slot),
        lambda: moments.ingest_epilogue_plain(cfg, bins.sums, bins.hit, origin, out, slot), 20, 5,
        lambda: torch.nn.functional.conv3d(conv_in, wconv),
        V * f32 + 10 * V * f32 + n_reach * f32 + 9 * n_reach_nz * f32, 52 * terms / F32_OPS_PER_S)
    # K4: reads B slots and the old world (3 channels + moments, and the
    # evidence), writes 4 channels, the moments and five [X, Y] maps
    row(kernels.CMB, lambda: kernels.combine(cfg, buf, world, target, ego),
        lambda: pipeline.fuse_plain(cfg, buf, world, target, ego), 20, 3, None,
        (B + 1) * (3 + 10) * V * f32 + V * f32 + (4 + 10) * V * f32 + 5 * X * Y * f32, 40 * V / F32_OPS_PER_S)
    return rows, dict(points_kept=n_kept, points_in_grid=n_grid, points_in_window=n_win, passes=n_pass,
                      occupied_voxels=n_occ, box_reach_voxels=n_reach, box_reach_nonempty=n_reach_nz,
                      box_terms=terms, atomic_rates_per_s=rates, conv_vs_plain_max_abs_err=err_conv)


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


def phase_profile(cfg, scans, dev, log):
    """torch.profiler over one warm ingest_and_insert and one warm combine:
    device time by kernel, kernel launches, and the device's busy share of
    the host-clock span."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

    buf, world = empty_buffer_state(cfg, dev), empty_world_state(cfg, dev)
    p, v, e = (torch.from_numpy(scans[0][0]).to(dev), torch.from_numpy(scans[0][1]).to(dev),
               torch.tensor(scans[0][2], dtype=torch.float32, device=dev))
    steps = dict(ingest=lambda: pipeline.ingest_and_insert(cfg, buf, p, v, e),
                 combine=lambda: pipeline.combine(cfg, buf, world, e))
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--scans", type=int, default=8, help="scans of the facade drive (default 8)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one ingest and one combine with torch.profiler")
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
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"ptxas {name}: {line.strip()}")
    log(f"built {len(reports)} kernel libraries in {report['build_s']:.1f} s")

    dev = torch.device(DEVICE)
    cfg = GvomConfig()
    t0 = time.perf_counter()
    scans = make_scans(cfg, max(args.scans, 4), LIDAR)
    log(f"made {len(scans)} scans of {int(scans[0][1].sum())} points in {time.perf_counter() - t0:.1f} s "
        f"(grid {cfg.grid_shape}, buffer {cfg.buffer_size})")

    err, buf, world, last = phase1_kernels_vs_plain(cfg, scans[:4], dev, log)
    launches, report["facade"], _ = phase2_facade(cfg, scans, log)
    phase3_small_reference(log)
    rates = atomic_rates(probe, dev, log)
    rows, report["inputs"] = phase4_timings(cfg, buf, world, last, rates, dev, log)
    del buf, world, last
    report["end_to_end"] = phase_end_to_end(cfg, scans, dev, log)
    if args.profile:
        report["profile"] = phase_profile(cfg, scans, dev, log)

    for r in rows:
        r["launches"] = launches[r["name"]]
        r["max_abs_err"] = err[r["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    line = {"kernels": [{k: r[k] for k in keys} for r in rows]}
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
