#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (gvom_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--out FILE.json] [--scans N]

Builds the port's CUDA kernels from gvom_tpu_torch/csrc (one nvcc per source,
all started together; K4 also for ring buffers of 2 and 8), then, at the
upstream deployment (a 256×256×64 grid
at 0.4 m, a ring buffer of 4 scans, 131,072 points per scan from a
synthetic OS1-128 sweep of the composite terrain, made from fixed seeds):

  1. holds each kernel against its plain PyTorch version on the card, on the
     same inputs, over a drive with a moving ego (re-origin, decay veto):
     the point preparation (csrc/prepare.cu: p, keep, origin and scan_ok
     bit for bit; also on one scan with a general quaternion transform, with
     ego_relative_min_distance and with a pinned origin, on the 32-scan batch
     with a dead scan, and on points on voxel faces, at min_distance, at
     ±1e9, ±inf and NaN, valid and not; on scans of n % 4 != 0 points, on a
     scan off the 16-byte grid, on a batch with every scan dead, and on
     batches back to back on two streams; one launch a call, by the
     launch count and torch.profiler), K1 pass counts (from points: the
     kernel builds the ray geometry), K2 hit and min_height and the moment count n, and every K4 output bitwise (its
     moments too); the other moment channels within MOM_RTOL / MOM_ATOL (f32
     sums in another order), K2's where n > 0, the only voxels where its
     scratch defines them. Every epilogue form (K3, K5 with the mask on and
     off, the slab form) gives bitwise the same output on sums whose
     channels 1-9 are NaN where n == 0: it never reads them. K4 also at
     B = 2 (Z = 96), B = 7 (Z = 31) and B = 16 on a small grid, each B a
     library of its own, and past the unrolled kernel's 16 slots and 256 z
     (its grouped kernel) at B = 17 and 33 and Z = 257, 320 and 800. K5
     (the epilogue into a fresh tensor) with the occupancy mask
     on and off. The slab forms of
     K1, K2 and K5 for the four quarter slabs of a scan whose window seam
     falls inside a slab, each against its plain version AND against the
     rows of the full-grid kernel's output, and ingest_scan(y_window=) side
     by side against ingest_scan(). K1 on a near-tier scene (every ray
     shorter than 30 steps, the tier of the JAX package's step-pair kernel).
     The 2-D stencils bit for bit against their plain versions: the plane
     fit (csrc/planefit.cu, the torus-layout column maps moved to the window
     layout as its load, then the whole 3×3 fit) and the guess height
     (csrc/guess.cu, the positive and negative obstacles and the visibility
     as its epilogue) on each combine's column maps, and on the seeded maps of
     io.synthetic.stencil_maps (all known, all unknown, checkerboard, border
     only, collinear triples with det = 0, a count of exactly 3, heights
     near ±1e4, sparse, terrain with holes) at 256×256 (R = 15, and R = 60,
     where the guess kernel reads the map from global memory) and the guess
     at R = 0, 1, 15 and 300 on a 64×64 grid, on a map where no cell
     searches (every block skips) and on one where a single cell does,
     with the count of searching cells of each combine's maps printed; the
     plane fit's tail alone (its
     own entry, off the map path) on a seeded sweep of 2^20 cells of its
     domain. The maps' tail that the two kernels took over (the window
     layout of the height maps, the obstacle maps and the visibility) bit
     for bit against its own twins on io.synthetic.map_tail_inputs' crafted
     256×256 map (cells at the slope threshold, den = 0, UNKNOWN_HEIGHT, and
     guessed deltas at the negative threshold) at four origins; the batched
     merge (csrc/merge.cu:
     the merge and the column maps) bit for bit, moments included, on
     seeded upstream worlds (origin moved, world not valid, windows apart,
     z shift) and on their quarter slab y0 = 64 against the full rows.
     Then every configuration that the JAX package takes: K2, K3, K5 (mask
     on, off) and the slab epilogue at the eigen distances (1, 9), (8, 1)
     and (5, 8), which take the epilogue's separable passes (bitwise the
     plain version on all ten channels) or, with the mask on at (1, 9), its
     direct kernel (n bitwise, the nine sums within the f32 summation bound
     of a float64 reference, box_close); the direct kernel with the mask
     off and on, and K3 into a slot, at eigen (1453, 1) on an H100 (past
     the separable passes' smallest tile) on an 8×8×4 grid, whose padded
     scratch is 2.0 GB, from sums of seeded sparse points, against the
     plain version's function summed over those sources (box_sparse) and
     within the f32 bound of it in float64, timed; the merge at 256×256×320; the Gvom facade with
     buffer_size=17, z_size=320, z_eigen_dist=9 and xy_eigen_dist=8 on
     two upstream scans against the same facade on its plain versions,
     and the batched step at Z = 320 against its plain versions; and the
     JAX record's larger grid, 512×512×64 at B = 4: the kernels against
     their plain versions over two scans and the facade against its
     plain versions, with the peak device memory of its drive. Then the
     configuration sweep (SWEEP_CONFIGS: F1-F4, the CPU tests' configurations
     on the JAX package's fuzz drives, and F5, the upstream grid at the
     reference node's z_resolution = 0.2; between them every field that the
     kernels take as a constant off its default: inexact reciprocal
     resolutions, eigen distances 0 and 2, ring buffers of 2 to 5, decay
     limits 2 and 4, the occupancy gate at 3, the ego disk, the obstacle
     thresholds, the guess radius 6, the sensor-relative distance filter):
     for each, the facade, two batched steps and ingest_scan(y_window=) on
     the quarter slab that holds the seam, each against the same entry on
     its plain versions, every kernel of each path launched (the launch
     counts set to 0 before and read after); and beside it the installed
     port: the wheel that pyproject.toml defines, built offline and
     unpacked into a temporary directory, alone on the path, builds the
     preparation and K1 from its own sources into its own _build, launches
     each once (bitwise their plain versions), imports no jax, and runs
     its CLI;
  2. drives the port's Gvom facade (process_pointcloud, then combine_maps
     after each scan) with every kernel's launch count set to 0 just before
     and read just after (the preparation, K1-K4, the plane fit and the
     guess height once a scan), no float64 fma32 or
     sqrt32 on the card (watch_fma32), and checks the 5-tuple it returns;
     then
     counts every launch of one warm combine_maps and of one warm
     process_pointcloud with torch.profiler (the kernels' and PyTorch's) and
     prints them with the device's busy share and float64 time (none);
  3. checks the facade's outputs and ring buffer on a small grid (B = 3,
     whose K4 library the facade builds when it is made), over a
     drive with one degenerate scan, against the same facade on the CPU,
     which runs the plain versions (the CPU tests pin those to the JAX
     package): every output bitwise, roughness and the slopes included;
     then the same drive with each scan given in its sensor frame and a
     general quaternion transform (the ROS node's path), and that path on
     three upstream scans against the same facade on its plain versions on
     the card;
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
     just before and read just after (the preparation, K1, K2, K5, the
     merge, the plane fit and the guess height: one launch a step each), no
     float64 fma32 or sqrt32 on the card, and one
     warm step's launches and float64 time (none) counted with
     torch.profiler; the merge kernel bit for bit against its plain version
     on the second step's 32-scan contribution into the first step's live
     world (the origin moved), and on its quarter slab y0 = 64 against the
     full rows, timed against its bound; then K1 on a
     whole 32-scan batch, timed and held bitwise against the plain twin and
     the sum of its one-scan launches over the same scans, and K2 and K5 on its merged
     points against their plain versions, timed; then K1 on a 64-scan
     batch of the benchmark's lap (benchmark/scangen.py), the same way, with
     its march's lane utilisation and atomics after the warp merge in
     launch order and sorted by live steps (kernels.ray_march_stats), and
     its one-scan, slab and 64-scan times beside their bounds, and the
     times of one of its scans, that scan's slab and the batch's slab;
  6. runs batched_replay over a synthesized log of 8 scans on a small grid,
     batch 4, against the same replay on the CPU, with a checkpoint written,
     loaded, and the resumed run's world equal to the straight run's;
  7. drives the live mapper's host path at the upstream deployment: the
     PointCloud2 decode (native and NumPy paths, timed, bitwise the same);
     VoxelMapperNode for about 3 s under two sensor threads at 10 Hz each,
     which decode serialized PointCloud2 payloads through the native path,
     while a timer thread on rospy.Timer's schedule runs the ROS node's
     timer callback at 10 Hz: publish the maps, then the debug clouds
     (launch counts set to 0 just before and read just after; any exception
     in a thread fails the run); reset, then the same 8 scans twice (the
     second reset from a thread on another CUDA stream), the layers bitwise
     the same and the products a fresh Gvom's; the
     three exporters at the full grid, timed, against the same exporters on
     the world copied to the CPU; a bz2-chunked bag of the 8 scans through
     `cli convert-bag` and sequential_replay, bitwise the facade's (an lz4
     chunk on a small bag); `cli replay` (sequential and batched), `cli
     selftest` and `cli parity --scans 3` on the card and on the CPU as
     subprocesses, each exiting 0, the two parity reports equal;
  8. runs `python -m gvom_tpu_torch.bench` in its four modes (perscan,
     combine, async, batched; 8 steps, best of 2), one at a time, and prints
     their JSON lines; runs entry()'s step on the card, its four maps
     bitwise those of entry(device="cpu");
  9. runs the (data, space) mesh (parallel/mesh.py) on the one card, which
     holds one NCCL rank: a (1, 1) mesh over NCCL takes two batched steps of
     32 scans, bitwise the same steps with mesh=None (the moments within
     MOM_ATOL_BATCH: the kernels' float atomics add in any order, so two
     runs of one step differ there, which the phase counts); four
     ranks in four processes share the card over gloo on the meshes (1, 4)
     slab, (2, 2) slab and (2, 2) scatter, each gathered world and its
     products bitwise the one-rank step's (the moments within
     MOM_ATOL_BATCH), the slab kernels launched on every rank of a space
     mesh and the merge, the plane fit and the guess height on every rank;
     dryrun_multichip(4, backend="gloo"); and `bench --mode scaling
     --devices 1`. It prints each rank's step time, peak device memory,
     slab launches and the bytes gloo moved through the host. Four ranks
     on one card measure no scaling.

Prints the timings, one JSON line {"kernels": [...]} (every kernel of the
paths, the maps' tail named under the two kernels that took it over as
"includes"; the plane fit's tail, which no path launches, is timed in the
--out report), the card's name and power limit, and as its last line
{"ok": true, "device": {...}}. Exits
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
import zipfile
from concurrent.futures import ProcessPoolExecutor
from multiprocessing import get_context
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
# a batched step sums every scan of its batch into one voxel: up to 32 times
# the terms, and the absolute error of an unordered f32 sum grows with them.
# Seen on an H100 (700 W): max abs error 9.8e-4 for one scan, 3.9e-3 for a
# batch of 4 (8 to 16 % of rtol·|b| + atol where it is largest) and 1.6e-2 to
# 2.3e-2 for a batch of 32, at a voxel of 7,432 points (5 to 6 %)
MOM_ATOL_BATCH = 1e-2
BATCH = 32                   # scans per batched step, the JAX package's bench default
BATCH_CHECK = 4              # scans per step of the batched step held against the plain versions
NEAR_TIER_STEPS = 30         # the step-pair kernel of the JAX package covers steps 1..30
PLANE_FIT_SWEEP = 1 << 20    # values of the plane-fit tail's seeded sweep over the fit's domain
PLANE_FIT_TAIL_OPS = 80      # f32 operations of the plane-fit tail at a cell whose fit is ok (a log, two atan2)
PLANE_FIT_OPS = 150          # f32 operations of the whole plane fit at a cell (the sums, the moments, the tail)
PREP_OPS = 16                # f32 operations of the preparation a point: d², its test, voxel, bounds
PREP_TRANSFORM_OPS = 12      # and of the transform a point: three rows of a product, two fmas and an add
PROFILED_CALLS = 20          # calls of the preparation in its profiled trace
GUESS_OPS = 13               # f32 operations of the guess and its products a cell: the delta, steepness, density
DEAD_SCAN = 5                # the scan of phase 1's 32-scan batch that is moved out of the grid
STENCIL_SMALL = 64           # the small grid of phase 1's stencil radii
STENCIL_RADII = (0, 1, 15, 300)
C4_SCANS = 15                # scans of phase 1's knife-edge drive (fault C4's 16×16×32 grid)
BENCH_MODES = ("perscan", "combine", "async", "batched")
# the kernels that the facade launches once a scan (ingest) or once a combine
FACADE_KERNELS = ("prepare_points", "ray_pass_counts", "bin_points", "ingest_epilogue", "combine", "plane_fit",
                  "guess_height")
# the kernels that took the maps' tail over: its two entries' work is in their launches
TAIL_HOSTS = dict(plane_fit="maps_to_window", guess_height="map_products")
MERGE_OPS = 40               # f32 and int operations of the merge a voxel (masks, sums, ten moment adds)
MAP_TAIL_ORIGINS = ((5, -7, 2), (0, 0, 0), (-300, 1000, 0), (255, 1, -5))   # phase 1's crafted map-tail origins
MESH_RANKS = 4               # phase 9's gloo ranks on the one card
# phase 1's K4 depths and z sizes on a 64×64 grid: the unrolled kernel's own (2, 7, 16) and the grouped
# kernel's boundaries (17 slots, 33: two ballots of slots; 257 z, odd; 320; 800: past the shared column)
OTHER_B_Z = ((2, 96), (7, 31), (16, 64), (17, 64), (33, 64), (4, 257), (4, 320), (4, 800))
MERGE_TALL = ((256, 320), (64, 257), (64, 800))   # phase 1's merge past 256 z: (X, Z)
EIGEN_DISTS = ((1, 9), (8, 1), (5, 8))   # phase 1's epilogue (xy_eigen_dist, z_eigen_dist) past the tiled box
# phase 1's direct epilogue past the separable passes' tile: its grid (X = Y, Z), an origin, seeded points over
# the padded box and inside the window, and its timed launches a mask (3.4 s each on an H100, PERF.md §6)
DIRECT_GRID, DIRECT_ORIGIN, DIRECT_POINTS, DIRECT_HITS = (8, 4), (5, -3, 1), 4096, 96
DIRECT_REPS = 2
# the configurations of phase 1c: every one the JAX package takes, past the kernels' fast forms
WIDE_CONFIGS = (dict(buffer_size=17), dict(z_size=320), dict(z_eigen_dist=9), dict(xy_eigen_dist=8))
LARGE_GRID = 512             # phase 1d's grid, the JAX record's larger one (512×512×64)
WIDE_SCANS = 2               # scans of each of those drives: the second combines into a live world
# phase 1e's configuration sweep: (seed of the drive, the fields off GvomConfig()'s). F1-F4 are the CPU
# tests' (tests/torch_helpers.py, SWEEP), on the JAX package's fuzz drives (tests/test_fuzz_parity.py);
# F5 is the upstream deployment at the reference node's z_resolution with F4's thresholds, guess radius
# and distance filter, on the upstream scans
SWEEP_THRESHOLDS = dict(hit_count_threshold=3, decay_miss_limit=2, robot_height=1.2, robot_radius=2.5,
                        ground_to_lidar_height=1.7, positive_obstacle_threshold=0.3, negative_obstacle_threshold=0.8,
                        slope_obstacle_threshold=0.15, density_threshold=7, guess_search_radius=6, min_distance=2.5,
                        ego_relative_min_distance=True)
SWEEP_CONFIGS = {
    "F1": (11, dict(xy_size=40, z_size=24, xy_resolution=0.35, z_resolution=0.25, buffer_size=3,
                    xy_eigen_dist=1, z_eigen_dist=0)),
    "F2": (23, dict(xy_size=48, z_size=16, xy_resolution=0.5, z_resolution=0.5, buffer_size=2,
                    xy_eigen_dist=2, z_eigen_dist=1, decay_miss_limit=4)),
    "F3": (37, dict(xy_size=32, z_size=32, xy_resolution=0.4, z_resolution=0.2, buffer_size=5,
                    xy_eigen_dist=0, z_eigen_dist=0, robot_radius=0.8)),
    "F4": (5, dict(xy_size=48, z_size=24, xy_resolution=0.3, z_resolution=0.15, buffer_size=4,
                   xy_eigen_dist=2, z_eigen_dist=2, **SWEEP_THRESHOLDS)),
    "F5": (None, dict(z_resolution=0.2, **SWEEP_THRESHOLDS)),
}
SWEEP_MAX_POINTS, SWEEP_BATCH_MAX_POINTS = 16384, 4096   # F1-F4's point capacities (facade, batched step)
SWEEP_SCANS, SWEEP_STEPS, SWEEP_BATCH = 4, 2, 8          # F1-F4's facade scans, batched steps and their scans
# the kernels that the batched step launches once a step, and the slab ingest once a call
BATCHED_KERNELS = ("prepare_points", "ray_pass_counts", "bin_points", "moments_epilogue", "merge_batch",
                   "plane_fit", "guess_height")
SLAB_KERNELS = ("ray_pass_counts_slab", "bin_points_slab", "moments_epilogue_slab")
MESH_SHAPES = (("(1, 4) slab", 4, "slab"), ("(2, 2) slab", 2, "slab"), ("(2, 2) scatter", 2, "scatter"))

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


def nan_blind(name, fn, n, rest):
    """fn(n, rest) (an epilogue) on channels 1-9 that are NaN where n == 0
    gives bitwise what it gives on clean ones: it never reads them."""
    import torch

    bad = torch.where(n > 0, rest, torch.full((), float("nan"), device=rest.device))
    ref = fn(n, torch.where(n > 0, rest, torch.zeros((), device=rest.device))).clone()
    got = fn(n, bad)
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


_CAPTURE = []   # graph_ms's capture stream, made at its first call


def graph_ms(fn, reps):
    """The card's time for what fn() launches, alone: GRAPH_CALLS calls
    captured in one CUDA graph (fills and small launches included, no host in
    between), replayed until about reps calls ran, timed with CUDA events.
    fn runs once on the capture stream first, so that what a wrapper keeps
    a stream (the preparation's workspace) exists before the capture.
    Returns (ms per call, what the last captured call returned)."""
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


# the plane-fit kernel's outputs and the guess kernel's, by their MapProducts names
FIT_OUTPUTS = ("height", "inferred_height", "roughness", "slope_x", "slope_y")
GUESS_OUTPUTS = ("guessed_height_delta", "positive_obstacle", "negative_obstacle", "visibility")
STENCIL_ORIGIN = (3, -5, 0)  # the origin at which phase 1 puts the stencil patterns on the torus


def plane_fit_vs_plain(what, cfg, hm_t, ihm_t, origin):
    """The plane-fit kernel against its plain version (the torus-layout maps
    moved to the window layout, then plane_fit_inputs and its tail, in
    PyTorch ops on the card) on the same maps: the window-layout height and
    inferred height and the fit's three maps, bit for bit. Returns the
    kernel's outputs (FIT_OUTPUTS)."""
    from gvom_tpu_torch.ops import kernels, maps2d

    got = kernels.plane_fit(cfg, hm_t, ihm_t, origin)
    for name, a, b in zip(FIT_OUTPUTS, got, maps2d.plane_fit_window_plain(cfg, hm_t, ihm_t, origin)):
        bitwise(f"{what}: plane fit {name}", a, b)
    return got


def guess_vs_plain(what, cfg, hm, ihm, sx, sy, pnum, pden, band_ok, origin):
    """The guess-height kernel against its plain version (the search, then
    the obstacle maps and the visibility) on the same maps, bit for bit.
    Returns the kernel's outputs (GUESS_OUTPUTS)."""
    from gvom_tpu_torch.ops import kernels, maps2d

    args = (hm, ihm, sx, sy, pnum, pden, band_ok, origin)
    got = kernels.guess_height(cfg, *args)
    for name, a, b in zip(GUESS_OUTPUTS, got, maps2d.guess_products_plain(cfg, *args)):
        bitwise(f"{what}: guess height (R = {cfg.guess_search_radius}) {name}", a, b)
    return got


def tail_maps(X, cfg, dev, seed):
    """The maps that the guess kernel's epilogue reads beside the delta, from
    io.synthetic.map_tail_inputs at X×X: (slope_x, slope_y, pnum, pden,
    band_ok) on the card."""
    import torch

    from gvom_tpu_torch.io.synthetic import map_tail_inputs

    d = map_tail_inputs(X, cfg.slope_obstacle_threshold, cfg.negative_obstacle_threshold, seed)
    return tuple(torch.from_numpy(d[k]).to(dev) for k in ("slope_x", "slope_y", "pnum", "pden", "band_ok"))


def stencils_vs_plain(what, cfg, hm, ihm, seed, fit=True):
    """The two stencil kernels on window-layout maps hm and ihm: the plane
    fit from the same maps put on the torus at STENCIL_ORIGIN (its window
    layout held bitwise against hm and ihm themselves), then the guess on
    hm and ihm with tail_maps(seed) beside them. Returns the delta map."""
    import torch

    from gvom_tpu_torch.ops.grid import window_to_torus

    o = torch.tensor(STENCIL_ORIGIN, dtype=torch.int32, device=hm.device)
    if fit:
        got = plane_fit_vs_plain(what, cfg, window_to_torus(hm, o, grid_ndim=2), window_to_torus(ihm, o, grid_ndim=2),
                                 o)
        bitwise(f"{what}: the plane fit's window height vs the map", got[0], hm)
        bitwise(f"{what}: the plane fit's window inferred height vs the map", got[1], ihm)
    return guess_vs_plain(what, cfg, hm, ihm, *tail_maps(hm.shape[0], cfg, hm.device, seed), o)[0]


def guess_staged(X, R):
    """Whether the guess-height launcher stages hm in shared memory for a
    map of X cells a side at radius R (else the blocks read it from global
    memory): csrc/guess.cu's own rule."""
    from gvom_tpu_torch.ops import kernels

    fn = ctypes.CDLL(str(kernels.GUESS.library())).gvom_guess_height_staged
    fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
    return bool(fn(X, R))


def phase1_stencils(cfg, dev, log):
    """Both stencil kernels bitwise against their plain versions on the
    seeded maps of io.synthetic.stencil_maps (the plane fit from them put on
    the torus at STENCIL_ORIGIN, the guess with the crafted band sums and
    slopes of io.synthetic.map_tail_inputs beside them): at the upstream
    256×256 map (R = 15, and R = 60, whose halo does not fit in shared
    memory), and at R in STENCIL_RADII on a small grid (R = 0 searches
    nothing, R = 300 is wider than the map)."""
    import torch

    from gvom_tpu_torch import GvomConfig
    from gvom_tpu_torch.io.synthetic import STENCIL_PATTERNS, stencil_maps

    small = GvomConfig(xy_size=STENCIL_SMALL, z_size=32, max_points=4096)
    # (config, seed of the maps, whether the plane fit is held too: it does not depend on R)
    runs = [(cfg, 0, True), (dataclasses.replace(cfg, guess_search_radius=60), 1, False)]
    runs += [(dataclasses.replace(small, guess_search_radius=R), 2, i == 0) for i, R in enumerate(STENCIL_RADII)]
    routes, positive = {}, 0
    for c, seed, fit in runs:
        X, R = c.xy_size, c.guess_search_radius
        routes[f"{X}x{X} R={R}"] = "shared" if guess_staged(X, R) else "global"
        for pattern in STENCIL_PATTERNS:
            hm, ihm = (torch.from_numpy(a).to(dev) for a in stencil_maps(pattern, X, seed))
            positive += int((stencils_vs_plain(f"{pattern} {X}x{X}", c, hm, ihm, seed, fit) > 0).sum())
    check(set(routes.values()) == {"shared", "global"}, f"the guess kernel's two routes were not both run: {routes}")
    idle = guess_idle_and_single(cfg, dev)
    ranges = plane_fit_extremes(cfg, dev)
    log(f"phase 1 stencils: the plane-fit and guess-height kernels bitwise their plain versions on "
        f"{len(STENCIL_PATTERNS)} seeded map patterns ({', '.join(STENCIL_PATTERNS)}); guess at {routes} "
        f"({positive} positive cells in all); the guess on a map where no cell searches (every block skips) and "
        f"on one with a single searching cell at {idle}, bitwise; the plane fit on a map of unknown cells and on "
        f"one of known cells whose x slopes fill each range of atanf's reduction (cells a range: {ranges}), bitwise")
    return routes


ATAN_RANGES = (0.4375, 0.6875, 1.1875, 2.4375)   # the bounds of |t| in glibc atanf's range reduction


def plane_fit_extremes(cfg, dev):
    """The plane fit at the upstream map size on a map whose every cell is
    unknown and on one whose every cell is known: a surface whose slope
    along x, k·x², takes every range of atanf's reduction (ATAN_RANGES)
    across the map. Each bitwise its plain version; returns the known map's
    cells in each range of |slope_x|."""
    import numpy as np
    import torch

    from gvom_tpu_torch.ops.grid import window_to_torus
    from gvom_tpu_torch.types import UNKNOWN_HEIGHT

    X, res = cfg.xy_size, cfg.xy_resolution
    o = torch.tensor((7, -3, 0), dtype=torch.int32, device=dev)
    unknown = torch.full((X, X), UNKNOWN_HEIGHT, dtype=torch.float32, device=dev)
    got = plane_fit_vs_plain("every cell unknown", cfg, unknown, unknown, o)
    check(bool((got[2] == -1).all()), "the plane fit on unknown cells: a fitted cell")
    x, y = np.meshgrid((np.arange(X) - X / 2) * res, np.arange(X) * res, indexing="ij")
    k = 2.0 * ATAN_RANGES[-1] / (X / 2 * res) ** 2     # twice the last range's slope at the map's edge
    rng = np.random.default_rng(15)
    h = k / 3 * x ** 3 + 0.2 * np.sin(0.3 * y) + rng.normal(0.0, 0.005, (X, X))
    hm = torch.from_numpy(h.astype(np.float32)).to(dev)
    got = plane_fit_vs_plain("every cell known", cfg, window_to_torus(hm, o, grid_ndim=2),
                             window_to_torus(hm + 0.5, o, grid_ndim=2), o)
    edges = torch.atan(torch.tensor(ATAN_RANGES, dtype=torch.float32, device=dev))
    counts = torch.bucketize(got[3].abs().flatten(), edges).bincount(minlength=len(ATAN_RANGES) + 1).tolist()
    check(bool((got[2] != -1).all()) and min(counts) > 0,
          f"the plane fit on known cells: not every cell fitted, or a range of atanf without a cell ({counts})")
    return counts


def guess_idle_and_single(cfg, dev):
    """The guess kernel at the upstream map size and radius on the terrain
    pattern's heights with the inferred heights cut so that no cell
    searches (every block skips its staging), and so that one cell does:
    each bitwise its plain version. Returns that cell."""
    import torch

    from gvom_tpu_torch.io.synthetic import stencil_maps
    from gvom_tpu_torch.types import UNKNOWN_HEIGHT

    hm, ihm = (torch.from_numpy(a).to(dev) for a in stencil_maps("terrain_holes", cfg.xy_size, 3))
    unknown = torch.full_like(ihm, UNKNOWN_HEIGHT)
    none = torch.where(hm > UNKNOWN_HEIGHT, ihm, unknown)
    check(not bool(((hm <= UNKNOWN_HEIGHT) & (none != UNKNOWN_HEIGHT)).any()), "guess idle map: a cell searches")
    got = stencils_vs_plain("no cell searches", cfg, hm, none, 3, fit=False)
    check(not bool(got.any()), "guess idle map: a nonzero delta")
    holes = torch.nonzero(hm <= UNKNOWN_HEIGHT)
    check(len(holes) > 0, "guess single-cell map: no unknown cell")
    cell = holes[len(holes) // 2]
    one = unknown.clone()
    one[cell[0], cell[1]] = hm.max() + 1.0
    got = stencils_vs_plain("one cell searches", cfg, hm, one, 3, fit=False)
    check(int((got != 0).sum()) <= 1, "guess single-cell map: more than one nonzero delta")
    return cell.tolist()


def searching_cells(hm, ihm):
    """The cells of a map whose guess searches: no measured height, an
    inferred one (csrc/guess.cu)."""
    from gvom_tpu_torch.types import UNKNOWN_HEIGHT

    return int(((hm <= UNKNOWN_HEIGHT) & (ihm != UNKNOWN_HEIGHT)).sum())


def plane_fit_sweep(dev, log):
    """The plane fit's tail kernel on PLANE_FIT_SWEEP seeded cells of the
    fit's domain: residuals log-uniform over 16 decades with zeros,
    negatives and subnormals among them, a tenth of the fits not ok, a0 over
    12 decades, a1 in (−1, 1), a0n = a0/m, a1n = a1/m, 1/m with
    m = sqrt(a0² + a1² + 1)."""
    import numpy as np
    import torch

    from gvom_tpu_torch.ops import kernels, maps2d

    rng = np.random.default_rng(2026)
    n = PLANE_FIT_SWEEP
    err = (10.0 ** rng.uniform(-14, 2, n)).astype(np.float32)
    special = rng.integers(0, n, n // 64)
    err[special] = rng.choice(np.array([0.0, -0.0, -1e-3, 1e-40, 1.1754944e-38], np.float32), len(special))
    a0 = (rng.standard_normal(n) * 10.0 ** rng.uniform(-6, 6, n)).astype(np.float32)
    a1 = rng.uniform(-1, 1, n).astype(np.float32)
    m = np.sqrt(a0.astype(np.float64) ** 2 + a1.astype(np.float64) ** 2 + 1.0).astype(np.float32)
    fit = [torch.from_numpy(a).to(dev) for a in (err, rng.random(n) > 0.1, a0 / m, a1 / m, np.float32(1.0) / m)]
    got = kernels.plane_fit_tail(*fit)
    for name, a, b in zip(("roughness", "slope_x", "slope_y"), got, maps2d.plane_fit_tail_plain(*fit)):
        bitwise(f"plane fit tail sweep: {name}", a, b)
    log(f"phase 1 plane fit tail: {n} seeded cells of the fit's domain bitwise against grid.log32 / "
        f"grid.atan2_32 on the card ({int((got[0] == float('-inf')).sum())} subnormal residuals, whose log is -inf)")
    return fit


def bitwise_nan(name, a, b):
    """float32 bit for bit where b is a number, NaN where b is NaN (a NaN's
    payload is the arithmetic's: float64 in the plain version)."""
    import torch

    nan = torch.isnan(b)
    exact(f"{name} NaN", torch.isnan(a), nan)
    bitwise(name, torch.where(nan, torch.zeros_like(a), a), torch.where(nan, torch.zeros_like(b), b))


def poison_free_memory(n_bytes, dev):
    """Fill n_bytes of the allocator's free memory with 0x02 bytes: an
    output allocated next (torch.empty) then holds them wherever a kernel
    does not write, and a bool byte 0x02 is neither value it writes."""
    import torch

    junk = torch.full((n_bytes,), 2, dtype=torch.uint8, device=dev)
    del junk


def prepare_same(what, got, ref):
    """The preparation's outputs bit for bit: p (NaN where the plain p is
    NaN), keep and scan_ok by their bytes, the origin."""
    import torch

    bitwise_nan(f"{what}: prepare p", got[0], ref[0])
    for name, a, b in zip(("keep", "origin", "scan_ok"), got[1:], ref[1:]):
        if a.dtype == torch.bool:
            a, b = a.view(torch.uint8), b.view(torch.uint8)
        bitwise(f"{what}: prepare {name}", a, b)


def prepare_vs_plain(what, cfg, *args, **kw):
    """The prepare kernel against its plain version on the card, on outputs
    allocated over poisoned memory (poison_free_memory): p, keep, origin and
    scan_ok bit for bit. Returns the kernel's outputs."""
    from gvom_tpu_torch.ops import binning, kernels

    poison_free_memory(16 * args[1].numel() + (1 << 21), args[0].device)
    got = kernels.prepare_points(cfg, *args, **kw)
    prepare_same(what, got, binning.prepare_plain(cfg, *args, **kw))
    return got


def quaternion_transform(seed, translation):
    """A general sensor→world transform [4,4] f32 (numpy) from a seeded
    quaternion, as the ROS node builds it (ros/node.py::_quat_to_mat)."""
    import numpy as np

    from gvom_tpu_torch.ros.node import _quat_to_mat

    q = np.random.default_rng(seed).standard_normal(4)
    return _quat_to_mat(*translation, *q).astype(np.float32)


def to_sensor_frame(points, tf):
    """World points [N,3] expressed in the frame that tf maps to the world."""
    import numpy as np

    r, tr = tf[:3, :3].astype(np.float64), tf[:3, 3].astype(np.float64)
    return ((points.astype(np.float64) - tr) @ r).astype(np.float32)


def phase1_prepare(cfg, scans, dev, log):
    """The prepare kernel bitwise against its plain version at the upstream
    shapes: one 131,072-point scan with no transform, with a general
    quaternion transform (the scan in its sensor frame), with
    ego_relative_min_distance, and with a pinned origin; the 32-scan batch
    of phase 5 with scan DEAD_SCAN moved out of the grid (dead, its points
    dropped); the edge points with valid on, off and alternating, with and
    without the transform; non-finite frame egos. Returns the inputs of the
    timings."""
    import torch

    from gvom_tpu_torch.io import synthetic

    pad = scans[0][0]
    pts, valid, ego = scan_tensors(scans[0], dev)
    one = dict(points=pts[None], valid=valid[None], egos=ego[None])
    got = prepare_vs_plain("scan 0", cfg, one["points"], one["valid"], one["egos"], frame_ego=ego)
    check(bool(got[3][0]) and got[0].data_ptr() == pts.data_ptr(), "scan 0: not ok, or p is not the input")
    tf_np = quaternion_transform(0, (1.7, -0.9, 0.35))
    sensor = torch.from_numpy(to_sensor_frame(pad, tf_np)).to(dev)
    tf = torch.from_numpy(tf_np).to(dev)
    got_tf = prepare_vs_plain("scan 0, quaternion transform", cfg, sensor[None], valid[None], ego[None],
                              frame_ego=ego, transform=tf)
    moved = int(((got_tf[0][0] != pts).any(dim=1) & valid).sum())
    check(bool(got_tf[3][0]) and moved > 0, "quaternion transform: not ok, or no point rounds")
    # a min_distance that the ego's near returns fall inside
    rel = dataclasses.replace(cfg, ego_relative_min_distance=True, min_distance=4.0)
    got_rel = prepare_vs_plain("scan 0, ego_relative_min_distance", rel, *one.values(), frame_ego=ego)
    check(int(got_rel[1].sum()) < int(valid.sum()), "ego_relative_min_distance 4 m: no point dropped")
    pinned = got[2] + torch.tensor([3, -5, 1], dtype=torch.int32, device=dev)
    prepare_vs_plain("scan 0, pinned origin", cfg, *one.values(), origin=pinned)

    # the batch, as phase 5 makes it, one scan moved out of the grid
    bpts, bvalid, begos = make_batch(scans_on_device(scans, dev), BATCH, 1)
    bpts[DEAD_SCAN, :, 1] += 1000.0 + 3 * cfg.xy_size * cfg.xy_resolution     # beyond its returns' range too
    bprep = prepare_vs_plain(f"{BATCH}-scan batch", cfg, bpts, bvalid, begos, frame_ego=begos[-1], drop_dead=True)
    dead = [s for s in range(BATCH) if not bool(bprep[3][s])]
    check(dead == [DEAD_SCAN] and not bool(bprep[1][DEAD_SCAN].any()),
          f"batch: dead scans {dead}, expected [{DEAD_SCAN}] with no point kept")

    # the edge points, and frame egos that are not finite
    res = (cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution)
    ep = torch.from_numpy(synthetic.edge_points(res, cfg.grid_shape, got[2].cpu().numpy(),
                                                cfg.min_distance)).to(dev)
    n_edge = ep.shape[0]
    patterns = dict(valid=torch.ones(n_edge, dtype=torch.bool), invalid=torch.zeros(n_edge, dtype=torch.bool),
                    alternate=torch.arange(n_edge) % 2 == 0)
    for vname, v in patterns.items():
        for tname, t in (("no transform", None), ("quaternion", tf)):
            e = prepare_vs_plain(f"edge points, {vname}, {tname}", cfg, ep[None], v.to(dev)[None], ego[None],
                                 frame_ego=ego, transform=t)
            check(vname != "invalid" or not bool(e[3][0]), "edge points: invalid points made the scan ok")
    bad = torch.tensor([[float("nan"), float("inf"), -1e12], [float("-inf"), 3e38, float("nan")]], device=dev)
    for k, fe in enumerate(bad):
        prepare_vs_plain(f"frame ego {k} not finite", cfg, ep[None], patterns["valid"].to(dev)[None], ego[None],
                         frame_ego=fe)
    odd = phase1_prepare_odd_shapes(cfg, pts, valid, ego, sensor, tf, (bpts, bvalid, begos))
    log(f"phase 1 prepare: bitwise its plain version on one scan ({int(got[1].sum())} kept; a quaternion "
        f"transform, {moved} points not at their world coordinates after the round trip; ego_relative_min_distance "
        f"{int(got_rel[1].sum())} kept at 4 m; a pinned origin), on the {BATCH}-scan batch (scan {DEAD_SCAN} dead, "
        f"{int(bprep[1].sum())} points kept), on {n_edge} edge points valid, invalid and alternating with and "
        f"without the transform, from two non-finite frame egos, and {odd}")
    return dict(one=one, ego=ego, sensor=sensor, tf=tf, batch=(bpts, bvalid, begos), n_dead=len(dead))


def phase1_prepare_odd_shapes(cfg, pts, valid, ego, sensor, tf, batch):
    """The prepare kernel's other paths, bitwise its plain version: scans of
    n % 4 != 0 points (the last points of a scan on the scalar path; with
    S scans, every other scan's rows off the 16-byte grid, so on the scalar
    path whole), with and without the transform, the dead scan among them;
    a scan whose points start 12 bytes into the buffer (not 16-byte
    aligned); a batch in which every scan is dead; and two batches on two
    streams, launched back to back so that the card may run them at once
    (each stream has its own workspace). Returns what it ran, for the log."""
    import torch

    bpts, bvalid, begos = batch
    S8 = 8
    n1 = pts.shape[0] - 3       # n % 4 == 1
    prepare_vs_plain("one scan, n % 4 = 1", cfg, pts[None, :n1], valid[None, :n1], ego[None], frame_ego=ego)
    prepare_vs_plain("one scan, n % 4 = 1, quaternion transform", cfg, sensor[None, :n1], valid[None, :n1], ego[None],
                     frame_ego=ego, transform=tf)
    got = prepare_vs_plain(f"{S8} scans of n % 4 = 1 points, dead scan {DEAD_SCAN}", cfg,
                           bpts[:S8, :n1].contiguous(), bvalid[:S8, :n1].contiguous(), begos[:S8],
                           frame_ego=begos[S8 - 1], drop_dead=True)
    check(not bool(got[3][DEAD_SCAN]) and not bool(got[1][DEAD_SCAN].any()) and bool(got[3][0]),
          "n % 4 = 1 batch: the dead scan's points were kept, or scan 0 is dead")
    prepare_vs_plain(f"{S8} scans of n % 4 = 1 points, a transform", cfg, bpts[:S8, :n1].contiguous(),
                     bvalid[:S8, :n1].contiguous(), begos[:S8], frame_ego=begos[S8 - 1], transform=tf)
    off = pts[1:]
    check(off.data_ptr() % 16 != 0, "the offset scan is 16-byte aligned")
    prepare_vs_plain("one scan 12 bytes off the 16-byte grid", cfg, off[None], valid[None, 1:], ego[None],
                     frame_ego=ego)
    gone = bpts.clone()
    gone[:, :, 1] += 1000.0 + 3 * cfg.xy_size * cfg.xy_resolution
    got = prepare_vs_plain(f"{BATCH}-scan batch, every scan dead", cfg, gone, bvalid, begos, frame_ego=begos[-1],
                           drop_dead=True)
    check(not bool(got[3].any()) and not bool(got[1].any()), "every scan dead: a scan is ok or a point kept")
    # two batches on two streams, back to back
    from gvom_tpu_torch.ops import binning, kernels

    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    inputs = ((bpts, bvalid, begos), (gone, bvalid, begos))
    outs = []
    poison_free_memory(16 * 6 * bvalid.numel(), bvalid.device)
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    for rep in range(3):
        for st, (p, v, e) in zip(streams, inputs):
            with torch.cuda.stream(st):
                outs.append(kernels.prepare_points(cfg, p, v, e, frame_ego=e[-1], drop_dead=True))
    torch.cuda.synchronize()
    for k, got in enumerate(outs):
        ref = binning.prepare_plain(cfg, *inputs[k % 2], frame_ego=inputs[k % 2][2][-1], drop_dead=True)
        prepare_same(f"two streams, call {k}", got, ref)
    return (f"the odd shapes (n % 4 = 1 on one scan, with a transform, and on {S8} scans with the dead scan; a scan "
            f"12 bytes off the 16-byte grid; a batch with every scan dead; {len(outs)} batches back to back on two "
            f"streams)")


def phase1_knife_edges(dev, log):
    """K1 on the drive where a ray's position meets a fused multiply-add
    knife-edge (fault C4, closed): 16×16×32, scans s = 1..C4_SCANS at ego
    (0.3, −0.2, 1.5) + s·(0.9, 0.6, 0.02), bitwise its plain version, which
    rounds start + k·step as one FMA as the JAX package's compiled raycast
    does. The plain march with the product rounded before the add is run
    beside it: the voxels where the two roundings part are counted, and
    some must, or the drive reaches no knife-edge."""
    import numpy as np
    import torch

    from gvom_tpu_torch import GvomConfig
    from gvom_tpu_torch.io import synthetic
    from gvom_tpu_torch.ops import kernels, raycast

    cfg = GvomConfig(xy_size=16, z_size=32, max_points=1024, buffer_size=4)
    parted, passes = [], 0
    for s in range(1, C4_SCANS + 1):
        ego_np = np.array([0.3, -0.2, 1.5]) + s * np.array([0.9, 0.6, 0.02])
        pts = synthetic.nudge_off_grid(synthetic.simulate_lidar_scan(
            synthetic.composite_terrain(), ego_np, channels=32, azimuth_steps=64, max_range=25.0, seed=s),
            cfg.xy_resolution, cfg.z_resolution)
        pad, mask = synthetic.pad_scan(pts, cfg.max_points)
        pts_t, valid, ego = scan_tensors((pad, mask, ego_np), dev)
        p, keep, origin, _ = kernels.prepare_points(cfg, pts_t[None], valid[None], ego[None], frame_ego=ego)
        got = kernels.ray_pass_counts(cfg, p, keep, ego[None], origin)
        m = raycast.march_inputs(cfg, p[0], keep[0], ego, origin)
        exact(f"K1 on knife-edge scan {s}", got, raycast.ray_pass_counts_plain(cfg, m, origin))
        fma = raycast.gridops.fma32
        raycast.gridops.fma32 = lambda a, b, c: a * b + c      # the product rounded first
        try:
            rounded = raycast.ray_pass_counts_plain(cfg, m, origin)
        finally:
            raycast.gridops.fma32 = fma
        parted.append(int((rounded != got).sum()))
        passes += int(got.sum())
    check(sum(parted) > 0, "knife-edge drive: no voxel where the FMA and the rounded product part")
    log(f"phase 1 knife edges (16×16×32, {C4_SCANS} scans, {passes} passes): K1 bitwise its plain version (one "
        f"FMA a position); the product rounded first would part from it at {parted} voxels")


def phase1_kernels_vs_plain(cfg, scans, dev, log, extras=True):
    """Each kernel against its plain version on the same inputs, over a drive
    with a moving ego. Returns the max abs error per kernel and the last
    scan's inputs (for the timings). extras: also the sweeps and the
    crafted inputs of the plane fit's tail, the stencils, the maps' tail and the
    merge, which do not depend on the drive."""
    import torch

    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import binning, kernels, moments, raycast
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

    err = {k.name: 0.0 for k in kernels.KERNELS}
    buf, world = empty_buffer_state(cfg, dev), empty_world_state(cfg, dev)
    X, Y, Z = cfg.grid_shape
    last = None
    for i, (pad, mask, ego_np) in enumerate(scans):
        pts, valid = torch.from_numpy(pad).to(dev), torch.from_numpy(mask).to(dev)
        ego = torch.tensor(ego_np, dtype=torch.float32, device=dev)
        p, keep, origin, _ = prepare_vs_plain(f"scan {i}", cfg, pts[None], valid[None], ego[None], frame_ego=ego)
        p, keep = p[0], keep[0]
        m = raycast.march_inputs(cfg, p, keep, ego, origin)

        passes = raycast.ray_pass_counts(cfg, p, keep, ego, origin)
        exact("K1 passes", passes, raycast.ray_pass_counts_plain(cfg, m, origin))

        kb, pb = kernels.bin_points(cfg, p, keep, origin), binning.bin_points(cfg, p, keep, origin)
        exact("K2 hit", kb.hit, pb.hit)
        exact("K2 min_height", kb.min_height, pb.min_height)
        err["bin_points"] = max(err["bin_points"], sums_close("K2", kb.sums, pb.sums))

        slot = torch.ones((1,), dtype=torch.int32, device=dev)
        ko = torch.zeros((2, 10, X, Y, Z), dtype=torch.float32, device=dev)
        po = torch.zeros_like(ko)
        kernels.ingest_epilogue(cfg, kb.n, kb.rest, kb.hit, origin, ko, slot)
        moments.ingest_epilogue_plain(cfg, kb.n, kb.rest, kb.hit, origin, po, slot)
        exact("K3 untouched slot", ko[0], po[0])
        exact("K3 n", ko[1, 0], po[1, 0])
        err["ingest_epilogue"] = max(err["ingest_epilogue"], close("K3 moments", ko[1], po[1]))
        # K5: the same box into a fresh tensor, the occupancy mask on and off
        for mask in (True, False):
            km = kernels.moments_epilogue(cfg, kb.n, kb.rest, kb.hit, origin, occupancy_mask=mask)
            pm = moments.moments_epilogue_plain(cfg, kb.n, kb.rest, kb.hit, origin, occupancy_mask=mask)
            err["moments_epilogue"] = max(err["moments_epilogue"], moments_close(f"K5 mask={mask}", km, pm))
            if mask:
                exact("K5 masked vs K3's slot", km, ko[1])
            else:
                check(bool((km[:, kb.hit == 0] != 0).any()), "K5 mask off: no moments at voxels without a hit")
            del km, pm
        if i == 0:
            nan_blind("K3", lambda n, r: kernels.ingest_epilogue(cfg, n, r, kb.hit, origin, ko, slot), kb.n, kb.rest)
            for mask in (True, False):
                nan_blind(f"K5 mask={mask}", lambda n, r: kernels.moments_epilogue(cfg, n, r, kb.hit, origin,
                                                                               occupancy_mask=mask), kb.n, kb.rest)
        del ko, po, pb

        buf, scan_ok = pipeline.ingest_and_insert(cfg, buf, pts, valid, ego)
        check(bool(scan_ok), f"scan {i} has no occupied voxel")
        target = buf.grids.origin.index_select(0, buf.last_slot.reshape(1).long())[0]
        ko = combine_vs_plain(cfg, buf, world, ego, "K4")
        world, products, ok = pipeline.combine(cfg, buf, world, ego)
        check(bool(ok), f"combine after scan {i} reports an empty buffer")
        hm, ihm = products.height, products.inferred_height
        # the 2-D maps from K4's torus-layout column maps: the plane fit, then the guess
        fit_in = (ko[5], ko[6], target)
        fitted = plane_fit_vs_plain(f"combine {i}", cfg, *fit_in)
        guess_in = (fitted[0], fitted[1], fitted[3], fitted[4]) + tuple(ko[7:10]) + (target,)
        guessed = guess_vs_plain(f"combine {i}", cfg, *guess_in)
        for name, a in zip(FIT_OUTPUTS + GUESS_OUTPUTS, tuple(fitted) + tuple(guessed)):
            bitwise(f"combine {i}: the kernels vs the pipeline's {name}", a, getattr(products, name))
        del ko
        revived = int(((world.grid.hit > 0) & (buf.grids.hit[buf.last_slot.long()] == 0)).sum())
        log(f"phase 1 scan {i} ({cfg.xy_size}×{cfg.xy_size}×{cfg.z_size}): origin {origin.tolist()}, "
            f"{int(keep.sum())} points kept, "
            f"{int((kb.hit > 0).sum())} occupied voxels, {int(passes.sum())} passes, "
            f"world occupied {int((world.grid.hit > 0).sum())} ({revived} not in the newest scan), "
            f"{searching_cells(hm, ihm)} of {hm.numel()} map cells search in the guess: "
            "the preparation, K1-K5, the plane fit and the guess height (the maps' tail folded into them) agree "
            "with their plain versions" + (
                ", K3 and K5 (mask on, off) bitwise the same on NaN-poisoned sums" if i == 0 else ""))
        last = dict(pts=pts, valid=valid, ego=ego, p=p, origin=origin, keep=keep, bins=kb, target=target,
                    hm=hm, ihm=ihm, fit_in=fit_in, guess_in=guess_in)
    if extras:
        last["tail_fit"] = plane_fit_sweep(dev, log)
        last["guess_routes"] = phase1_stencils(cfg, dev, log)
        phase1_maptail(cfg, dev, log)
        phase1_merge(cfg, dev, log)
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
    return ko


def live_slots(cfg, buf):
    """[B, X, Y] bool: the ring buffer's slots that K4 reads at each column,
    those valid with the column inside both the slot's window and the
    newest slot's (columns.cuh, axis_ok)."""
    import torch

    X, Y, _ = cfg.grid_shape
    org = buf.grids.origin[:cfg.buffer_size].long()
    target = org[int(buf.last_slot)]

    def axis_ok(axis, size):
        rel = (torch.arange(size, device=org.device)[None] - target[axis]) % size
        d = (target[axis] - org[:, axis])[:, None]
        return (rel >= -d.clamp(max=0)) & (rel < size - d.clamp(min=0))

    return buf.slot_valid[:, None, None] & axis_ok(0, X)[:, :, None] & axis_ok(1, Y)[:, None, :]


def phase1_combine_other_b(dev, log):
    """K4 at other ring-buffer depths and z sizes on a small grid, held
    against fuse_plain after each ingest, every output bitwise, over a drive
    that fills the ring buffer and wraps its cursor (B + 1 scans, at least
    4; the 4 scans taken in turn, so that every slot's window holds most
    columns): B = 2 at Z = 96, B = 7 at Z = 31 and B = 16 at Z = 64, each a
    library of its own (the four-chunk path with 4-byte accesses, and the
    deepest unrolled kernel with 8-byte ones); past 16 slots or 256 z the
    grouped kernel (the up-front library): B = 17 and 33 (one and two
    ballots of 32 slots; every group of four live slots of each), Z = 257
    (odd: 4-byte accesses) and 320 (8-byte), and Z = 800, whose column's
    band inputs are past the 48 KB of shared memory that eight columns have
    (Z > 768), so its band sums read the column's scalar channels again.
    Fails unless the full ring of B = 17 and 33 has a column with every slot
    live, and B = 33 one with slot 32 (the second ballot) live."""
    from gvom_tpu_torch import GvomConfig
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

    scans = make_scans(GvomConfig(max_points=4096), 4, dict(channels=32, azimuth_steps=128))
    for B, Z in OTHER_B_Z:
        cfg = GvomConfig(xy_size=64, z_size=Z, max_points=4096, buffer_size=B)
        buf, world = empty_buffer_state(cfg, dev), empty_world_state(cfg, dev)
        n = max(len(scans), B + 1)
        for i in range(n):
            pts, valid, ego = scan_tensors(scans[i % len(scans)], dev)
            buf, _ = pipeline.ingest_and_insert(cfg, buf, pts, valid, ego)
            combine_vs_plain(cfg, buf, world, ego, f"K4 B={B} Z={Z} scan {i}")
            world, _, ok = pipeline.combine(cfg, buf, world, ego)
            check(bool(ok), f"K4 B={B}: combine after scan {i} reports an empty buffer")
        live = live_slots(cfg, buf)
        most, past31 = int(live.sum(0).max()), int(live[32:].any(0).sum())
        if B > 16:
            check(most == B, f"K4 B={B}: after {n} scans no column has all {B} slots live (at most {most})")
        if B > 32:
            check(past31 > 0, f"K4 B={B}: after {n} scans no column has a slot past 31 live")
        top = int((world.grid.hit[:, :, 256:] > 0).sum()) if Z > 256 else None
        log(f"phase 1 K4 at B = {B}, 64×64×{Z}: every output bitwise against fuse_plain over {n} scans (the ring "
            f"wrapped; at most {most} live slots at a column" + (f", {past31} columns with a slot past 31 live"
                                                                 if B > 32 else "") + "), world "
            f"occupied {int((world.grid.hit > 0).sum())}" + (f" ({top} at torus z >= 256)" if Z > 256 else ""))


def negative_threshold_cells(cfg, hm_t, ihm_t, origin):
    """hm_t and ihm_t with three window cells whose guessed delta is exactly
    the negative-obstacle threshold, one float below it and one above: an
    unmeasured cell whose inferred height is that value, its eight
    neighbours measured at 0, so that every wedge finds a 0 at its first
    step. Returns (hm_t, ihm_t, the cells, their deltas)."""
    import numpy as np
    import torch

    from gvom_tpu_torch.ops.grid import torus_to_window, window_to_torus
    from gvom_tpu_torch.types import UNKNOWN_HEIGHT

    thr = np.float32(cfg.negative_obstacle_threshold)
    values = (thr, np.nextafter(thr, np.float32(0)), np.nextafter(thr, np.float32(np.inf)))
    hm, ihm = (torus_to_window(a, origin, grid_ndim=2).clone() for a in (hm_t, ihm_t))
    cells = [(16 * (k + 1), 16) for k in range(len(values))]
    for (x, y), v in zip(cells, values):
        hm[x - 1:x + 2, y - 1:y + 2] = 0.0
        hm[x, y] = UNKNOWN_HEIGHT
        ihm[x, y] = float(v)
    return (window_to_torus(hm, origin, grid_ndim=2).contiguous(), window_to_torus(ihm, origin, grid_ndim=2).contiguous(),
            cells, torch.tensor(values, dtype=torch.float32, device=hm.device))


def phase1_maptail(cfg, dev, log):
    """The maps' tail, which the plane-fit kernel takes as its load and the
    guess kernel as its epilogue, on io.synthetic.map_tail_inputs at the
    upstream map size (slopes at the slope threshold and one float on
    either side, den = 0, heights at UNKNOWN_HEIGHT and one float on either
    side, band cells on the map's edges), at four origins, with three cells
    whose guessed delta the search makes exactly the negative threshold and
    one float on either side (negative_threshold_cells): both kernels
    against their plain versions, and the folded outputs against the tail's
    own twins (maps_to_window_plain; map_products_plain on the kernel's
    delta), bit for bit."""
    import torch

    from gvom_tpu_torch.io.synthetic import map_tail_inputs
    from gvom_tpu_torch.ops import maps2d

    X = cfg.xy_size
    counts = []
    for i, origin in enumerate(MAP_TAIL_ORIGINS):
        d = {k: torch.from_numpy(v).to(dev) for k, v in map_tail_inputs(
            X, cfg.slope_obstacle_threshold, cfg.negative_obstacle_threshold, i).items()}
        o = torch.tensor(origin, dtype=torch.int32, device=dev)
        what = f"crafted map at origin {origin}"
        hm_t, ihm_t, cells, deltas = negative_threshold_cells(cfg, d["hm_t"], d["ihm_t"], o)
        fitted = plane_fit_vs_plain(what, cfg, hm_t, ihm_t, o)
        for name, a, b in zip(("height", "inferred height"), fitted[:2], maps2d.maps_to_window_plain(hm_t, ihm_t, o)):
            bitwise(f"{what}: the plane fit's window {name} vs maps_to_window_plain", a, b)
        bands = (d["pnum"], d["pden"], d["band_ok"])
        got = guess_vs_plain(what, cfg, fitted[0], fitted[1], d["slope_x"], d["slope_y"], *bands, o)
        for name, a, b in zip(("positive", "negative", "visibility"), got[1:], maps2d.map_products_plain(
                cfg, *bands, d["slope_x"], d["slope_y"], got[0], fitted[0], o)):
            bitwise(f"{what}: the guess kernel's {name} vs map_products_plain", a, b)
        at = tuple(torch.tensor(c, device=dev) for c in zip(*cells))
        bitwise(f"{what}: the deltas at the negative threshold", got[0][at], deltas)
        exact(f"{what}: negative obstacles at the threshold", got[2][at],
              torch.tensor([0, 0, 100], dtype=torch.int32, device=dev))
        counts.append([int((got[1] == 100).sum()), int((got[2] > 0).sum()), int(got[3].sum())])
    log(f"phase 1 maps' tail: the plane fit's window layout and the guess kernel's obstacle maps and visibility "
        f"bitwise their plain versions on the crafted {X}×{X} map at origins {list(MAP_TAIL_ORIGINS)}, deltas at "
        f"the negative threshold and one float on either side (cells at 100, negative, visible: {counts})")


def copy_grid(g):
    from gvom_tpu_torch.types import VoxelGrid

    return VoxelGrid(hit=g.hit.clone(), miss=g.miss.clone(), min_height=g.min_height.clone(), mom=g.mom.clone(),
                     origin=g.origin.clone())


def merge_vs_plain(what, cfg, world, contrib, ego, y0=0):
    """The merge kernel (csrc/merge.cu) against its plain twin on the same
    inputs: every merged channel (the moments too: one add a voxel, in the
    twin's order), the evidence and the column maps bit for bit. The kernel
    writes over its contribution, so it gets a copy. Returns its outputs."""
    from gvom_tpu_torch.ops import kernels
    from gvom_tpu_torch.parallel.sharding import merge_and_columns_plain

    ref = merge_and_columns_plain(cfg, world, contrib, ego, y0)
    got = kernels.merge_batch(cfg, world, copy_grid(contrib), ego, y0)
    for name in ("hit", "miss", "min_height", "mom", "origin"):
        bitwise(f"{what}: merged {name}", getattr(got[0], name), getattr(ref[0], name))
    for name, a, b in zip(("evidence", "height and inferred height", "band sums and band_ok"), got[1:], ref[1:]):
        bitwise(f"{what}: {name}", a, b)
    return got


def slab_rows(t, dim, y0, Ys):
    return t.narrow(dim, y0, Ys).contiguous()


def merge_slab(world, contrib, y0, Ys):
    """(world, contrib) of the merge on the y-slab [y0, y0+Ys): copies of
    their rows, as a slab rank holds them."""
    from gvom_tpu_torch.types import VoxelGrid, WorldState

    def rows(t, dim):
        return slab_rows(t, dim, y0, Ys)

    w = world.grid
    ws = WorldState(grid=VoxelGrid(hit=rows(w.hit, 1), miss=rows(w.miss, 1), min_height=rows(w.min_height, 1),
                                   mom=rows(w.mom, 2), origin=w.origin), evidence=rows(world.evidence, 1),
                    valid=world.valid)
    cs = VoxelGrid(hit=rows(contrib.hit, 1), miss=rows(contrib.miss, 1), min_height=rows(contrib.min_height, 1),
                   mom=rows(contrib.mom, 2), origin=contrib.origin)
    return ws, cs


def merge_slab_vs_full(what, cfg, world, contrib, ego, full, y0, Ys):
    """The merge kernel on the y-slab [y0, y0+Ys) of the world and the
    contribution against the rows of its full-grid result `full`."""
    from gvom_tpu_torch.ops import kernels

    def rows(t, dim):
        return slab_rows(t, dim, y0, Ys)

    got = kernels.merge_batch(cfg, *merge_slab(world, contrib, y0, Ys), ego, y0)
    for name in ("hit", "miss", "min_height", "mom"):
        d = 2 if name == "mom" else 1
        bitwise(f"{what}: slab {name}", getattr(got[0], name), rows(getattr(full[0], name), d))
    bitwise(f"{what}: slab evidence", got[1], rows(full[1], 1))
    bitwise(f"{what}: slab column maps", got[2], rows(full[2], 2))
    bitwise(f"{what}: slab band sums", got[3], rows(full[3], 2))


def seeded_merge_inputs(cfg, dev, seed, d_origin, valid):
    """(world, contrib, ego) on the card from a seeded generator: an old
    world at (10, -5, 3), 5 % of its voxels occupied, its moments masked by
    its occupancy, evidence where it is empty; a contribution at the origin
    moved by d_origin with raw moments everywhere."""
    import torch

    from gvom_tpu_torch.types import VoxelGrid, WorldState

    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    shape = cfg.grid_shape

    def grid(origin, raw):
        hit = (torch.rand(shape, generator=g, device=dev) < 0.05).int() * torch.randint(
            1, 40, shape, generator=g, device=dev, dtype=torch.int32)
        mom = torch.randn((10,) + shape, generator=g, device=dev)
        return VoxelGrid(hit=hit, miss=torch.randint(0, 30, shape, generator=g, device=dev, dtype=torch.int32),
                         min_height=torch.rand(shape, generator=g, device=dev), mom=mom if raw else mom * (hit > 0),
                         origin=torch.tensor(origin, dtype=torch.int32, device=dev))

    old = grid((10, -5, 3), False)
    ev = torch.randint(0, 5, shape, generator=g, device=dev, dtype=torch.int32) * (old.hit == 0)
    world = WorldState(grid=old, evidence=ev, valid=torch.tensor(valid, device=dev))
    o = tuple(a + b for a, b in zip((10, -5, 3), d_origin))
    ego = torch.tensor([(cfg.xy_size / 2 + 10.3 + o[0]) * cfg.xy_resolution,
                        (cfg.xy_size / 2 - 4.7 + o[1]) * cfg.xy_resolution, 1.3], device=dev)
    return world, grid(o, True), ego


def phase1_merge(cfg, dev, log):
    """The merge kernel against its twin on seeded upstream worlds: the
    origin moved in x, y and z, an old world not yet valid, an origin so
    far that the windows do not overlap, a shift in z alone; and the
    quarter slab y0 = 64 of each against the full result's rows."""
    cases = (("moved", (3, -2, 1), True), ("invalid world", (3, -2, 1), False), ("far", (500, 0, 0), True),
             ("z shift", (0, 1, -7), True))
    Ys = cfg.xy_size // 4
    counts = {}
    for i, (case, d_origin, valid) in enumerate(cases):
        world, contrib, ego = seeded_merge_inputs(cfg, dev, 100 + i, d_origin, valid)
        full = merge_vs_plain(f"merge, {case}", cfg, world, contrib, ego)
        merge_slab_vs_full(f"merge, {case}", cfg, world, contrib, ego, full, Ys, Ys)
        counts[case] = [int((full[0].hit > 0).sum()), int((full[0].hit > contrib.hit).sum())]
    log(f"phase 1 merge: the merge kernel bitwise its plain version on seeded upstream worlds and their quarter "
        f"slab y0 = {Ys} (occupied, old voxels joined: {counts})")


def merge_bound(cfg, world, contrib, y0=0):
    """(bytes, counts) that the merge must move on this data, as its twin
    reads its inputs: the batch's hit, miss and min_height everywhere and its
    moments where it occupies; the old world's hit and evidence where the
    windows overlap and it is valid, its miss and min_height where its
    occupied voxel stays occupied, its moments where the windows overlap and
    the merged voxel is occupied; four scalar channels and ten moment
    channels written, and five [X, Ys] maps. A slab's rows start at y0."""
    import torch

    from gvom_tpu_torch.ops import grid as gridops
    from gvom_tpu_torch.parallel.sharding import merge_batch_plain

    X, Ys, Z = contrib.hit.shape
    V, f32 = X * Ys * Z, 4
    dev = contrib.hit.device
    coords = tuple(torch.arange(a, a + n, dtype=torch.int32, device=dev) for a, n in ((0, X), (y0, Ys), (0, Z)))
    _, _, occ2 = merge_batch_plain(cfg, world, contrib, coords)
    om = gridops.overlap_mask(cfg, contrib.origin, world.grid.origin, coords)
    ow = om & world.valid
    counts = dict(voxels=V, batch_occupied=int((contrib.hit > 0).sum()), old_read=int(ow.sum()),
                  old_kept=int((ow & (world.grid.hit > 0) & occ2).sum()), old_moments=int((om & occ2).sum()))
    words = (3 * V + 10 * counts["batch_occupied"] + 2 * counts["old_read"] + 2 * counts["old_kept"]
             + 10 * counts["old_moments"] + 14 * V + 5 * X * Ys + 3 + 3 + 3 + 1)
    return words * f32, counts


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

    pts, valid, ego = scan_tensors(scan, dev)
    p, keep, origin, _ = kernels.prepare_points(cfg, pts[None], valid[None], ego[None], frame_ego=ego)
    p, keep = p[0], keep[0]
    m = raycast.march_inputs(cfg, p, keep, ego, origin)
    Y = cfg.xy_size
    Ys = Y // 4
    seam = int(origin[1]) % Y          # the torus row of window row 0
    check(seam % Ys != 0, f"the window seam (torus row {seam}) lies on a slab boundary, not inside a slab")
    full_pass = raycast.ray_pass_counts(cfg, p, keep, ego, origin)
    full_bins = kernels.bin_points(cfg, p, keep, origin)
    full_mom = {mask: kernels.moments_epilogue(cfg, full_bins.n, full_bins.rest, full_bins.hit, origin,
                                               occupancy_mask=mask)
                for mask in (True, False)}
    for k in range(4):
        yw = (k * Ys, Ys)
        rows = slice(k * Ys, (k + 1) * Ys)
        kp = raycast.ray_pass_counts(cfg, p, keep, ego, origin, y_window=yw)
        exact(f"K1 slab {k} vs plain", kp, raycast.ray_pass_counts_plain(cfg, m, origin, yw))
        exact(f"K1 slab {k} vs the full grid's rows", kp, full_pass[:, rows].contiguous())
        kb, pb = kernels.bin_points(cfg, p, keep, origin, yw), binning.bin_points(cfg, p, keep, origin, yw)
        for name in ("hit", "min_height"):
            exact(f"K2 slab {k} {name} vs plain", getattr(kb, name), getattr(pb, name))
            exact(f"K2 slab {k} {name} vs the full grid's rows", getattr(kb, name),
                  getattr(full_bins, name)[:, rows].contiguous())
        err["bin_points_slab"] = max(err["bin_points_slab"], sums_close(f"K2 slab {k}", kb.sums, pb.sums))
        has_seam = k * Ys <= seam < (k + 1) * Ys
        for mask in (True, False):
            km = kernels.moments_epilogue(cfg, kb.n, kb.rest, kb.hit, origin, yw, mask)
            pm = moments.moments_epilogue_plain(cfg, kb.n, kb.rest, kb.hit, origin, yw, mask)
            e1 = moments_close(f"K5 slab {k} mask={mask} vs plain", km, pm)
            e2 = moments_close(f"K5 slab {k} mask={mask} vs the full grid's rows", km,
                               full_mom[mask][:, :, rows].contiguous())
            err["moments_epilogue_slab"] = max(err["moments_epilogue_slab"], e1, e2)
            if has_seam:
                nan_blind(f"K5 slab {k} mask={mask}",
                          lambda n, r: kernels.moments_epilogue(cfg, n, r, kb.hit, origin, yw, mask), kb.n, kb.rest)
        if has_seam:
            last = dict(p=p, ego=ego, origin=origin, keep=keep, bins=kb, y_window=yw,
                        full_n=full_bins.n[0], full_hit=full_bins.hit)
    del full_mom, full_pass

    kernels.reset_launches()
    with watch_fma32() as per_point:
        grid, ok = pipeline.ingest_scan(cfg, pts, valid, ego)
        slabs = [pipeline.ingest_scan(cfg, pts, valid, ego, y_window=(k * Ys, Ys)) for k in range(4)]
    launches = {k.name: k.launches for k in kernels.KERNELS}
    check(not per_point, f"ingest_scan: float64 fma32 or sqrt32 on the card: {per_point[:3]}")
    for name in ("ray_pass_counts", "bin_points", "moments_epilogue"):
        check(launches[name] == 1 and launches[name + "_slab"] == 4,
              f"ingest_scan: {name} launched {launches[name]} times, its slab form {launches[name + '_slab']}")
    check(launches["prepare_points"] == 5, f"ingest_scan: prepare launched {launches['prepare_points']} times, not 5")
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

    from gvom_tpu_torch.ops import raycast

    pts, valid, ego = scan_tensors(scan, dev)
    d = pts - ego
    lim = (NEAR_TIER_STEPS - 1.5) * min(cfg.xy_resolution, cfg.z_resolution)
    near = ego + d * torch.clamp(lim / d.norm(dim=1).clamp(min=1e-6), max=1.0)[:, None]
    p, keep, origin, _ = prepare_vs_plain("near tier", cfg, near[None].contiguous(), valid[None], ego[None],
                                          frame_ego=ego)
    p, keep = p[0], keep[0]
    m = raycast.march_inputs(cfg, p, keep, ego, origin)
    k = raycast.ray_pass_counts(cfg, p, keep, ego, origin)
    exact("K1 near tier vs plain", k, raycast.ray_pass_counts_plain(cfg, m, origin))
    short = dataclasses.replace(cfg, ray_steps_override=NEAR_TIER_STEPS)
    exact(f"K1 near tier: a ray goes beyond step {NEAR_TIER_STEPS}",
          raycast.ray_pass_counts(short, p, keep, ego, origin), k)
    check(int(k.sum()) > int(keep.sum()), "near tier: no passes")
    log(f"phase 1 near tier: {int(keep.sum())} rays of under {NEAR_TIER_STEPS} steps, {int(k.sum())} passes: K1 "
        "agrees with its plain version")


def box_reference(cfg, sums, hit, origin, y_window, mask):
    """(ref, bound) of an epilogue's moments on these sums: ref the plain
    version in float64, and bound the float32 summation bound of each
    output, (m + 8)·2^-24 times the box's sum of |terms| (the plain
    version on |sums| with |offset| translations, in float64), where m is
    the box's (2rx+1)(2ry+1)(2rz+1) terms and each term rounds a few
    times more. Any order of the f32 additions lies within it."""
    from gvom_tpu_torch.ops import binning, moments

    rx, ry, rz = binning.moment_pad(cfg)
    m = (2 * rx + 1) * (2 * ry + 1) * (2 * rz + 1)
    s64 = clean_sums(sums).double()
    ref = moments.moments_epilogue_plain(cfg, s64[:1], s64[1:], hit, origin, y_window, mask)
    translate = moments.translate_raw
    moments.translate_raw = lambda n, s1, s2, axis, t: translate(n, s1, s2, axis, abs(t))
    try:
        size = moments.moments_epilogue_plain(cfg, s64[:1], s64[1:].abs(), hit, origin, y_window, mask)
    finally:
        moments.translate_raw = translate
    return ref, (m + 8) * 2.0 ** -24 * size


def box_close(name, got, plain, ref, bound):
    """An epilogue's [10, ...] moments at a large box against its plain
    version: n bitwise, and the nine sums of both within the f32 summation
    bound of the float64 reference (box_reference). The box adds up to 867
    terms here, in another order than the plain version's one axis at a
    time; where they cancel, two f32 orders differ by more than MOM_RTOL /
    MOM_ATOL, which are stated for the 27 terms of the upstream box.
    Returns the largest |got − plain|."""
    exact(f"{name} n", got[0], plain[0])
    for who, a in (("kernel", got), ("plain version", plain)):
        over = int(((a.double() - ref).abs() > bound).sum())
        check(over == 0, f"{name}: the {who} is off the float64 reference by more than the f32 bound at {over} "
                         f"elements")
    return float((got - plain).abs().max())


def epilogue_vs_plain(name, route, got, plain, ref):
    """An epilogue's [10, ...] moments against its plain version: the plain
    version within the f32 summation bound of the float64 reference ref =
    (ref, bound) (box_reference); the separable passes bitwise on all ten
    channels, since they add in the plain version's order; the direct kernel
    (box_close) with n bitwise and the nine sums within that bound. Returns
    the largest |got - plain|."""
    over = int(((plain.double() - ref[0]).abs() > ref[1]).sum())
    check(over == 0, f"{name}: the plain version is off the float64 reference by more than the f32 bound at "
                     f"{over} elements")
    if route == "direct":
        return box_close(name, got, plain, *ref)
    bitwise(f"{name} ({route}, all ten channels)", got, plain)
    return 0.0


def phase1_epilogue_radii(cfg, scan, dev, log, err):
    """The epilogue at eigen distances past its tiled box (EIGEN_DISTS): on
    one upstream scan, K2 and then K3 into a slot, K5 with the mask on and
    off, and the slab form on the quarter slab that holds the window seam,
    each against its plain version (epilogue_vs_plain: the separable passes
    bitwise, the direct kernel that the mask on keeps at a small box within
    the f32 summation bound) and bitwise the same on NaN-poisoned sums; K5's
    masked output bitwise K3's slot. Records each (radius, grid, mask)'s
    kernel and each radius's launches, and times K5 on the full grid with
    the mask off (beside the conv3d yardstick) and on. The parent tree's
    forms are timed beside these by scripts/time_wide_forms.py."""
    import torch

    from gvom_tpu_torch.ops import binning, kernels, moments
    from gvom_tpu_torch.ops import grid as gridops

    pts, valid, ego = scan_tensors(scan, dev)
    routes, timings, launches = {}, {}, {}
    for xye, ze in EIGEN_DISTS:
        c = dataclasses.replace(cfg, xy_eigen_dist=xye, z_eigen_dist=ze)
        X, Y, Z = c.grid_shape
        kernels.reset_launches()
        p, keep, origin, _ = kernels.prepare_points(c, pts[None], valid[None], ego[None], frame_ego=ego)
        p, keep = p[0], keep[0]
        kb, pb = kernels.bin_points(c, p, keep, origin), binning.bin_points(c, p, keep, origin)
        exact(f"K2 at eigen ({xye}, {ze}) hit", kb.hit, pb.hit)
        err["bin_points"] = max(err["bin_points"], sums_close(f"K2 at eigen ({xye}, {ze})", kb.sums, pb.sums))
        slot = torch.ones((1,), dtype=torch.int32, device=dev)
        ko = torch.zeros((2, 10, X, Y, Z), dtype=torch.float32, device=dev)
        po = torch.zeros_like(ko)
        kernels.ingest_epilogue(c, kb.n, kb.rest, kb.hit, origin, ko, slot)
        moments.ingest_epilogue_plain(c, kb.n, kb.rest, kb.hit, origin, po, slot)
        exact(f"K3 at eigen ({xye}, {ze}) untouched slot", ko[0], po[0])
        for mask in (True, False):
            route = routes[f"({xye}, {ze}) full mask {'on' if mask else 'off'}"] = kernels.epilogue_route(
                c, None, mask)
            km = kernels.moments_epilogue(c, kb.n, kb.rest, kb.hit, origin, occupancy_mask=mask)
            pm = moments.moments_epilogue_plain(c, kb.n, kb.rest, kb.hit, origin, occupancy_mask=mask)
            ref = box_reference(c, kb.sums, kb.hit, origin, None, mask)
            e = epilogue_vs_plain(f"K5 at eigen ({xye}, {ze}) mask={mask}", route, km, pm, ref)
            err["moments_epilogue"] = max(err["moments_epilogue"], e)
            if mask:
                exact(f"K5 masked vs K3's slot at eigen ({xye}, {ze})", km, ko[1])
                err["ingest_epilogue"] = max(err["ingest_epilogue"], epilogue_vs_plain(
                    f"K3 at eigen ({xye}, {ze})", route, ko[1], po[1], ref))
            nan_blind(f"K5 at eigen ({xye}, {ze}) mask={mask}",
                      lambda n, r: kernels.moments_epilogue(c, n, r, kb.hit, origin, occupancy_mask=mask),
                      kb.n, kb.rest)
            del km, pm, ref
        nan_blind(f"K3 at eigen ({xye}, {ze})", lambda n, r: kernels.ingest_epilogue(c, n, r, kb.hit, origin, ko, slot),
                  kb.n, kb.rest)
        del ko, po, pb
        # the slab form on the quarter slab that holds the window seam
        Ys = Y // 4
        yw = ((int(origin[1]) % Y) // Ys * Ys, Ys)
        sb = kernels.bin_points(c, p, keep, origin, yw)
        for mask in (True, False):
            route = routes[f"({xye}, {ze}) slab mask {'on' if mask else 'off'}"] = kernels.epilogue_route(
                c, yw, mask)
            km = kernels.moments_epilogue(c, sb.n, sb.rest, sb.hit, origin, yw, mask)
            pm = moments.moments_epilogue_plain(c, sb.n, sb.rest, sb.hit, origin, yw, mask)
            ref = box_reference(c, sb.sums, sb.hit, origin, yw, mask)
            err["moments_epilogue_slab"] = max(err["moments_epilogue_slab"], epilogue_vs_plain(
                f"K5 slab {yw} at eigen ({xye}, {ze}) mask={mask}", route, km, pm, ref))
            del km, pm, ref
            nan_blind(f"K5 slab at eigen ({xye}, {ze}) mask={mask}",
                      lambda n, r: kernels.moments_epilogue(c, n, r, sb.hit, origin, yw, mask), sb.n, sb.rest)
        launches[f"({xye}, {ze})"] = {k.name: k.launches for k in (kernels.EPI, kernels.XBOX, kernels.XBOX_SLAB)}
        for name, n in launches[f"({xye}, {ze})"].items():
            check(n > 0, f"eigen ({xye}, {ze}): {name} was launched no time")
        everywhere = torch.ones((X, Y, Z), dtype=torch.bool, device=dev)
        # the yardstick of phase 4: conv3d of the padded sums is the ±r box (the mask off)
        wconv, conv_in = box_conv_weights(c, dev), clean_sums(kb.sums)[None]
        conv_err = float((torch.nn.functional.conv3d(conv_in, wconv)[0]
                          - moments.box_aggregate_moments(c, kb.sums)).abs().max())
        log(f"library yardstick check at eigen ({xye}, {ze}): conv3d box vs plain box max abs err {conv_err}")
        for mask in (False, True):
            targets = kb.hit > 0 if mask else everywhere
            nbytes, terms, _, _ = epilogue_bound(c, kb.n[0], gridops.torus_to_window(targets, origin),
                                                 X * Y * Z, mask)
            what = f"moments_epilogue mask {'on' if mask else 'off'}, eigen ({xye}, {ze})"
            timings[what] = dict(form_timing(
                what, lambda: kernels.moments_epilogue(c, kb.n, kb.rest, kb.hit, origin, occupancy_mask=mask), nbytes,
                52 * terms / F32_OPS_PER_S, log,
                lib=None if mask else lambda: torch.nn.functional.conv3d(conv_in, wconv),
                plain=lambda: moments.moments_epilogue_plain(c, kb.n, kb.rest, kb.hit, origin, occupancy_mask=mask)),
                route=routes[f"({xye}, {ze}) full mask {'on' if mask else 'off'}"])
            if not mask:
                timings[what]["library_max_abs_err"] = conv_err
        del kb, sb, everywhere, wconv, conv_in
    routes[f"({cfg.xy_eigen_dist}, {cfg.z_eigen_dist}) full mask on"] = kernels.epilogue_route(cfg, None, True)
    check(set(routes.values()) == set(kernels.EPILOGUE_ROUTES),
          f"the epilogue's three kernels were not all chosen: {routes}")
    # past the separable passes' smallest tile, one line of 2·xy_eigen_dist + 1 voxels by one z of ten channels
    # (80 B a voxel), the direct kernel takes the box with the mask on or off: no radius is refused (asked here at
    # the upstream grid; launched by phase1_epilogue_direct_wide on a small one)
    optin = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin", 227 * 1024)
    r_max = (optin // 80 - 1) // 2
    for xye, mask, want in ((r_max, False, "separable"), (r_max + 1, False, "direct"), (r_max + 1, True, "direct")):
        got = routes[f"({xye}, 1) full mask {'on' if mask else 'off'}"] = kernels.epilogue_route(
            dataclasses.replace(cfg, xy_eigen_dist=xye, z_eigen_dist=1), None, mask)
        check(got == want, f"the epilogue at eigen ({xye}, 1), mask {mask}: the route query answers {got}, not "
                           f"{want} ({optin} B of shared memory a block)")
    log(f"phase 1 epilogue radii: K2, K3, K5 (mask on, off) and the slab epilogue at eigen distances "
        f"{list(EIGEN_DISTS)} agree with their plain versions (the separable passes bitwise on all ten channels) "
        f"and are bitwise the same on NaN-poisoned sums; kernel by (xy, z) eigen distance, grid and mask: {routes}")
    return dict(routes=routes, timings=timings, launches=launches)


def box_sparse(cfg, sums, hit, origin, mask, dtype, absolute=False):
    """The epilogue (K5's function) on sums with few non-empty voxels, as a
    sum over sources: each window voxel's box takes every voxel of the padded
    scratch with n > 0 within ±r of it, translated into its frame as the
    plain version translates it (translate_raw along x, then y, then z, by
    the source's offset), in dtype. Returns ([10, X, Y, Z] torus layout, the
    mask applied when mask; the most sources in one box). With absolute: the
    same on |sums| and |offsets|, the scale of a summation bound. At a large
    box this costs what the sources cost; the plain version sweeps the whole
    box of every voxel."""
    import torch

    from gvom_tpu_torch.ops import binning, moments
    from gvom_tpu_torch.ops import grid as gridops

    r = torch.tensor(binning.moment_pad(cfg), device=sums.device)
    X, Y, Z = cfg.grid_shape
    s = clean_sums(sums).to(dtype)
    src = torch.nonzero(s[0] > 0)                                   # [K, 3] padded scratch indices
    v = s[:, src[:, 0], src[:, 1], src[:, 2]]                       # [10, K]
    if absolute:
        v = v.abs()
    axes = [torch.arange(q, device=sums.device) for q in (X, Y, Z)]
    tgt = torch.stack(torch.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3) + r       # [T, 3]
    off = src[None] - tgt[:, None]                                  # [T, K, 3]
    inbox = (off.abs() <= r).all(-1)
    T, K = inbox.shape
    n, s1, s2 = v[0].expand(T, K), v[1:4, None].expand(3, T, K), v[4:10, None].expand(6, T, K)
    for ax in range(3):
        t = off[..., ax].to(dtype)
        s1, s2 = moments.translate_raw(n, s1, s2, ax, t.abs() if absolute else t)
    terms = torch.where(inbox, torch.cat([n[None], s1, s2]), torch.zeros((), dtype=dtype, device=sums.device))
    out = gridops.window_to_torus(terms.sum(-1).reshape(10, X, Y, Z), origin)
    if mask:
        out = torch.where(hit[None] > 0, out, torch.zeros((), dtype=dtype, device=sums.device))
    return out, int(inbox.sum(-1).max())


def phase1_epilogue_direct_wide(cfg, dev, log):
    """The direct epilogue kernel with the mask off, which takes every box
    whose separable passes' smallest tile does not fit in a block's shared
    memory (xy_eigen_dist past (optin / 80 − 1) / 2, 1452 on an H100), and
    with the mask on at that radius, launched on DIRECT_GRID at eigen
    (r_max + 1, 1): K2's padded scratch is then (2·r + X)² · (Z + 2) voxels of
    ten channels (2.0 GB). The sums come from DIRECT_POINTS seeded points
    over the padded box and DIRECT_HITS inside the window, so that the mask
    keeps voxels. K2 against its plain version; K5 (mask off, on) and K3
    into a slot against box_sparse in float32, the plain version's function
    on these sparse sums (the plain version's sweep of 2906 shifted copies
    of the scratch an axis would take minutes), with n bitwise and the nine
    sums, kernel and plain, within the f32 summation bound of box_sparse in
    float64: (m + 12)·2^-24 times the box's sum of |terms|, m the most
    sources in a box (adding a zero is exact) and 12 the roundings of a
    term's three translations. box_sparse is first held against
    moments_epilogue_plain at a small radius in float64. The route query
    must answer "direct" for both masks; K5 is timed with CUDA events over
    DIRECT_REPS launches after the checked one."""
    import torch

    from gvom_tpu_torch.ops import binning, kernels, moments
    from gvom_tpu_torch.ops import grid as gridops

    optin = getattr(torch.cuda.get_device_properties(0), "shared_memory_per_block_optin", 227 * 1024)
    r_max = (optin // 80 - 1) // 2
    X, Z = DIRECT_GRID
    origin = torch.tensor(DIRECT_ORIGIN, dtype=torch.int32, device=dev)
    g = torch.Generator(device="cpu").manual_seed(16)

    def bins(c):
        rx, _, rz = binning.moment_pad(c)
        lo = torch.tensor([-rx, -rx, -rz], dtype=torch.float64)
        span = torch.tensor([X + 2 * rx, X + 2 * rx, Z + 2 * rz], dtype=torch.float64)
        local = torch.cat([lo + torch.rand((DIRECT_POINTS, 3), generator=g, dtype=torch.float64) * span,
                           torch.rand((DIRECT_HITS, 3), generator=g, dtype=torch.float64)
                           * torch.tensor([X, X, Z], dtype=torch.float64)])
        res = torch.tensor([c.xy_resolution, c.xy_resolution, c.z_resolution], dtype=torch.float64)
        pts = ((local + origin.cpu().double()) * res).float().to(dev)
        keep = torch.ones(len(pts), dtype=torch.bool, device=dev)
        kb, pb = kernels.bin_points(c, pts, keep, origin), binning.bin_points(c, pts, keep, origin)
        exact(f"K2 at eigen {binning.moment_pad(c)[1:]} hit", kb.hit, pb.hit)
        sums_close(f"K2 at eigen {binning.moment_pad(c)[1:]}", kb.sums, pb.sums)
        return kb

    # box_sparse is the plain version's function: held in float64 at a radius that the plain version sweeps fast
    c = dataclasses.replace(cfg, xy_size=X, z_size=Z, xy_eigen_dist=5, z_eigen_dist=1)
    kb = bins(c)
    sums = kb.sums
    for mask in (False, True):
        s64 = clean_sums(sums).double()
        want = moments.moments_epilogue_plain(c, s64[:1], s64[1:], kb.hit, origin, occupancy_mask=mask)
        got, _ = box_sparse(c, sums, kb.hit, origin, mask, torch.float64)
        scale, _ = box_sparse(c, sums, kb.hit, origin, mask, torch.float64, absolute=True)
        check(bool(((got - want).abs() <= 1e-12 * scale).all()), f"box_sparse off the plain version, mask {mask}")

    c = dataclasses.replace(cfg, xy_size=X, z_size=Z, xy_eigen_dist=r_max + 1, z_eigen_dist=1)
    kb = bins(c)
    sums = kb.sums
    n_hit = int((kb.hit > 0).sum())
    check(0 < n_hit < X * X * Z, f"the mask keeps {n_hit} of {X * X * Z} voxels: it must keep some, not all")
    out = dict(eigen=[r_max + 1, 1], grid=[X, X, Z], points=DIRECT_POINTS + DIRECT_HITS, occupied=n_hit,
               scratch_bytes=sums.numel() * 4, K5={}, K3={})
    kernels.reset_launches()
    slot = torch.ones((1,), dtype=torch.int32, device=dev)
    for mask in (False, True):
        what = f"mask {'on' if mask else 'off'}"
        route = kernels.epilogue_route(c, None, mask)
        check(route == "direct", f"the epilogue at eigen ({r_max + 1}, 1), {what}: the route query answers {route}")
        plain, m = box_sparse(c, sums, kb.hit, origin, mask, torch.float32)
        ref, _ = box_sparse(c, sums, kb.hit, origin, mask, torch.float64)
        scale, _ = box_sparse(c, sums, kb.hit, origin, mask, torch.float64, absolute=True)
        bound = (m + 12) * 2.0 ** -24 * scale
        km = kernels.moments_epilogue(c, kb.n, kb.rest, kb.hit, origin, occupancy_mask=mask)
        e = box_close(f"K5 direct at eigen ({r_max + 1}, 1), {what}", km, plain, ref, bound)
        targets = kb.hit > 0 if mask else torch.ones_like(kb.hit, dtype=torch.bool)
        nbytes, terms, _, _ = epilogue_bound(c, kb.n[0], gridops.torus_to_window(targets, origin), X * X * Z, mask)
        ms = cuda_ms(lambda: kernels.moments_epilogue(c, kb.n, kb.rest, kb.hit, origin, occupancy_mask=mask),
                     DIRECT_REPS, warm=0)
        bytes_s, ops_s = nbytes / HBM_BYTES_PER_S, 52 * terms / F32_OPS_PER_S
        out["K5"][what] = dict(route=route, ms=ms, max_abs_err=e,
                         max_rel_err=float(((km.double() - ref).abs() / scale.clamp(min=1e-30)).max()),
                         most_sources_in_a_box=m, bound_ms=1e3 * max(bytes_s, ops_s),
                         bound_by="bytes" if bytes_s >= ops_s else "operations")
        log(f"phase 1 direct epilogue at eigen ({r_max + 1}, 1), {what}: route {route}, {ms:.1f} ms a launch "
            f"(mean of {DIRECT_REPS}), bound {out['K5'][what]['bound_ms']:.4f} ms, max abs err {e:.4g} "
            f"against the plain version, at most {m} sources a box")
        if mask:
            ko = torch.zeros((2, 10, X, X, Z), dtype=torch.float32, device=dev)
            kernels.ingest_epilogue(c, kb.n, kb.rest, kb.hit, origin, ko, slot)
            exact("K3 direct: the untouched slot", ko[0], torch.zeros_like(ko[0]))
            exact("K3 direct into its slot vs K5 masked", ko[1], km)
            out["K3"][what] = dict(route=route, max_abs_err=box_close(
                f"K3 direct at eigen ({r_max + 1}, 1)", ko[1], plain, ref, bound),
                max_rel_err=float(((ko[1].double() - ref).abs() / scale.clamp(min=1e-30)).max()))
        del km, plain, ref, scale
    out["launches"] = {k.name: k.launches for k in (kernels.EPI, kernels.XBOX)}
    for name, n in out["launches"].items():
        check(n > 0, f"the direct epilogue at eigen ({r_max + 1}, 1): {name} was launched no time")
    return out


def full_column(world, contrib, x=1, y=2):
    """Occupies every z of the column (x, y) in both grids, with more hits
    than the threshold, so that the merge's band sums take its voxels."""
    import torch

    Z = contrib.hit.shape[2]
    contrib.hit[x, y, :] = torch.arange(Z, dtype=torch.int32, device=contrib.hit.device) % 7 + 11
    world.grid.hit[x, y, :] = 3


def phase1_merge_tall(cfg, dev, log):
    """The merge kernel past 256 z (its one-pass form, merge_any_kernel)
    against its twin on seeded worlds (origin moved, z shift), each with a
    column whose every z is occupied (full_column), and its quarter slab
    against the full result's rows, every launch counted: at MERGE_TALL's
    shapes, 256×256×320 (8-byte accesses, the band inputs in shared
    memory), 64×64×257 (4-byte accesses, a part chunk) and 64×64×800 (past
    the 768 z whose band inputs a block's shared memory holds: the band sums
    read back the merged column). Timed at 256×256×320."""
    from gvom_tpu_torch.ops import kernels
    from gvom_tpu_torch.parallel.sharding import merge_and_columns_plain

    counts, timing = {}, None
    for X, Z in MERGE_TALL:
        c = dataclasses.replace(cfg, xy_size=X, z_size=Z)
        Ys = X // 4
        for i, (case, d_origin) in enumerate((("moved", (3, -2, 1)), ("z shift", (0, 1, -7)))):
            what = f"merge at {X}×{X}×{Z}, {case}"
            world, contrib, ego = seeded_merge_inputs(c, dev, 200 + i, d_origin, True)
            full_column(world, contrib)
            before = kernels.MERGE.launches
            full = merge_vs_plain(what, c, world, contrib, ego)
            merge_slab_vs_full(what, c, world, contrib, ego, full, Ys, Ys)
            check(kernels.MERGE.launches == before + 2, f"{what}: the merge launched "
                                                        f"{kernels.MERGE.launches - before} times, not 2")
            band = int(full[3][0, 1, 2])
            check(band > 0, f"{what}: the full column's band hit sum is {band}")
            counts[f"{X}×{X}×{Z} {case}"] = [int((full[0].hit > 0).sum()), int((full[3][0] > 0).sum()), band]
            if timing is None:
                # as in phase 5: each timed call merges over the previous call's output
                nbytes, _ = merge_bound(c, world, contrib)
                timed = copy_grid(contrib)
                timing = form_timing(f"merge_batch at {X}×{X}×{Z}", lambda: kernels.merge_batch(c, world, timed, ego),
                                     nbytes, MERGE_OPS * c.voxel_count / F32_OPS_PER_S, log,
                                     plain=lambda: merge_and_columns_plain(c, world, contrib, ego))
                del timed
            del world, contrib, full
    log(f"phase 1 merge past 256 z: bitwise its plain version on seeded worlds and their quarter slab, a full "
        f"column in each, two launches a case ([occupied voxels, columns with a band hit sum, the full column's]: "
        f"{counts})")
    return {"merge_batch at Z = 320": timing}


def wide_combine(c, g, ego, what, log):
    """K4 on the state of the Gvom facade g: every output bitwise against
    fuse_plain (combine_vs_plain), then its launch alone timed beside its
    bound and fuse_plain (form_timing)."""
    import torch

    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import kernels

    buf, world = g._buffer, g._world
    ego = torch.tensor(ego, dtype=torch.float32, device=world.grid.hit.device)
    combine_vs_plain(c, buf, world, ego, f"K4 at {what}")
    target = buf.grids.origin.index_select(0, buf.last_slot.reshape(1).long())[0]
    launch, outs = kernels.combine_launch(c, buf, world, target, ego)
    launch()
    nbytes, _ = combine_bound(c, buf, world, target, outs[0])
    return form_timing(f"combine at {what}", launch, nbytes, 40 * c.voxel_count / F32_OPS_PER_S, log,
                       plain=lambda: pipeline.fuse_plain(c, buf, world, target, ego))


def phase1_wide_configs(cfg, scans, dev, log):
    """Every configuration that the JAX package takes runs on the card: for
    each of WIDE_CONFIGS, the Gvom facade on WIDE_SCANS upstream scans
    (process_pointcloud, then combine_maps) against the same facade with
    every wrapper on its plain version on the card, bitwise (facade_pair;
    where the epilogue's direct kernel takes the box the buffer's nine
    moment sums are held against float64 by phase1_epilogue_radii), with
    K1-K4 launched once a scan; at buffer_size 17 and z_size 320, K4
    bitwise fuse_plain and timed (wide_combine) there and again once the
    facade has taken B + 1 scans (the scans in turn), its ring buffer full
    and its cursor wrapped; then the batched step at Z = 320, two steps of
    BATCH_CHECK scans, against the same step on the plain versions."""
    import torch

    from gvom_tpu_torch import Gvom, make_batched_step
    from gvom_tpu_torch.ops import kernels
    from gvom_tpu_torch.types import empty_world_state

    drives, timings = {}, {}
    for fields in WIDE_CONFIGS:
        c = dataclasses.replace(cfg, **fields)
        what = ", ".join(f"{k}={v}" for k, v in fields.items())
        full = scans[:WIDE_SCANS]
        a, b = Gvom(config=c), Gvom(config=c)
        kernels.reset_launches()
        facade_pair(f"Gvom({what})", c, a, b, full, [None] * len(full), b_plain=True,
                    box_sums=kernels.epilogue_route(c, None, True) != "direct")
        for k in (kernels.RAY, kernels.BIN, kernels.EPI, kernels.CMB):
            check(k.launches == len(full), f"Gvom({what}): {k.name} launched {k.launches} times, not {len(full)}")
        drives[what] = int(a.products.visibility.sum())
        check(drives[what] > 0, f"Gvom({what}): no visible cell")
        if "buffer_size" in fields or "z_size" in fields:
            timings[f"combine, {what}"] = wide_combine(c, a, full[-1][2], what, log)
            ring = [scans[i % len(scans)] for i in range(len(full), c.buffer_size + 1)]
            for pad, m, e in ring:
                a.process_pointcloud(pad[m], e)
                a.combine_maps()
            timings[f"combine, {what}, full ring"] = wide_combine(
                c, a, ring[-1][2], f"{what}, full ring ({c.buffer_size + 1} scans)", log)
        del a, b
        torch.cuda.empty_cache()
    c = dataclasses.replace(cfg, z_size=320)
    scans_dev = scans_on_device(scans, dev)
    cb = batched_cfg(c, make_batch(scans_dev, BATCH_CHECK, 0))
    step = make_batched_step(cb)
    wk = wp = empty_world_state(c, dev)
    kernels.reset_launches()
    for i in range(2):
        b = make_batch(scans_dev, BATCH_CHECK, i)
        wk, pk = step(wk, *b)
        with plain_kernels():
            wp, pp = step(wp, *b)
        same_world(f"batched step {i} at Z = 320", wk, wp, MOM_ATOL_BATCH)
        for name in PRODUCT_FIELDS:
            exact(f"batched step {i} at Z = 320 product {name}", getattr(pk, name), getattr(pp, name))
    check(kernels.MERGE.launches == 2, f"batched step at Z = 320: the merge launched {kernels.MERGE.launches} times")
    log(f"phase 1 wide configurations: the Gvom facade at {list(drives)} returns maps bitwise the same facade's on "
        f"its plain versions over {WIDE_SCANS} upstream scans (visible cells {list(drives.values())}); the batched "
        f"step at Z = 320 agrees with its plain versions over two steps of {BATCH_CHECK} scans (world occupied "
        f"{int((wk.grid.hit > 0).sum())})")
    del wk, wp, pk, pp
    torch.cuda.empty_cache()
    return timings


def phase1_large(dev, log, err):
    """The JAX record's larger grid, 512×512×64 at B = 4: the kernels
    against their plain versions over WIDE_SCANS scans (phase1_kernels_vs_plain's
    drive: the preparation, K1-K5, the plane fit and the guess height with
    the maps' tail), then the Gvom facade against the same facade on its plain
    versions, bitwise; prints the peak device memory of the facade drive."""
    import torch

    from gvom_tpu_torch import Gvom, GvomConfig

    cfg = GvomConfig(xy_size=LARGE_GRID)
    scans = make_scans(cfg, WIDE_SCANS, LIDAR)
    e = phase1_kernels_vs_plain(cfg, scans, dev, log, extras=False)[0]
    for k, v in e.items():
        err[k] = max(err[k], v)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    a = Gvom(config=cfg)
    for pad, mask, ego in scans:
        a.process_pointcloud(pad[mask], ego)
        a.combine_maps()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    facade_pair(f"Gvom at {LARGE_GRID}×{LARGE_GRID}×64", cfg, Gvom(config=cfg), Gvom(config=cfg), scans,
                [None] * len(scans), b_plain=True)
    log(f"phase 1 large grid: at {LARGE_GRID}×{LARGE_GRID}×{cfg.z_size}, B = {cfg.buffer_size}, the kernels agree "
        f"with their plain versions over {len(scans)} scans and the facade returns maps bitwise the same facade's "
        f"on its plain versions; peak device memory of one facade's drive {peak / 2**30:.3f} GiB")
    del a
    torch.cuda.empty_cache()
    return dict(grid=LARGE_GRID, peak_bytes=peak)


def random_terrain(rng):
    """A random mix of bumps, a wall segment and a trench, drawn from rng in
    the order of the JAX package's fuzz suite (tests/test_fuzz_parity.py)."""
    import numpy as np

    from gvom_tpu_torch.io import synthetic

    amp, wl, xw, wh = rng.uniform(0.1, 0.5), rng.uniform(3.0, 8.0), rng.uniform(5.0, 9.0), rng.uniform(1.0, 3.0)
    xc, wd, tw = rng.uniform(-9.0, -5.0), rng.uniform(1.0, 3.0), rng.uniform(1.5, 4.0)
    gx, gy = rng.uniform(-0.15, 0.15), rng.uniform(-0.15, 0.15)

    def h(x, y):
        base = gx * x + gy * y + amp * np.sin(2 * np.pi * x / wl) * np.cos(2 * np.pi * y / wl)
        wall = np.where((x > xw) & (x < xw + 0.8) & (np.abs(y) < 6.0), wh, 0.0)
        trench = np.where(np.abs(x - xc) < tw / 2, -wd, 0.0)
        return base + wall + trench

    return synthetic.Terrain(h, "fuzz")


def sweep_drive(cfg, seed):
    """[(padded points, mask, ego)] of a sweep configuration's facade drive
    (tests/torch_helpers.py, sweep_drive): SWEEP_SCANS scans of a random
    terrain with a moving ego."""
    import numpy as np

    from gvom_tpu_torch.io import synthetic

    rng = np.random.default_rng(seed)
    terrain = random_terrain(rng)
    ego = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), 1.4 + rng.uniform(0, 0.4)])
    out = []
    for step in range(SWEEP_SCANS):
        ego = ego + np.array([rng.uniform(0.1, 1.2), rng.uniform(-0.6, 0.6), rng.uniform(-0.05, 0.05)])
        pts = synthetic.simulate_lidar_scan(terrain, ego, channels=24, azimuth_steps=96,
                                            max_range=0.5 * cfg.xy_size * cfg.xy_resolution, seed=seed * 10 + step)
        pts = synthetic.nudge_off_grid(pts, cfg.xy_resolution, cfg.z_resolution)
        out.append(synthetic.pad_scan(pts, cfg.max_points) + (ego.copy(),))
    return out


def sweep_batches(cfg, seed, dev):
    """[(scans [S,N,3], valid [S,N], egos [S,3] f32)] on dev of a sweep
    configuration's batched drive (tests/torch_helpers.py, sweep_batches):
    SWEEP_STEPS steps of SWEEP_BATCH scans, the second step's origin moved."""
    import numpy as np
    import torch

    from gvom_tpu_torch.io import synthetic

    rng = np.random.default_rng(seed + 1000)
    terrain = random_terrain(rng)
    ego = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), 1.5])
    batches = []
    for b in range(SWEEP_STEPS):
        scans, masks, egos = [], [], []
        for i in range(SWEEP_BATCH):
            ego = ego + np.array([rng.uniform(0.3, 0.9), rng.uniform(-0.4, 0.4), 0.0])
            pts = synthetic.simulate_lidar_scan(terrain, ego, channels=8, azimuth_steps=32,
                                                max_range=0.4 * cfg.xy_size * cfg.xy_resolution,
                                                seed=seed * 100 + b * 10 + i)
            pad, mask = synthetic.pad_scan(synthetic.nudge_off_grid(pts, cfg.xy_resolution, cfg.z_resolution),
                                           cfg.max_points)
            scans.append(pad)
            masks.append(mask)
            egos.append(ego.astype(np.float32))
        batches.append(tuple(torch.from_numpy(np.stack(a)).to(dev) for a in (scans, masks, egos)))
    return batches


def launched(names, n, what):
    """Fail unless each kernel in names was launched n times since the last
    kernels.reset_launches(). Returns the launches of every kernel that ran."""
    from gvom_tpu_torch.ops import kernels

    got = {k.name: k.launches for k in kernels.KERNELS if k.launches}
    for name in names:
        check(got.get(name, 0) == n, f"{what}: {name} launched {got.get(name, 0)} times, not {n}")
    return got


def phase1_config_sweep(cfg, scans, dev, log, err):
    """Every configuration field that the kernels take as a constant, off its
    default (SWEEP_CONFIGS): for each of F1-F5, the Gvom facade over its
    drive against the same facade with every wrapper on its plain version
    on the card (facade_pair: the 5-tuple, the slopes, the occupancy and the
    ring buffer bitwise, its moments within MOM_RTOL / MOM_ATOL); the
    batched step, two steps, against the same step under plain_kernels()
    (the world bitwise but its moments, within MOM_ATOL_BATCH, and every
    product bitwise); ingest_scan(y_window=) on the quarter slab that holds
    the window seam against its plain version. The launch counts, set to 0
    before each and read after, show that each kernel of the path ran: the
    facade's FACADE_KERNELS once a scan, the step's BATCHED_KERNELS once a
    step, the three slab entries once. Meanwhile the installed-wheel check
    (installed_wheel_start) runs beside it. Returns each configuration's
    launches and largest differences, and the wheel check's report."""
    import torch

    from gvom_tpu_torch import Gvom, GvomConfig, make_batched_step
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import kernels
    from gvom_tpu_torch.ops import grid as gridops
    from gvom_tpu_torch.types import empty_world_state

    wheel = installed_wheel_start()
    report = {}
    try:
        for name, (seed, fields) in SWEEP_CONFIGS.items():
            t0 = time.perf_counter()
            if seed is None:        # F5: the upstream grid and scans
                c = GvomConfig(**fields)
                drive = scans[:WIDE_SCANS]
                scans_dev = scans_on_device(scans, dev)
                batches = [make_batch(scans_dev, BATCH_CHECK, i) for i in range(SWEEP_STEPS)]
                cb = batched_cfg(c, batches[0])
            else:
                c = GvomConfig(max_points=SWEEP_MAX_POINTS, **fields)
                drive = sweep_drive(c, seed)
                cb = dataclasses.replace(c, max_points=SWEEP_BATCH_MAX_POINTS)
                batches = sweep_batches(cb, seed, dev)
            r = dict(facade_scans=len(drive), batched_steps=len(batches), batch=int(batches[0][0].shape[0]))

            kernels.reset_launches()
            r["facade_buffer_mom"] = facade_pair(f"{name} Gvom", c, Gvom(config=c), Gvom(config=c), drive,
                                                 [None] * len(drive), b_plain=True)
            r["facade_launches"] = launched(FACADE_KERNELS, len(drive), f"{name} Gvom")
            err["ingest_epilogue"] = max(err["ingest_epilogue"], r["facade_buffer_mom"])

            step = make_batched_step(cb)
            wk = wp = empty_world_state(cb, dev)
            e = 0.0
            kernels.reset_launches()
            for i, b in enumerate(batches):
                wk, pk = step(wk, *b)
                with plain_kernels():
                    wp, pp = step(wp, *b)
                e = max(e, same_world(f"{name} batched step {i}", wk, wp, MOM_ATOL_BATCH))
                for field in PRODUCT_FIELDS:
                    exact(f"{name} batched step {i} product {field}", getattr(pk, field), getattr(pp, field))
            r["batched_launches"] = launched(BATCHED_KERNELS, len(batches), f"{name} batched step")
            check(bool(wk.valid) and int((wk.grid.hit > 0).sum()) > 0, f"{name} batched step: no live world")
            r["batched_world_mom"] = e
            err["moments_epilogue"] = max(err["moments_epilogue"], e)
            del wk, wp, pk, pp

            pad, mask, ego_np = drive[-1]
            pts, valid, ego = scan_tensors((pad, mask, ego_np), dev)
            Y = c.xy_size
            Ys = Y // 4
            yw = (int(gridops.compute_origin(c, ego.cpu())[1]) % Y // Ys * Ys, Ys)
            kernels.reset_launches()
            gk, okk = pipeline.ingest_scan(c, pts, valid, ego, y_window=yw)
            what = f"{name} ingest_scan(y_window={yw})"
            r["slab_launches"] = launched(SLAB_KERNELS + ("prepare_points",), 1, what)
            with all_plain():
                gp, okp = pipeline.ingest_scan(c, pts, valid, ego, y_window=yw)
            check(bool(okk) == bool(okp) and bool(okk), f"{what}: scan_ok {okk} and {okp}")
            for field in ("hit", "miss", "min_height", "origin"):
                exact(f"{what} {field}", getattr(gk, field), getattr(gp, field))
            r["slab_mom"] = moments_close(what, gk.mom, gp.mom)
            err["moments_epilogue_slab"] = max(err["moments_epilogue_slab"], r["slab_mom"])
            r["seconds"] = time.perf_counter() - t0
            report[name] = r
            del gk, gp, step, batches
            torch.cuda.empty_cache()
            ran = sorted(set(r["facade_launches"]) | set(r["batched_launches"]) | set(r["slab_launches"]))
            fields_s = ", ".join(f"{k}={v}" for k, v in fields.items())
            log(f"phase 1 sweep {name} ({fields_s}): kernels launched {ran}; the facade over {len(drive)} scans, "
                f"the batched step over {r['batched_steps']} steps of {r['batch']} scans and the slab {yw} equal "
                f"their plain versions: the maps, products, hit, miss, min_height, evidence and n with no "
                f"difference, the moments' largest differences {r['facade_buffer_mom']} (facade buffer), "
                f"{r['batched_world_mom']} (batched world), {r['slab_mom']} (slab); {r['seconds']:.1f} s")
    except BaseException:
        installed_wheel_stop(wheel)
        raise
    log(f"phase 1 sweep: no kernel differs from its plain version on {list(SWEEP_CONFIGS)} beyond the moments' "
        f"stated tolerances (no fault found); each listed kernel launched in each configuration; "
        f"{sum(r['seconds'] for r in report.values()):.1f} s")
    report["installed_wheel"] = installed_wheel_finish(wheel, log)
    return report


# run in a copy of the port unpacked from its wheel, with only that copy on
# the path: build the preparation and K1 from the copy's sources into its
# _build, launch each once on a small drive's scan and hold it against its
# plain version; prints one JSON object
INSTALLED_PROBE = r"""
import json, sys
import numpy as np
import torch
import gvom_tpu_torch
from gvom_tpu_torch import GvomConfig
from gvom_tpu_torch.io import synthetic
from gvom_tpu_torch.ops import binning, kernels, raycast

cfg = GvomConfig(xy_size=64, z_size=32, max_points=4096)
ego_np = np.array([0.3, -0.2, 1.5])
pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego_np, channels=32, azimuth_steps=128, seed=0)
pad, mask = synthetic.pad_scan(pts, cfg.max_points)
dev = torch.device("cuda")
pts, valid = torch.from_numpy(pad)[None].to(dev), torch.from_numpy(mask)[None].to(dev)
egos = torch.tensor(ego_np, dtype=torch.float32, device=dev)[None]
procs = [(k, k.start_build()) for k in (kernels.PREP, kernels.RAY)]
for k, proc in procs:
    k.finish_build(proc)
kernels.reset_launches()
got = kernels.prepare_points(cfg, pts, valid, egos, frame_ego=egos[0])
ref = binning.prepare_plain(cfg, pts, valid, egos, frame_ego=egos[0])
p, keep, origin, ok = got
k1 = kernels.ray_pass_counts(cfg, p, keep, egos, origin)
k1_plain = raycast.pass_counts_plain(cfg, p, keep, egos, origin)
torch.cuda.synchronize()
nan = torch.isnan(ref[0])
print(json.dumps(dict(
    package=gvom_tpu_torch.__file__, build_dir=str(kernels.BUILD_DIR),
    sources=[str(k.source) for k in kernels.KERNELS],
    libraries=[str(k.library()) for k in (kernels.PREP, kernels.RAY)],
    built=[k.library().exists() for k in (kernels.PREP, kernels.RAY)],
    launches={k.name: k.launches for k in (kernels.PREP, kernels.RAY)},
    prepare_equal=bool(torch.equal(nan, torch.isnan(got[0])) and torch.equal(got[0][~nan], ref[0][~nan])
                       and all(torch.equal(a, b) for a, b in zip(got[1:], ref[1:]))),
    k1_equal=bool(torch.equal(k1, k1_plain)), points_kept=int(keep.sum()), passes=int(k1.sum()),
    jax="jax" in sys.modules)))
"""


def installed_wheel_start():
    """Build the wheel that pyproject.toml defines, offline, from a copy of
    the package sources in a temporary directory, unpack it, and start
    INSTALLED_PROBE and the installed CLI's --help there, with only the
    unpacked copy on PYTHONPATH. Returns what installed_wheel_finish reads."""
    tmp = Path(tempfile.mkdtemp(prefix="gvom_wheel_"))
    try:
        return _installed_wheel_start(tmp)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise


def _installed_wheel_start(tmp):
    src, out, site = tmp / "src", tmp / "wheel", tmp / "site"
    src.mkdir()
    shutil.copy(ROOT / "pyproject.toml", src)
    for pkg in ("gvom_tpu", "gvom_tpu_torch"):
        shutil.copytree(ROOT / pkg, src / pkg, ignore=shutil.ignore_patterns("__pycache__", "_build", "*.pyc"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation", "--no-index",
                           "--no-cache-dir", "-w", str(out), str(src)], capture_output=True, text=True, timeout=120,
                          cwd=src)
    check(proc.returncode == 0, f"installed wheel: pip wheel failed:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    (whl,) = out.glob("gvom_tpu-*.whl")
    with zipfile.ZipFile(whl) as z:
        names = set(z.namelist())
        entry_points = "".join(z.read(n).decode() for n in names if n.endswith(".dist-info/entry_points.txt"))
        z.extractall(site)
    csrc = sorted(p.name for p in (ROOT / "gvom_tpu_torch" / "csrc").iterdir() if p.is_file())
    missing = [n for n in csrc if f"gvom_tpu_torch/csrc/{n}" not in names]
    check(not missing, f"installed wheel: the wheel lacks the sources {missing}")
    check("gvom-tpu-torch = gvom_tpu_torch.cli:main" in entry_points,
          f"installed wheel: no gvom-tpu-torch script in {entry_points!r}")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(site)
    procs = {name: subprocess.Popen([sys.executable, *args], cwd=site, env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, args in (("probe", ["-c", INSTALLED_PROBE]), ("cli", ["-m", "gvom_tpu_torch.cli", "--help"]))}
    return dict(tmp=tmp, site=site, procs=procs, wheel_s=time.perf_counter() - t0, files=len(names),
                sources=len(csrc))


def installed_wheel_stop(w):
    """Kill what installed_wheel_start started, if it still runs, and delete
    its directory."""
    for proc in w["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(w["tmp"], ignore_errors=True)


def installed_wheel_finish(w, log):
    """Wait for the installed-wheel check and hold its report: the port and
    its kernel sources resolve inside the unpacked copy, importing it loaded
    no JAX, the preparation and K1 were built into the copy's _build,
    launched once each and equal their plain versions, the CLI ran."""
    try:
        outs = {}
        for name, proc in w["procs"].items():
            try:
                out, errs = proc.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                proc.kill()
                out, errs = proc.communicate()
            check(proc.returncode == 0, f"installed wheel: {name} exited {proc.returncode}:\n{errs[-3000:]}")
            outs[name] = out
        check("selftest" in outs["cli"], "installed wheel: the CLI's --help lists no selftest")
        got = json.loads(outs["probe"].strip().splitlines()[-1])
        pkg = w["site"] / "gvom_tpu_torch"
        check(Path(got["package"]).parent == pkg, f"installed wheel: the port imported from {got['package']}")
        check(Path(got["build_dir"]) == pkg / "_build", f"installed wheel: build directory {got['build_dir']}")
        check(all(Path(s).parent == pkg / "csrc" for s in got["sources"]),
              f"installed wheel: kernel sources outside the copy: {got['sources']}")
        check(all(Path(s).parent == pkg / "_build" for s in got["libraries"]) and all(got["built"]),
              f"installed wheel: libraries {got['libraries']} built {got['built']}")
        check(got["launches"] == {"prepare_points": 1, "ray_pass_counts": 1},
              f"installed wheel: launches {got['launches']}")
        check(got["prepare_equal"] and got["k1_equal"], "installed wheel: a kernel differs from its plain version")
        check(not got["jax"], "installed wheel: importing the port loaded jax")
        check(got["passes"] > 0, "installed wheel: K1 counted no pass")
    finally:
        installed_wheel_stop(w)
    log(f"phase 1 installed wheel: the wheel ({w['files']} files, every one of the {w['sources']} csrc sources, "
        f"the gvom-tpu-torch script; built in {w['wheel_s']:.1f} s) unpacked alone on the path: the CLI runs, "
        f"no jax imported, the preparation and K1 built from its sources into its _build and launched once each "
        f"({got['points_kept']} points kept, {got['passes']} passes), both bitwise their plain versions")
    return dict(got, wheel_s=w["wheel_s"], files=w["files"])


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
        with watch_fma32() as per_point:
            t0 = time.perf_counter()
            scan_ok = g.process_pointcloud(pts, ego)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = g.combine_maps()
            t2 = time.perf_counter()
        check(not per_point, f"facade scan {i}: float64 fma32 or sqrt32 on the card: {per_point[:3]}")
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
    for name in FACADE_KERNELS:
        check(launches[name] == len(scans), f"kernel {name} was launched {launches[name]} times on the facade's path, "
              f"not once per scan")
    # every launch of one warm combine_maps on the card, the kernels' and PyTorch's
    kernels.reset_launches()
    combine_profile = profile_calls(dict(combine_maps=g.combine_maps), log)["combine_maps"]
    profiled = {k.name: k.launches for k in kernels.KERNELS}
    for name in ("combine",) + tuple(TAIL_HOSTS):
        check(profiled[name] == 3, f"kernel {name}: {profiled[name]} launches in the profile's three combine_maps")
    # and of one warm process_pointcloud (the scan given again)
    pad, mask, ego = scans[-1]
    ingest_profile = profile_calls(dict(process_pointcloud=lambda: g.process_pointcloud(pad[mask], ego)),
                                   log)["process_pointcloud"]
    for name, prof in (("combine_maps", combine_profile), ("process_pointcloud", ingest_profile)):
        check(prof["f64_launches"] == 0, f"{name}: {prof['f64_launches']} float64 launches on the card")
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
        negative_cells=int((neg > 0).sum()), combine_maps_profile=combine_profile,
        process_pointcloud_profile=ingest_profile,
    )
    log(f"phase 2 facade: {len(scans)} scans, launches {launches}; per scan (warm median, host clock "
        f"with sync): process_pointcloud {res['ingest_wall_ms_median_warm']:.3f} ms, combine_maps "
        f"{res['combine_wall_ms_median_warm']:.3f} ms; one combine_maps launches {combine_profile['launches']} "
        f"kernels in all, the device busy {combine_profile['device_us']:.1f} us of "
        f"{combine_profile['wall_us']:.1f} us; "
        f"float64 {combine_profile['f64_us']:.1f} us in {combine_profile['f64_launches']} launches; "
        f"one process_pointcloud launches {ingest_profile['launches']}, the device busy "
        f"{ingest_profile['device_us']:.1f} us of {ingest_profile['wall_us']:.1f} us, float64 "
        f"{ingest_profile['f64_us']:.1f} us in {ingest_profile['f64_launches']} launches")
    return launches, res, g


@contextlib.contextmanager
def all_plain():
    """Inside, every kernel wrapper takes its plain version, on the card too
    (the wrappers ask kernels._is_cpu which one to take)."""
    from gvom_tpu_torch.ops import kernels

    is_cpu = kernels._is_cpu
    kernels._is_cpu = lambda t: True
    try:
        yield
    finally:
        kernels._is_cpu = is_cpu


def facade_pair(what, cfg, a, b, scans, transforms, degenerate=(), b_plain=False, box_sums=True):
    """Drive two facades with the same scans (a scan in its sensor frame
    with its transform where transforms[i] is not None) and hold everything
    they give bitwise, the ring buffer too (its moments within MOM_RTOL /
    MOM_ATOL): scan_ok (False exactly for the scans in `degenerate`), the
    combine's 5-tuple, the slopes, the occupancy. b_plain runs facade b with
    every wrapper on its plain version. Without box_sums the buffer's nine
    moment sums are not compared (its n is): where the epilogue's direct
    kernel takes the box they are held against float64 within the f32
    summation bound by box_close instead (phase1_epilogue_radii). Returns
    the largest difference of the buffer's moments."""
    import numpy as np

    from gvom_tpu_torch.utils import convert

    side_b = all_plain if b_plain else contextlib.nullcontext
    for i, ((pad, mask, ego), tf) in enumerate(zip(scans, transforms)):
        pts = pad[mask] if tf is None else to_sensor_frame(pad[mask], tf)
        ok_a = bool(a.process_pointcloud(pts, ego, tf))
        with side_b():
            ok_b = bool(b.process_pointcloud(pts, ego, tf))
        check(ok_a == ok_b == (i not in degenerate), f"{what} scan {i}: scan_ok {ok_a} and {ok_b}")
        out_a = a.combine_maps()
        with side_b():
            out_b = b.combine_maps()
        for name, x, y in zip(("origin", "positive", "negative", "roughness", "visibility"), out_a, out_b):
            check(np.array_equal(x, y) and x.dtype == y.dtype, f"{what} scan {i}: {name} differs")
        for name in ("slope_x", "slope_y"):
            check(np.array_equal(getattr(a.products, name).cpu().numpy(), getattr(b.products, name).cpu().numpy()),
                  f"{what} scan {i}: {name} differs")
    check(np.array_equal(a.get_map_as_occupancy_grid(), b.get_map_as_occupancy_grid()), f"{what}: occupancy")
    ba, bb = convert.to_numpy(a._buffer), convert.to_numpy(b._buffer)
    for k in ba:
        if k == "mom":
            check(bool(np.array_equal(ba[k][:, 0], bb[k][:, 0])), f"{what} buffer: moment n differs")
            check(not box_sums or bool(np.allclose(ba[k], bb[k], rtol=MOM_RTOL, atol=MOM_ATOL)),
                  f"{what} buffer: moments")
        else:
            check(bool(np.array_equal(ba[k], bb[k])), f"{what} buffer: {k} differs")
    return float(np.abs(ba["mom"] - bb["mom"]).max())


def phase3_small_reference(cfg_full, scans_full, log):
    """The facade on a small grid on the GPU against the same facade on the
    CPU, where every wrapper runs its plain version. The third scan's points
    all lie inside min_distance of the world origin, so it is degenerate
    and goes to the write-off slot, which the GPU picks on the device. Then
    the robot's path, each scan in its sensor frame with a general
    quaternion transform: the same drive on the small grid against the CPU,
    and three upstream scans against the same facade on the card with
    every wrapper on its plain version (the CPU would take minutes there)."""
    import numpy as np

    from gvom_tpu_torch import Gvom, GvomConfig
    from gvom_tpu_torch.ops import kernels

    cfg = GvomConfig(xy_size=64, z_size=32, max_points=4096, buffer_size=3)
    scans = make_scans(cfg, 5, dict(channels=32, azimuth_steps=128))
    near = np.random.default_rng(0).uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
    scans[2] = (near, np.ones(len(near), bool), scans[2][2])
    gpu, cpu = Gvom(config=cfg), Gvom(config=cfg, device="cpu")
    check(kernels.CMB.library((f"-DGVOM_COMBINE_B={cfg.buffer_size}",)).exists(),
          f"Gvom(buffer_size={cfg.buffer_size}) did not build its combine library when it was made")
    facade_pair("small grid", cfg, gpu, cpu, scans, [None] * len(scans), degenerate=(2,))
    tfs = [quaternion_transform(10 + i, ego) for i, (_, _, ego) in enumerate(scans)]
    facade_pair("small grid, transform", cfg, Gvom(config=cfg), Gvom(config=cfg, device="cpu"), scans, tfs,
                degenerate=(2,))
    full = scans_full[:3]
    kernels.reset_launches()
    facade_pair("upstream, transform", cfg_full, Gvom(config=cfg_full), Gvom(config=cfg_full), full,
                [quaternion_transform(20 + i, ego) for i, (_, _, ego) in enumerate(full)], b_plain=True)
    check(kernels.PREP.launches == len(full), f"upstream, transform: prepare launched {kernels.PREP.launches} times")
    log("phase 3: the GPU facade matches the CPU facade on a 64×64×32 grid over 5 scans, one of them "
        "degenerate (write-off slot), ring buffer included; roughness and the slopes bitwise; again with each "
        "scan in its sensor frame and a general quaternion transform; and with the transform on "
        f"{len(full)} upstream scans against the same facade on the card on its plain versions")


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


def form_timing(what, fn, bytes_moved, ops_s, log, lib=None, plain=None):
    """A kernel form off the upstream path (a deeper ring buffer, a taller
    grid, a larger eigen box): its launch alone (graph_ms) beside its
    bound, its plain version's time (cuda_ms) and lib's time, a PyTorch call
    of the same function, where there is one (cuda_ms, as kernel_row times
    it), for the --out report."""
    ms, _ = graph_ms(fn, 20)
    bytes_s = bytes_moved / HBM_BYTES_PER_S
    r = dict(ms=ms, bound_ms=1e3 * max(bytes_s, ops_s), bound_by="bytes" if bytes_s >= ops_s else "operations",
             library_ms=None if lib is None else cuda_ms(lib, 5), plain_ms=None if plain is None else cuda_ms(plain, 2))
    lib_ms = "n/a" if lib is None else f"{r['library_ms']:.4f} ms"
    plain_ms = "n/a" if plain is None else f"{r['plain_ms']:.4f} ms"
    log(f"timing {what}: launch alone {ms:.4f} ms, bound {r['bound_ms']:.4f} ms ({r['bound_by']}), plain {plain_ms}, "
        f"library {lib_ms}")
    return r


def binned(cfg, pn, keep, origin, scratch):
    """(n, rest, hit) of K2 on a point set on a kept scratch, for an epilogue."""
    from gvom_tpu_torch.ops import kernels

    b = kernels.bin_points(cfg, pn, keep, origin, scratch=scratch)
    return b.n, b.rest, b.hit


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
    """(bytes, seconds of operations) of K2 on this data: it reads the points
    (12 bytes) and keep (1 byte), writes hit and min_height over the n_out
    voxels of the grid, n over the n_scratch voxels of the scratch and the
    nine other channels where n > 0 (n_scratch_nz); about 30 f32 operations
    a kept point. What its kept scratch adds (binning.MomentScratch: the
    touched bytes, the clear of the last call's nine channels) is left out,
    so the bound is the same for any contract of the scratch."""
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


def box_counts(t, r):
    """Sums of the integer tensor t [A, B, C] over every (2r + 1) box that
    lies inside it ("valid": [A − 2r0, B − 2r1, C − 2r2]), separable by
    prefix sums in int64, so exact and linear in t's size at any radius."""
    import torch

    t = t.to(torch.int64)
    for ax, q in enumerate(r):
        c = t.cumsum(ax)
        c = torch.cat([torch.zeros_like(c.narrow(ax, 0, 1)), c], ax)
        n = t.shape[ax] - 2 * q
        t = c.narrow(ax, 2 * q + 1, n) - c.narrow(ax, 0, n)
    return t


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
    pad = lambda t: torch.nn.functional.pad(t, (r[2], r[2], r[1], r[1], r[0], r[0]))
    reach = box_counts(pad(pad(targets_w.to(torch.int32))), r) > 0
    nz = n_w > 0
    n_reach, n_reach_nz = int(reach.sum()), int((reach & nz).sum())
    terms = int(box_counts(nz, r)[targets_w].sum())
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


def prep_bound(n_points, n_scans, transform):
    """(bytes, seconds of operations) of the preparation, whatever
    implements it: it reads the points (12 bytes), valid (1 byte) and the
    egos, writes keep (1 byte) once, the origin and scan_ok, and with a
    transform reads it once and writes the world points (12 bytes). PREP_OPS
    f32 operations a point, PREP_TRANSFORM_OPS more with a transform."""
    nbytes = n_points * 14 + n_scans * 13 + 2 * 12 + (64 + 12 * n_points if transform else 0)
    return nbytes, n_points * (PREP_OPS + (PREP_TRANSFORM_OPS if transform else 0)) / F32_OPS_PER_S


def plane_fit_bound(n_cells):
    """(bytes, seconds of operations) of the plane fit with the window layout
    as its load, whatever implements it: the two torus-layout maps read (8
    bytes a cell) and the origin, the window height and inferred height and
    the fit's three maps written (20 bytes a cell); PLANE_FIT_OPS f32
    operations a cell."""
    return n_cells * 28 + 12, n_cells * PLANE_FIT_OPS / F32_OPS_PER_S


def guess_bound(n_cells):
    """(bytes, seconds of operations) of the guess height with the maps'
    products as its epilogue, whatever implements it: the height, inferred
    height and two slopes read (16 bytes a cell), the band sums and band_ok
    (12) and the origin, the delta and the three int32 maps written (16);
    about GUESS_OPS operations a cell (the search only compares: one
    subtraction; the products a square root, a division and a few
    compares)."""
    return n_cells * 44 + 12, n_cells * GUESS_OPS / F32_OPS_PER_S


def phase4_timings(cfg, buf, world, last, slab, prep, rates, dev, log):
    """ms, plain_ms, library_ms and bound_ms of each kernel at the upstream
    shapes, on the last phase-1 scan and the phase-1 buffer and world, of
    the slab forms on phase 1's slab, and of the preparation on phase 1's
    scan (with and without its transform) and batch."""
    import torch

    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.ops import binning, kernels, maps2d, moments, raycast
    from gvom_tpu_torch.ops import grid as gridops
    from gvom_tpu_torch.types import UNKNOWN_HEIGHT

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    X, Y, Z = cfg.grid_shape
    V = X * Y * Z
    B = cfg.buffer_size
    p, origin, keep, bins, target, ego = (last[k] for k in ("p", "origin", "keep", "bins", "target", "ego"))
    pn = gridops.map_local(cfg, p, origin)     # K2's map-local coordinates, for its library call
    N = p.shape[0]
    P = bins.n.numel()
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
    # other channels where n > 0 (k2_bound), on a scratch kept across its
    # calls, as the facade's ring buffer keeps one; its library call is the
    # index_add_ of the ten sums into a buffer zeroed outside the timing: it
    # leaves out hit, min_height and every fill
    n_grid = int(bins.hit.sum())
    n_win = int(bins.n.sum())
    n_nz = int((bins.n > 0).sum())
    ks, ps = binning.moment_scratch(cfg, dev), binning.moment_scratch(cfg, dev)
    row(kernels.BIN, lambda: kernels.bin_points(cfg, p, keep, origin, scratch=ks),
        lambda: binning.bin_points(cfg, p, keep, origin, scratch=ps), 20, 5,
        lambda: sums_lib.index_add_(1, pflat, vals), *k2_bound(N, n_kept, V, P, n_nz))
    rows[-1]["atomic_floor_ms"] = k2_atomic_floor_ms(n_grid, n_win, rates)
    # the timed launches, each on the scratch the one before it left,
    # computed what the wrapper computes on a fresh one
    _, timed = graph_ms(lambda: kernels.bin_points(cfg, p, keep, origin, scratch=ks), 10)
    exact("K2 timed launch vs the wrapper: hit", timed.hit, bins.hit)
    sums_close("K2 timed launch vs the wrapper", timed.sums, bins.sums)
    check(not timed.rest[:, timed.n[0] == 0].any(), "K2 timed launches: channels 1-9 not zero where n is 0")
    del timed, ps
    # K3: reads hit and writes the slot's ten channels everywhere; reads the
    # sums only inside the ±r box of an occupied voxel (epilogue_bound)
    occ_w = gridops.torus_to_window(bins.hit > 0, origin)
    k3_bytes, terms, n_reach, n_reach_nz = epilogue_bound(cfg, bins.n[0], occ_w, V, True)
    row(kernels.EPI, lambda: kernels.ingest_epilogue(cfg, bins.n, bins.rest, bins.hit, origin, out, slot),
        lambda: moments.ingest_epilogue_plain(cfg, bins.n, bins.rest, bins.hit, origin, out, slot), 20, 5,
        lambda: torch.nn.functional.conv3d(conv_in, wconv), k3_bytes, 52 * terms / F32_OPS_PER_S)
    # K2 then K3, one scan into the slot, against a bound that no design moves
    pair = pair_row("K2 then K3", lambda: kernels.ingest_epilogue(cfg, *binned(cfg, p, keep, origin, ks), origin, out,
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
    for name, a, b in zip(COMBINE_OUTPUTS, k4_out, kernels.combine(cfg, buf, world, target, ego)):
        exact(f"K4 timed launch vs the wrapper: {name}", a, b)
    log(f"timing combine wrapper (meta vector, outputs, launch): {rows[-1]['wrapper_ms']:.4f} ms; K4 reads "
        f"{k4_counts}")
    del k4_out

    # ---- the slab forms, on the slab that holds the window seam ----
    sp, sego, so, skeep, sbins, yw = (slab[k] for k in ("p", "ego", "origin", "keep", "bins", "y_window"))
    spn = gridops.map_local(cfg, sp, so)
    ys0, Ys = yw
    Vs = X * Ys * Z
    Ps = sbins.n.numel()
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
    n_grid_s, n_win_s = int(sbins.hit.sum()), int(sbins.n.sum())
    kss, pss = binning.moment_scratch(cfg, dev, yw), binning.moment_scratch(cfg, dev, yw)
    row(kernels.BIN_SLAB, lambda: kernels.bin_points(cfg, sp, skeep, so, yw, kss),
        lambda: binning.bin_points(cfg, sp, skeep, so, yw, pss), 20, 5,
        lambda: s_lib.index_add_(1, sflat, svals),
        *k2_bound(N, int(skeep.sum()), Vs, Ps, int((sbins.n > 0).sum())))
    del kss, pss
    rows[-1]["atomic_floor_ms"] = k2_atomic_floor_ms(n_grid_s, n_win_s, rates)
    # K5 slab, mask on (as ingest_scan calls it): K3's count on the slab's rows
    in_slab = torch.zeros((Y,), dtype=torch.bool, device=dev)
    in_slab[ys0:ys0 + Ys] = True
    targets = gridops.torus_to_window((slab["full_hit"] > 0) & in_slab[None, :, None], so)
    s_bytes, s_terms, _, _ = epilogue_bound(cfg, slab["full_n"], targets, Vs, True)
    s_conv_in = clean_sums(sbins.sums)[None]
    row(kernels.XBOX_SLAB, lambda: kernels.moments_epilogue(cfg, sbins.n, sbins.rest, sbins.hit, so, yw),
        lambda: moments.moments_epilogue_plain(cfg, sbins.n, sbins.rest, sbins.hit, so, yw), 20, 5,
        lambda: torch.nn.functional.conv3d(s_conv_in, wconv), s_bytes, 52 * s_terms / F32_OPS_PER_S)

    # ---- the 2-D maps, on the last phase-1 combine's column maps ----
    # The plane fit moves the torus-layout maps to the window layout as it
    # loads them (plane_fit_bound); the guess height writes the obstacle maps
    # and the visibility as its epilogue (guess_bound). No one PyTorch call
    # computes either function (torch.log and torch.atan2 round otherwise).
    # The window layout that the fit writes is torch.roll of the two torus
    # maps by minus the origin: held exactly here
    fit_in, guess_in = last["fit_in"], last["guess_in"]
    hm, ihm = last["hm"], last["ihm"]
    n_cells = hm.numel()
    hm_t, ihm_t, target = fit_in
    shifts = tuple(-int(v) for v in target[:2].cpu())
    fitted = kernels.plane_fit(cfg, *fit_in)
    exact("the plane fit's window layout against torch.roll", torch.stack(fitted[:2]),
          torch.roll(torch.stack([hm_t, ihm_t]), shifts, (1, 2)))
    row(kernels.PLANEFIT, lambda: kernels.plane_fit(cfg, *fit_in), lambda: maps2d.plane_fit_window_plain(cfg, *fit_in),
        100, 5, None, *plane_fit_bound(n_cells))
    rows[-1]["includes"] = TAIL_HOSTS["plane_fit"]
    row(kernels.GUESS, lambda: kernels.guess_height(cfg, *guess_in), lambda: maps2d.guess_products_plain(cfg, *guess_in),
        100, 5, None, *guess_bound(n_cells))
    rows[-1]["includes"] = TAIL_HOSTS["guess_height"]

    # the 2-D chain as a combine launches it: the plane fit, then the guess
    def chain():
        f = kernels.plane_fit(cfg, *fit_in)
        return kernels.guess_height(cfg, f[0], f[1], f[3], f[4], *guess_in[4:])

    chain_ms, _ = graph_ms(chain, 100)
    chain_wrapper_ms = cuda_ms(chain, 100, warm=5)
    chain_bound_ms = sum(1e3 * max(b / HBM_BYTES_PER_S, o) for b, o in (plane_fit_bound(n_cells),
                                                                         guess_bound(n_cells)))
    maps_chain = dict(launches=2, ms=chain_ms, wrapper_ms=chain_wrapper_ms, bound_ms=chain_bound_ms)
    log(f"timing the 2-D chain (plane fit, then guess height): launches alone {chain_ms:.4f} ms, wrappers "
        f"{chain_wrapper_ms:.4f} ms, bound {chain_bound_ms:.4f} ms")
    # the tail alone (off the map path), on the sweep's cells: ok read at every
    # cell, the residual and the three coefficients where the fit is ok, three
    # outputs written; a log and two atan2 where it is ok
    fit = last["tail_fit"]
    n_sweep, n_ok = fit[0].numel(), int(fit[1].sum())
    tail = kernel_row(kernels.PLANEFIT_TAIL, lambda: kernels.plane_fit_tail(*fit),
                      lambda: maps2d.plane_fit_tail_plain(*fit), 100, 5, None,
                      n_sweep * (1 + 3 * 4) + n_ok * 4 * 4, n_ok * PLANE_FIT_TAIL_OPS / F32_OPS_PER_S, log)
    # ---- the preparation: one scan as the facade launches it (the row), the
    # same scan with a quaternion transform, and a batch with the dead-scan mask ----
    one, pego = prep["one"], prep["ego"]
    row(kernels.PREP, lambda: kernels.prepare_points(cfg, *one.values(), frame_ego=pego),
        lambda: binning.prepare_plain(cfg, *one.values(), frame_ego=pego), 100, 5, None,
        *prep_bound(N, 1, False))
    sensor, tf = prep["sensor"][None], prep["tf"]
    tf_args = (sensor, one["valid"], one["egos"])
    prep_forms = dict(transform=dict(bound=prep_bound(N, 1, True),
                                     fn=lambda: kernels.prepare_points(cfg, *tf_args, frame_ego=pego, transform=tf),
                                     plain=lambda: binning.prepare_plain(cfg, *tf_args, frame_ego=pego,
                                                                         transform=tf)))
    bpts, bvalid, begos = prep["batch"]
    S, NB = bvalid.shape
    prep_forms["batch"] = dict(
        bound=prep_bound(S * NB, S, False),
        fn=lambda: kernels.prepare_points(cfg, bpts, bvalid, begos, frame_ego=begos[-1], drop_dead=True),
        plain=lambda: binning.prepare_plain(cfg, bpts, bvalid, begos, frame_ego=begos[-1], drop_dead=True))
    prep_report = {}
    for form, f in prep_forms.items():
        ms, _ = graph_ms(f["fn"], 100)
        wms, pms = cuda_ms(f["fn"], 100, warm=5), cuda_ms(f["plain"], 3)
        nbytes, ops_s = f["bound"]
        b_ms = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops_s)
        prep_report[form] = dict(ms=ms, wrapper_ms=wms, plain_ms=pms, bound_ms=b_ms, bytes=nbytes,
                                 bound_by="bytes" if nbytes / HBM_BYTES_PER_S >= ops_s else "operations")
        log(f"timing prepare_points ({form}): launch alone {ms:.4f} ms, wrapper {wms:.4f} ms, plain {pms:.4f} ms, "
            f"bound {b_ms:.4f} ms ({prep_report[form]['bound_by']}, {nbytes / 1e6:.2f} MB), "
            f"{100 * b_ms / ms:.0f} % of it")
    # one launch a call, for one scan and for a batch with the dead-scan mask: no memset, no second kernel.
    # The trace holds PROFILED_CALLS calls, each between two launches of PyTorch's own (the markers): a
    # profile of one short call comes back empty on this card's profiler, the markers' launches too, and
    # a longer one can lose the start of its first call (its first marker, or that and its kernel, or the
    # whole call); nothing but the markers and the kernel launches, and one kernel launch a call
    marker = torch.zeros(1, device=dev)

    def between(fn):
        def calls():
            for _ in range(PROFILED_CALLS):
                marker.add_(1)
                fn()
                marker.add_(1)
        return calls

    forms = dict(prepare_scan=between(lambda: kernels.prepare_points(cfg, *one.values(), frame_ego=pego)),
                 prepare_batch=between(prep_forms["batch"]["fn"]))
    for form, prof in profile_calls(forms, log).items():
        markers = sum(t["count"] for t in prof["top"] if "CUDAFunctorOnSelf_add" in t["kernel"])
        ours = sum(t["count"] for t in prof["top"] if "prepare_kernel" in t["kernel"])
        check(prof["launches"] == markers + ours and abs(markers - 2 * ours) <= 1 and ours >= PROFILED_CALLS - 2,
              f"{form}: {prof['launches']} launches on the card in {PROFILED_CALLS} calls between the markers "
              f"({markers} markers traced, {ours} of the kernel); each call must launch the kernel once and nothing "
              f"else")
        prep_report[form + "_launches"] = dict(calls_traced=ours, launches_a_call=(prof["launches"] - markers) / ours)
    launches0 = kernels.PREP.launches
    prep_forms["batch"]["fn"]()
    check(kernels.PREP.launches == launches0 + 1, "prepare_points: the batch's call counted other than one launch")
    return rows, dict(prepare=prep_report, maps_chain=maps_chain, slab=dict(y_window=list(yw), passes=n_pass_s, points_in_grid=n_grid_s,
                                points_in_scratch=n_win_s, box_terms=s_terms),
                      points_kept=n_kept, points_in_grid=n_grid, points_in_window=n_win, passes=n_pass,
                      scratch_nonempty=n_nz, pair_k2_k3=pair, occupied_voxels=n_occ, box_reach_voxels=n_reach, box_reach_nonempty=n_reach_nz,
                      box_terms=terms, atomic_rates_per_s=rates, conv_vs_plain_max_abs_err=err_conv,
                      map_cells=n_cells, known_cells=int((hm > UNKNOWN_HEIGHT).sum()),
                      guess_cells=int(((hm <= UNKNOWN_HEIGHT) & (ihm != UNKNOWN_HEIGHT)).sum()),
                      guess_routes=last["guess_routes"], plane_fit_tail=dict(tail, cells=n_sweep, ok=n_ok))


def batched_cfg(cfg, batch):
    """cfg with the static DDA budget of a batched step over this batch's
    egos, as batched_replay derives it from a log's: the centered bound plus
    the worst in-batch ego drift."""
    from gvom_tpu_torch.engine.replay import batched_ray_steps

    egos = batch[2].cpu().numpy()
    return dataclasses.replace(cfg, ray_steps_override=batched_ray_steps(cfg, egos, len(egos)))


def scans_on_device(scans, dev):
    """(points [n,N,3], valid [n,N], egos [n,3] f32) of the drive's scans on dev."""
    import numpy as np
    import torch

    return (torch.stack([torch.from_numpy(p) for p, _, _ in scans]).to(dev),
            torch.stack([torch.from_numpy(v) for _, v, _ in scans]).to(dev),
            torch.from_numpy(np.stack([e for _, _, e in scans]).astype(np.float32)).to(dev))


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
def watch_fma32():
    """Inside, every call of grid.fma32 or grid.sqrt32 (the plain versions'
    float64 emulation of one f32 rounding) on a CUDA tensor is listed in
    the yielded list, by function and shape, wherever a module of the port
    holds them: the card paths round in the kernels."""
    from gvom_tpu_torch.ops import grid as gridops

    calls, originals = [], dict(fma32=gridops.fma32, sqrt32=gridops.sqrt32)

    def watched(name):
        def fn(*args):
            if any(getattr(a, "is_cuda", False) for a in args):
                calls.append((name, tuple(args[0].shape)))
            return originals[name](*args)
        return fn

    patched = [(mod, name) for mod in list(sys.modules.values())
               if getattr(mod, "__name__", "").startswith("gvom_tpu_torch") for name in originals
               if getattr(mod, name, None) is originals[name]]
    for mod, name in patched:
        setattr(mod, name, watched(name))
    try:
        yield calls
    finally:
        for mod, name in patched:
            setattr(mod, name, originals[name])


@contextlib.contextmanager
def plain_kernels():
    """Inside, the batched step's seven kernel wrappers (and point_moments)
    run their plain versions on whatever device the tensors are on."""
    from gvom_tpu_torch.ops import binning, kernels, maps2d, moments, raycast
    from gvom_tpu_torch.parallel.sharding import merge_and_columns_plain

    plain = dict(prepare_points=binning.prepare_plain, ray_pass_counts=raycast.pass_counts_plain,
                 bin_points=binning.bin_points, moments_epilogue=moments.moments_epilogue_plain,
                 point_moments=moments.point_moments, plane_fit=maps2d.plane_fit_window_plain,
                 guess_height=maps2d.guess_products_plain, merge_batch=merge_and_columns_plain)
    saved = {name: getattr(kernels, name) for name in plain}
    for name, fn in plain.items():
        setattr(kernels, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(kernels, name, fn)


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


def phase5_batched(cfg, scans, rates, dev, log, err):
    """The batched step at the upstream config. Two steps of BATCH_CHECK
    scans against the same step with the kernels swapped for their plain
    versions; then two steps of BATCH scans, timed, with the launch counts
    set to 0 just before and read just after, and one warm step traced
    with torch.profiler; then K2 and K5 against their plain versions, and
    their times and bounds, on the merged points of a whole batch."""
    import torch

    from gvom_tpu_torch import make_batched_step
    from gvom_tpu_torch.parallel.sharding import prepare_batch
    from gvom_tpu_torch.ops import binning, kernels, moments
    from gvom_tpu_torch.ops import grid as gridops
    from gvom_tpu_torch.types import empty_world_state

    scans_dev = scans_on_device(scans, dev)
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
    w_warm, _ = step(empty_world_state(cfg, dev), *batches[0])      # warm: allocator and kernels
    with watch_fma32() as per_point:
        step(w_warm, *batches[1])                                   # a warm step into a live world
    torch.cuda.synchronize()
    check(not per_point, f"batched path: float64 fma32 or sqrt32 on the card: {per_point[:3]}")
    del w_warm
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
    for name in BATCHED_KERNELS:
        check(launches[name] == 2, f"batched path: {name} launched {launches[name]} times, expected 2")
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

    # ---- one warm step's launches and float64 time, by torch.profiler ----
    w0 = empty_world_state(cfg, dev)    # the step leaves its input world untouched
    res["profile"] = profile_calls(dict(batched_step=lambda: step(w0, *batches[0])), log)
    check(res["profile"]["batched_step"]["f64_launches"] == 0,
          f"batched step: {res['profile']['batched_step']['f64_launches']} float64 launches on the card")
    del w0

    # ---- the merge kernel against its twin: the second step's 32-scan
    # contribution into the first step's live world, whose origin it moves ----
    m_row, res["merge"] = phase5_merge(cb, step, batches, dev, log)

    # ---- K2 and K5 on a whole batch's merged points: K2 on one scratch kept
    # across its calls, as the batched step keeps one, over two batches in
    # turn (the second's bins are the ones timed below) ----
    origin, pw, keep = prepare_batch(cb, *batches[1])
    k1 = phase5_raycast_batch(cb, pw, keep, batches[1][2], origin, rates, log)
    kept = binning.moment_scratch(cb, dev)
    for i in range(2):
        o, q, k = prepare_batch(cb, *batches[i])
        bins = kernels.bin_points(cb, q, k, o, scratch=kept)
        pb = binning.bin_points(cb, q, k, o)
        what = f"K2 on {BATCH} scans' merged points, call {i + 1} on a kept scratch"
        exact(f"{what}: hit", bins.hit, pb.hit)
        exact(f"{what}: min_height", bins.min_height, pb.min_height)
        e2 = sums_close(what, bins.sums, pb.sums, MOM_ATOL_BATCH)
        check(not bins.rest[:, bins.n[0] == 0].any(), f"{what}: channels 1-9 not zero where n is 0")
        err["bin_points"] = max(err["bin_points"], e2)
        nz = pb.n[0] > 0
        log(f"{what} vs plain on a fresh scratch: hit, min_height and n bitwise, channels 1-9 zero where n is 0, "
            f"sums where n > 0 max abs err {e2}, "
            f"{100 * tol_share(bins.sums[:, nz], pb.sums[:, nz], MOM_ATOL_BATCH):.1f} % of the tolerance (largest "
            f"voxel hit count {int(bins.hit.max())})")
        del pb, nz, q, k
    pm = moments.moments_epilogue_plain(cb, bins.n, bins.rest, bins.hit, origin, occupancy_mask=False)
    km = kernels.moments_epilogue(cb, bins.n, bins.rest, bins.hit, origin, occupancy_mask=False)
    e = moments_close(f"K5 mask off on {BATCH} scans' merged points", km, pm, MOM_ATOL_BATCH)
    err["moments_epilogue"] = max(err["moments_epilogue"], e)
    log(f"K5 mask off on {BATCH} scans' merged points vs plain: max abs err {e}, "
        f"{100 * tol_share(km, pm, MOM_ATOL_BATCH):.1f} % of the tolerance (largest voxel count "
        f"{int(bins.n.max())})")
    del pm, km
    nan_blind(f"K5 mask off on {BATCH} scans' merged points",
              lambda n, r: kernels.moments_epilogue(cb, n, r, bins.hit, origin, occupancy_mask=False),
              bins.n, bins.rest)
    # the timed calls below leave the same points' sums in `kept`
    wconv = box_conv_weights(cb, dev)
    conv_in = clean_sums(bins.sums)[None]
    everywhere = torch.ones((X, Y, Z), dtype=torch.bool, device=dev)
    k5_bytes, k5_terms, _, k5_nz = epilogue_bound(cb, bins.n[0], everywhere, V, False)
    row = kernel_row(kernels.XBOX,
                     lambda: kernels.moments_epilogue(cb, bins.n, bins.rest, bins.hit, origin, occupancy_mask=False),
                     lambda: moments.moments_epilogue_plain(cb, bins.n, bins.rest, bins.hit, origin,
                                                            occupancy_mask=False),
                     20, 5, lambda: torch.nn.functional.conv3d(conv_in, wconv), k5_bytes,
                     52 * k5_terms / F32_OPS_PER_S, log)
    # K2 at N = BATCH · max_points (its row in the kernels line is one scan's)
    N, P = pw.shape[0], bins.n.numel()
    n_kept, n_grid, n_win = int(keep.sum()), int(bins.hit.sum()), int(bins.n.sum())
    n_nz = int((bins.n > 0).sum())
    k2_ms, timed = graph_ms(lambda: kernels.bin_points(cb, pw, keep, origin, scratch=kept), 20)
    exact("K2 timed launches on the kept scratch vs the checked call: n", timed.n, bins.n)
    check(not kept.rest[:, timed.n[0] == 0].any(), "K2 timed launches: channels 1-9 not zero where n is 0")
    del timed
    k2_wrapper_ms = cuda_ms(lambda: kernels.bin_points(cb, pw, keep, origin, scratch=kept), 10)
    plain_kept = binning.moment_scratch(cb, dev)
    k2_plain_ms = cuda_ms(lambda: binning.bin_points(cb, pw, keep, origin, scratch=plain_kept), 3)
    del plain_kept
    k2_bytes, k2_ops_s = k2_bound(N, n_kept, V, P, n_nz)
    k2_bound_ms = 1e3 * max(k2_bytes / HBM_BYTES_PER_S, k2_ops_s)
    pflat, vals = index_add_inputs(cb, gridops.map_local(cb, pw, origin), keep, origin)
    sums_lib = torch.zeros((10, P), dtype=torch.float32, device=dev)
    k2_lib_ms = cuda_ms(lambda: sums_lib.index_add_(1, pflat, vals), 10)
    del pflat, vals, sums_lib
    k5_on_ms, _ = graph_ms(lambda: kernels.moments_epilogue(cb, bins.n, bins.rest, bins.hit, origin), 20)
    log(f"timing bin_points on {N} merged points: launch alone {k2_ms:.4f} ms, wrapper {k2_wrapper_ms:.4f} ms; "
        f"plain {k2_plain_ms:.4f} ms; index_add_ of the ten sums (hit, min_height and the fills left out) "
        f"{k2_lib_ms:.4f} ms; bound {k2_bound_ms:.4f} ms (bytes {1e3 * k2_bytes / HBM_BYTES_PER_S:.4f} ms); one "
        f"atomic a point and channel at the probe's rate {k2_atomic_floor_ms(n_grid, n_win, rates):.4f} ms; "
        f"moments_epilogue with the mask on, same sums: launch alone {k5_on_ms:.4f} ms")
    # K2 then K5, as the batched step launches them, against a bound that no design moves
    pair = pair_row("K2 then K5 (mask off)",
                    lambda: kernels.moments_epilogue(cb, *binned(cb, pw, keep, origin, kept), origin,
                                                     occupancy_mask=False),
                    20, N, n_kept, V, k5_terms, log)
    res.update(merged=dict(points=N, points_kept=n_kept, points_in_grid=n_grid, points_in_window=n_win,
                           scratch_nonempty=n_nz, nonempty_voxels=k5_nz, box_terms=k5_terms,
                           max_voxel_count=int(bins.n.max()),
                           bin_points_ms=k2_ms, bin_points_wrapper_ms=k2_wrapper_ms,
                           bin_points_plain_ms=k2_plain_ms, bin_points_bound_ms=k2_bound_ms,
                           bin_points_index_add_ms=k2_lib_ms,
                           bin_points_atomic_floor_ms=k2_atomic_floor_ms(n_grid, n_win, rates),
                           moments_epilogue_mask_on_ms=k5_on_ms, pair_k2_k5=pair),
               ray_pass_counts_batch=k1)
    return launches, [row, m_row], res


def phase5_merge(cfg, step, batches, dev, log):
    """The merge kernel on a real batch: the contribution of the second
    step's BATCH scans (the preparation, K1, K2 and K5 with the mask off, as
    the step computes it on one device) and the first step's world, at the
    moved origin. Every output bitwise its twin's, moments included; the
    quarter slab y0 = 64 bitwise the full result's rows; timed, with its
    bound from this data."""
    import torch

    from gvom_tpu_torch.ops import kernels
    from gvom_tpu_torch.parallel.sharding import merge_and_columns_plain, prepare_batch
    from gvom_tpu_torch.types import VoxelGrid, empty_world_state

    world, _ = step(empty_world_state(cfg, dev), *batches[0])
    scans, valid, egos = batches[1]
    S, N = valid.shape
    origin, pw, keep = prepare_batch(cfg, scans, valid, egos)
    miss = kernels.ray_pass_counts(cfg, pw.view(S, N, 3), keep.view(S, N), egos, origin)
    hit, minh, mom = kernels.point_moments(cfg, pw, keep, origin, occupancy_mask=False)
    contrib = VoxelGrid(hit=hit, miss=miss, min_height=minh, mom=mom, origin=origin)
    ego = egos[-1].contiguous()
    check(not torch.equal(origin, world.grid.origin), "merge check: the batch did not move the origin")
    full = merge_vs_plain(f"merge of {S} scans into a live world", cfg, world, contrib, ego)
    Ys = cfg.xy_size // 4
    merge_slab_vs_full(f"merge of {S} scans into a live world", cfg, world, contrib, ego, full, Ys, Ys)
    nbytes, counts = merge_bound(cfg, world, contrib)
    V = counts["voxels"]
    # the timed calls merge over one copy again and again: each call's input
    # is the previous call's output, so a later call also reads the batch
    # moments of the voxels that the first one revived (merge_bound counts
    # the first call's: the bound is, if anything, low)
    timed = copy_grid(contrib)
    row = kernel_row(kernels.MERGE, lambda: kernels.merge_batch(cfg, world, timed, ego),
                     lambda: merge_and_columns_plain(cfg, world, contrib, ego), 20, 3, None, nbytes,
                     MERGE_OPS * V / F32_OPS_PER_S, log)
    log(f"merge of {S} scans into a live world: bitwise its plain version (every merged channel, the moments, "
        f"the evidence, the column maps) and on the quarter slab y0 = {Ys}; it reads {counts}")
    return row, dict(counts, occupied=int((full[0].hit > 0).sum()), bytes=nbytes)


def phase5_raycast_batch(cfg, pw, keep, egos, origin, rates, log):
    """K1 on a whole batch of S scans in one launch: timed, with its bound,
    and held bitwise against the plain twin (about a second a scan) and
    the sum of its S one-scan launches over the same scans. From 9 scans
    of 131,072 rays on an H100 the launch sorts 1,024 rays a block and a
    one-scan launch 256 (kernels.ray_window): the two forms differ."""
    import torch

    from gvom_tpu_torch.ops import kernels, raycast

    S = egos.shape[0]
    pts, kp = pw.view(S, -1, 3), keep.view(S, -1)
    N = pts.shape[1]
    V = cfg.voxel_count
    whole = kernels.ray_pass_counts(cfg, pts, kp, egos, origin)
    summed = torch.zeros_like(whole)
    for s in range(S):
        kernels.ray_pass_counts(cfg, pts[s:s + 1], kp[s:s + 1], egos[s:s + 1], origin, out=summed)
    exact(f"K1 on {S} scans in one launch vs the sum of {S} one-scan launches", whole, summed)
    exact(f"K1 on {S} scans in one launch vs the plain twin", whole,
          raycast.pass_counts_plain(cfg, pts, kp, egos, origin))
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
        f"probe's rate {r['atomic_floor_ms']:.4f} ms; bitwise equal to the plain twin and the sum of the one-scan "
        f"launches")
    return r


LAP_BATCH = (64, 128)    # phase5_raycast_lap: the benchmark lap's second batch of 64 scans
LAP_SEED = 3_000_000_019  # the lap's run seed: its range noise
LAP_SCAN = 100            # one scan of the batch, timed alone
LAP_SLAB = (64, 64)       # the quarter slab the lap's times take


def phase5_raycast_lap(rows, rates, dev, log):
    """K1 on the benchmark's drive (benchmark/scangen.make_lap at the
    OS1-128 deployment of benchmark/configs/os1_128.json): its 64-scan
    batch LAP_BATCH, sliced as the replay slices it and prepared as the
    batched step prepares it, in one launch (the window the main path
    takes), bitwise the plain twin and the sum of its 64 one-scan
    launches, timed against its bound;
    the march's schedule (kernels.ray_march_stats) in launch order and
    sorted by live steps, at the launch's window and at 256 rays a block:
    lane utilisation and atomics after the warp merge; the one-scan and
    slab rows of phase 4 beside it; and the times of the lap's scan
    LAP_SCAN, of its slab LAP_SLAB and of the batch's slab."""
    import torch

    from benchmark import scangen
    from gvom_tpu_torch import GvomConfig
    from gvom_tpu_torch.engine.replay import batched_ray_steps
    from gvom_tpu_torch.ops import kernels, raycast

    root = Path(__file__).resolve().parent
    conf = json.loads((root / "benchmark/configs/os1_128.json").read_text())
    drive = json.loads((root / "benchmark/drives/lap.json").read_text())
    made = scangen.make_lap(conf["sensor"], drive, conf["gvom"]["ground_to_lidar_height"], LAP_SEED, dev)
    S = LAP_BATCH[1] - LAP_BATCH[0]
    cfg = GvomConfig.from_dict(conf["gvom"])
    cfg = cfg.replace(ray_steps_override=batched_ray_steps(cfg, made["egos"].cpu().numpy(), S))
    b = slice(*LAP_BATCH)
    be = made["egos"][b].contiguous()
    p, keep, origin, _ = kernels.prepare_points(cfg, made["points"][b].contiguous(), made["valid"][b].contiguous(),
                                                be, frame_ego=be[-1].contiguous(), drop_dead=True)
    del made
    N, V = p.shape[1], cfg.voxel_count
    whole = kernels.ray_pass_counts(cfg, p, keep, be, origin)
    summed = torch.zeros_like(whole)
    for s in range(S):
        kernels.ray_pass_counts(cfg, p[s:s + 1], keep[s:s + 1], be[s:s + 1], origin, out=summed)
    exact(f"K1 on the lap's {S} scans in one launch vs the sum of {S} one-scan launches", whole, summed)
    exact(f"K1 on the lap's {S} scans in one launch vs the plain twin", whole,
          raycast.pass_counts_plain(cfg, p, keep, be, origin))
    n_pass, n_rays = int(whole.sum()), int(keep.sum())
    ms, _ = graph_ms(lambda: kernels.ray_pass_counts(cfg, p, keep, be, origin), 40)
    nbytes, ops_s = k1_bound(S * N, S, n_rays, n_pass, V)
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, ops_s)
    window = kernels.ray_window(S, N, torch.cuda.get_device_properties(dev).multi_processor_count)
    one_scan = slice(LAP_SCAN - LAP_BATCH[0], LAP_SCAN - LAP_BATCH[0] + 1)
    lap_ms = {}
    for label, sl, yw in (("scan", one_scan, None), ("scan_slab", one_scan, LAP_SLAB),
                          ("batch_slab", slice(None), LAP_SLAB)):
        args = (p[sl].contiguous(), keep[sl].contiguous(), be[sl].contiguous(), origin)
        lap_ms[label], _ = graph_ms(lambda args=args, yw=yw: kernels.ray_pass_counts(cfg, *args, y_window=yw),
                                    400 if args[0].shape[0] == 1 else 40)
    schedule = {}
    for w in sorted({window, 256}):
        for sort in (False, True):
            passes, c = kernels.ray_march_stats(cfg, p, keep, be, origin, sort=sort, window=w)
            exact(f"K1's stats entry on the lap's batch ({w} rays a block, sorted {sort})", passes, whole)
            live, issued, atoms = c.tolist()
            schedule[f"{w}_{'sorted' if sort else 'launch_order'}"] = dict(
                live_lane_steps=live, issued_lane_steps=issued, lane_utilisation=live / issued, atomics=atoms)
    srt, old = schedule[f"{window}_sorted"], schedule[f"{window}_launch_order"]
    at256 = "" if window == 256 else (f"; at 256 rays a block {schedule['256_sorted']['lane_utilisation']:.3f} and "
                                      f"{schedule['256_sorted']['atomics']} sorted")
    check(srt["lane_utilisation"] > 0.6, f"K1 sorted: lane utilisation {srt['lane_utilisation']:.3f} on the lap")
    one = {r["name"]: r for r in rows if r["name"] in ("ray_pass_counts", "ray_pass_counts_slab")}
    res = dict(scans=S, rays=n_rays, passes=n_pass, ray_steps=cfg.ray_steps, window=window, ms=ms, bound_ms=bound,
               atomic_floor_ms=1e3 * n_pass / rates["int32"], schedule=schedule, lap_ms=lap_ms,
               one_scan=dict(ms=one["ray_pass_counts"]["ms"], bound_ms=one["ray_pass_counts"]["bound_ms"]),
               slab=dict(ms=one["ray_pass_counts_slab"]["ms"], bound_ms=one["ray_pass_counts_slab"]["bound_ms"]))
    log(f"phase 5 K1 on the lap ({S} scans {LAP_BATCH[0]}-{LAP_BATCH[1] - 1}, {n_rays} rays, {n_pass} passes, "
        f"ray_steps {cfg.ray_steps}, {window} rays a block): lane utilisation {old['lane_utilisation']:.3f} in "
        f"launch order, {srt['lane_utilisation']:.3f} sorted; atomics after the warp merge {old['atomics']} in "
        f"launch order, {srt['atomics']} sorted{at256}; bitwise the plain twin and the sum of its one-scan "
        f"launches")
    log(f"K1 times (launch alone) beside their bounds: one scan {res['one_scan']['ms']:.4f} ms (bound "
        f"{res['one_scan']['bound_ms']:.4f}), the slab {res['slab']['ms']:.4f} ms "
        f"(bound {res['slab']['bound_ms']:.4f}), "
        f"the lap's {S} scans {ms:.4f} ms (bound {bound:.4f}, {100 * bound / ms:.1f} %; one atomic a pass at the "
        f"probe's rate {res['atomic_floor_ms']:.4f} ms); on the lap, scan {LAP_SCAN} {lap_ms['scan']:.4f} ms, its "
        f"slab {LAP_SLAB} {lap_ms['scan_slab']:.4f} ms, the batch's slab {lap_ms['batch_slab']:.4f} ms")
    return res


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


# ----------------------------------------------------------------------
# 7. the live mapper's host path


OS1_POINT_STEP = 48     # an Ouster OS1 PointCloud2 point: x, y, z at 0, 4, 8, intensity at 16, ...
SENSOR_HZ = 10.0        # each sensor thread's scan rate (the timer combines at cfg.combine_freq)
NODE_SECONDS = 3.0      # how long the node runs under load
EIGEN_ATOL = 2e-3       # the exporter's eigen columns: f32 acos/cos on the card and on the CPU


def os1_payload(points):
    """(PointCloud2 payload, CloudSpec) of points [N,3] in the Ouster
    ROS package's 48-byte point layout (the fields after z are zero)."""
    import numpy as np

    from gvom_tpu_torch.io.pointcloud2 import CloudSpec, PointField

    buf = np.zeros((len(points), OS1_POINT_STEP // 4), np.float32)
    buf[:, :3] = points
    fields = [PointField(c, 4 * i, 7) for i, c in enumerate("xyz")] + [PointField("intensity", 16, 7)]
    return buf.tobytes(), CloudSpec(fields=fields, point_step=OS1_POINT_STEP, width=len(points))


def decode_rates(payloads, log):
    """Points and bytes a second of the native and the NumPy PointCloud2
    decode over the payloads (host clock, best of three passes); both give
    bitwise the same points."""
    import numpy as np

    from gvom_tpu_torch.io.pointcloud2 import pointcloud2_to_xyz

    out, res = {}, {}
    for path in ("native", "numpy"):
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            out[path] = [pointcloud2_to_xyz(d, s, use_native=path == "native") for d, s in payloads]
            best = min(best, time.perf_counter() - t0)
        n = sum(len(x) for x in out[path])
        res[path] = dict(s=best, points_per_s=n / best, bytes_per_s=sum(len(d) for d, _ in payloads) / best)
    for a, b in zip(out["native"], out["numpy"]):
        check(np.array_equal(a, b), "PointCloud2 decode: the native and the NumPy paths differ")
    log(f"phase 7 decode: {len(payloads)} PointCloud2 payloads of {OS1_POINT_STEP}-byte points, native "
        f"{res['native']['points_per_s'] / 1e6:.1f} M points/s ({res['native']['bytes_per_s'] / 1e9:.2f} GB/s), "
        f"NumPy {res['numpy']['points_per_s'] / 1e6:.1f} M points/s ({res['numpy']['bytes_per_s'] / 1e9:.2f} GB/s); "
        "the same points")
    return res


def ros_timer(period, callback, stop):
    """Call callback on rospy.Timer's schedule (rospy.Rate.sleep) until stop
    is set: a tick every period from the start, at once when the last one
    ran late, and from now when more than two periods behind."""
    last = time.perf_counter()
    while True:
        now = time.perf_counter()
        if stop.wait(max(0.0, last + period - now)):
            return
        last += period
        if now - last > 2 * period:
            last = now
        callback()


def phase7_node_under_load(cfg, scans, payloads, log):
    """VoxelMapperNode on the card for NODE_SECONDS: two sensor threads, each
    decoding a PointCloud2 payload through the native path and ingesting it
    SENSOR_HZ times a second, while a timer thread on rospy.Timer's schedule
    at cfg.combine_freq runs the body of the ROS node's timer callback
    (GvomRosNode.cb_timer): publish the maps, then the debug clouds. The
    launch counts are set to 0 just before and read just after. Any
    exception in a thread fails the run."""
    import threading

    import torch

    from gvom_tpu_torch import VoxelMapperNode
    from gvom_tpu_torch.io.pointcloud2 import decode_path, pointcloud2_to_xyz
    from gvom_tpu_torch.ops import kernels

    published, ticks = {}, []

    def publisher(name, data, meta):   # called from the timer thread only
        published[name] = published.get(name, 0) + 1

    node = VoxelMapperNode(config=cfg, publisher=publisher)
    paths = sorted({decode_path(spec) for _, spec in payloads})
    check(paths == ["native"], f"the sensor threads' decode path is {paths}, not the native one")
    n_per = int(NODE_SECONDS * SENSOR_HZ)
    errors, decode_s = [], []

    def sensor(tid):
        try:
            t0 = time.perf_counter()
            for k in range(n_per):
                i = (2 * k + tid) % len(payloads)
                t1 = time.perf_counter()
                xyz = pointcloud2_to_xyz(*payloads[i], use_native=True)
                decode_s.append(time.perf_counter() - t1)
                node.on_odometry(scans[i][2])
                node.on_pointcloud(xyz)
                time.sleep(max(0.0, t0 + (k + 1) / SENSOR_HZ - time.perf_counter()))
        except Exception as e:  # fails the run below
            errors.append(e)

    def cb_timer():
        t1 = time.perf_counter()
        if node.publish_maps() is not None:
            node.publish_debug()
            ticks.append(time.perf_counter() - t1)

    def timer(stop):
        try:
            ros_timer(1.0 / cfg.combine_freq, cb_timer, stop)
        except Exception as e:  # fails the run below
            errors.append(e)

    stop = threading.Event()
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    ticker = threading.Thread(target=timer, args=(stop,), name="timer")
    ticker.start()
    threads = [threading.Thread(target=sensor, args=(t,), name=f"sensor-{t}") for t in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=NODE_SECONDS + 60)
    stop.set()
    ticker.join(timeout=60)
    elapsed = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels.KERNELS}
    check(not any(t.is_alive() for t in threads + [ticker]), "a sensor or the timer thread did not end")
    check(not errors, f"a sensor or the timer thread failed: {errors[0]!r}" if errors else "")
    snap = node.metrics.snapshot()
    counters, stats = snap["counters"], snap["timings"]
    scans_in, combines = counters.get("scans", 0), counters.get("combines", 0)
    check(scans_in == 2 * n_per, f"node: {scans_in} scans ingested of {2 * n_per}")
    check(combines > 0, "node: no map was published")
    for name in ("prepare_points", "ray_pass_counts", "bin_points", "ingest_epilogue"):
        check(launches[name] == scans_in, f"node: kernel {name} launched {launches[name]} times for {scans_in} scans")
    check(launches["combine"] == combines, f"node: K4 launched {launches['combine']} times for {combines} combines")
    for name in ("hard_obstacle_map", "roughness_map", "debug/voxel", "debug/height_map", "debug/inferred_height_map"):
        check(published.get(name) == combines, f"node: {name} published {published.get(name)} times, "
              f"{combines} maps")
    res = dict(seconds=elapsed, scans=scans_in, maps=combines, maps_per_s=combines / elapsed,
               combine_freq=cfg.combine_freq, sensor_hz=SENSOR_HZ, sensors=2,
               decode_ms_median=1e3 * statistics.median(decode_s),
               tick_ms_median=1e3 * statistics.median(ticks), tick_ms_max=1e3 * max(ticks),
               **{f"{k}_ms_{q}": 1e3 * stats[f"{k}_s"][q] for k in ("ingest", "combine") for q in ("median", "p95")})
    log(f"phase 7 node: {scans_in} scans from two sensor threads at {SENSOR_HZ:g} Hz each (native decode, median "
        f"{res['decode_ms_median']:.3f} ms), {combines} maps published with the debug clouds in {elapsed:.2f} s "
        f"by the ROS node's timer callback on rospy.Timer's schedule ({res['maps_per_s']:.2f} Hz against "
        f"combine_freq {cfg.combine_freq:g} Hz; a tick, maps and debug clouds, median {res['tick_ms_median']:.3f} "
        f"ms, max {res['tick_ms_max']:.3f} ms); on_pointcloud median "
        f"{res['ingest_ms_median']:.3f} ms p95 {res['ingest_ms_p95']:.3f} ms (enqueue, no sync), combine median "
        f"{res['combine_ms_median']:.3f} ms p95 {res['combine_ms_p95']:.3f} ms (host clock, its sync included); "
        f"launches {{{', '.join(f'{k}: {v}' for k, v in launches.items() if v)}}}")
    return node, launches, res


def to_device(x, dev):
    """A state dataclass of the port with every tensor moved to dev."""
    return dataclasses.replace(x, **{f.name: (to_device(v, dev) if dataclasses.is_dataclass(v) else v.to(dev))
                                     for f in dataclasses.fields(x) for v in [getattr(x, f.name)]})


def phase7_determinism_and_exporters(node, scans, log):
    """reset, then the same scans single-threaded through the node, twice:
    the layers bitwise equal between the runs, and every MapProducts field
    bitwise equal to a fresh Gvom's fed the same scans. Then the three
    exporters at the full grid, timed, against the same exporters on the
    world and products copied to the CPU: the voxel map's columns 0-4 and
    the height maps bitwise, the eigen columns within EIGEN_ATOL. The
    second reset is called from a thread on another CUDA stream, and the
    scans follow it at once."""
    import threading

    import numpy as np
    import torch

    from gvom_tpu_torch import Gvom

    cfg = node.config

    def reset_on_a_side_stream():
        """reset from a thread whose current stream is not the facade's."""
        errors = []

        def body():
            try:
                with torch.cuda.stream(torch.cuda.Stream()):
                    node.engine.reset()
            except Exception as e:  # fails the run below
                errors.append(e)

        t = threading.Thread(target=body)
        t.start()
        t.join(timeout=60)
        check(not t.is_alive() and not errors, f"reset on a side stream: {errors or 'did not end'}")

    def run(reset):
        reset()
        check(node.engine.products is None and node.engine.combine_maps() is None, "reset left a map behind")
        layers, prods = [], []
        for pad, mask, ego in scans:
            node.on_odometry(ego)
            node.on_pointcloud(pad[mask])
            out = node.publish_maps()
            check(out is not None, "node after reset: no map published")
            layers.append(out.layers)
            prods.append(node.engine.products)
        return layers, prods

    first, _ = run(node.engine.reset)
    second, prods = run(reset_on_a_side_stream)
    for i, (a, b) in enumerate(zip(first, second)):
        for name in a:
            check(np.array_equal(a[name], b[name]), f"after reset, scan {i}: layer {name} differs from the first run")
    fresh, fresh_out = Gvom(config=cfg), []
    for i, (pad, mask, ego) in enumerate(scans):
        fresh.process_pointcloud(pad[mask], ego)
        fresh_out.append(fresh.combine_maps())
        for name in PRODUCT_FIELDS:
            exact(f"node after reset vs a fresh Gvom, scan {i}: {name}", getattr(prods[i], name),
                  getattr(fresh.products, name))

    eng = node.engine
    cpu = Gvom(config=cfg, device="cpu")
    cpu._world, cpu._products = to_device(eng.world_state, "cpu"), to_device(eng.products, "cpu")
    times, err = {}, 0.0
    for name in ("make_debug_voxel_map", "make_debug_height_map", "make_debug_inferred_height_map"):
        fn, reps = getattr(eng, name), []
        for _ in range(4):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()                         # ends in copies to the host
            reps.append(time.perf_counter() - t0)
        times[name] = dict(ms_median_warm=1e3 * statistics.median(reps[1:]), rows=len(out))
        ref = getattr(cpu, name)()
        check(out.shape == ref.shape and out.dtype == ref.dtype, f"{name}: {out.shape} vs the CPU's {ref.shape}")
        bitwise = 5 if name == "make_debug_voxel_map" else out.shape[1]
        check(np.array_equal(out[:, :bitwise], ref[:, :bitwise]), f"{name}: columns 0-{bitwise - 1} differ from the CPU")
        if bitwise < out.shape[1]:
            err = float(np.abs(out[:, bitwise:] - ref[:, bitwise:]).max())
            check(err <= EIGEN_ATOL, f"{name}: eigen columns differ from the CPU by {err}")
    check(times["make_debug_voxel_map"]["rows"] == int((eng.world_state.grid.hit > 0).sum()), "voxel map rows")
    log(f"phase 7 reset: two runs of {len(scans)} scans after reset (the second from a thread on a side stream) "
        f"publish bitwise the same layers, and the "
        f"products equal a fresh Gvom's; exporters at the full grid match the CPU's (eigen max abs err {err:.3g}), "
        + ", ".join(f"{k[len('make_debug_'):]} {v['rows']} rows {v['ms_median_warm']:.3f} ms" for k, v in times.items()))
    return fresh.products, fresh_out, dict(exporters=times, eigen_max_abs_err=err)


def start_cli(*args):
    return subprocess.Popen([sys.executable, "-m", "gvom_tpu_torch.cli", *args], cwd=ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def cli_result(name, proc, timeout):
    """The last line of a CLI process's output as JSON (its whole output, for
    parity's indented report); it must exit 0."""
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise Failed(f"cli {name}: still running after {timeout} s")
    check(proc.returncode == 0, f"cli {name}: exit code {proc.returncode}: {err[-3000:]}")
    return json.loads(out if name.startswith("parity") else out.splitlines()[-1])


def phase7_bag_round_trip(cfg, scans, fresh_products, fresh_out, log):
    """A bz2-chunked bag of the scans and their odometry, converted by `cli
    convert-bag` in a temporary directory and replayed by sequential_replay
    on the card: the scan log holds the scans bitwise, and the replay's
    outputs and products equal the facade's fed the original scans. An lz4
    chunk is round-tripped on a small bag (the LZ4 codec is pure Python)."""
    import numpy as np

    from gvom_tpu_torch import sequential_replay
    from gvom_tpu_torch.io import rosbag
    from gvom_tpu_torch.io.logio import load_log

    def messages(pts_of):
        msgs = []
        for i, (pad, mask, ego) in enumerate(scans):
            t = 100.0 + 0.1 * i
            msgs.append(("/odom", "nav_msgs/Odometry", t - 0.05, rosbag.serialize_odometry(ego, t - 0.05)))
            msgs.append(("/os_cloud_node/points", "sensor_msgs/PointCloud2", t,
                         rosbag.serialize_pointcloud2(pts_of(pad[mask]), t)))
        return msgs

    with tempfile.TemporaryDirectory() as tmp:
        bag, out = os.path.join(tmp, "drive.bag"), os.path.join(tmp, "drive.npz")
        t0 = time.perf_counter()
        rosbag.write_minimal_bag(bag, messages(lambda p: p), chunked="bz2")
        bag_mb = os.path.getsize(bag) / 1e6
        conv = cli_result("convert-bag", start_cli("convert-bag", bag, out), 600)
        slog = load_log(out)
        convert_s = time.perf_counter() - t0
        small = os.path.join(tmp, "small.bag")
        rosbag.write_minimal_bag(small, messages(lambda p: p[:1000]), chunked="lz4")
        small_log = rosbag.bag_to_scanlog(small)
    check(conv["scans"] == len(slog) == len(small_log) == len(scans), f"bag round trip: {conv['scans']} scans")
    for i, ((pts, ego, tf), (sp, se, _), (pad, mask, e)) in enumerate(zip(slog, small_log, scans)):
        check(np.array_equal(pts, pad[mask]) and np.array_equal(ego, e) and tf is None, f"bz2 bag: scan {i}")
        check(np.array_equal(sp, pad[mask][:1000]) and np.array_equal(se, e), f"lz4 bag: scan {i}")
    engine, outputs, _ = sequential_replay(cfg, slog)
    for i, (a, b) in enumerate(zip(outputs, fresh_out)):
        for name, x, y in zip(("origin", "positive", "negative", "roughness", "visibility"), a, b):
            check(np.array_equal(x, y), f"replay of the converted bag, combine {i}: {name} differs from the facade's")
    for name in PRODUCT_FIELDS:
        exact(f"replay of the converted bag: product {name}", getattr(engine.products, name),
              getattr(fresh_products, name))
    log(f"phase 7 bag: {len(scans)} scans in a bz2-chunked bag of {bag_mb:.1f} MB, written and converted by "
        f"cli convert-bag in {convert_s:.2f} s; sequential_replay of the log gives bitwise the facade's outputs "
        f"and products; an lz4-chunked bag of {len(scans)} small scans reads back bitwise")
    return dict(bag_mb=bag_mb, write_and_convert_s=convert_s)


def phase7_cli(procs, log):
    """`cli replay` (sequential and batched, their defaults), `cli selftest`
    and `cli parity --scans 3` on the card and on the CPU, started together
    earlier: each exits 0; the replays report their kernel launches, the
    selftest its verdict, and the two parity reports are equal field by
    field."""
    res = {name: cli_result(name, p, 900) for name, p in procs.items()}
    pg, pc = res["parity cuda"], res["parity cpu"]
    check(len(pg["per_combine"]) == 3 and pg == pc,
          f"cli parity: the report on the card differs from the CPU's: {pg} vs {pc}")
    seq, bat, st = res["replay sequential"], res["replay batched"], res["selftest"]
    for name in ("prepare_points", "ray_pass_counts", "bin_points", "ingest_epilogue", "combine"):
        check(seq["launches"].get(name) == seq["scans"], f"cli replay --sequential: {name} launches {seq['launches']}")
    for name in ("prepare_points", "ray_pass_counts", "bin_points", "moments_epilogue"):
        check(bat["launches"].get(name) == bat["batches"], f"cli replay: {name} launches {bat['launches']}")
    check(st["ok"] is True, f"cli selftest: {st.get('error')}")
    from gvom_tpu_torch.ops import kernels

    missing = sorted(k.name for k in kernels.KERNELS if not st["launches"].get(k.name))
    check(not missing, f"cli selftest launched no {missing}")
    log(f"phase 7 cli: replay --sequential {seq['scans']} scans (launches {seq['launches']}), replay "
        f"{bat['scans']} scans in {bat['batches']} batches (launches {bat['launches']}), selftest ok over "
        f"{st['scans']} scans at {st['grid']} ({len(st['checks'])} error maxima, all within tolerance); parity "
        f"--scans 3 gives the same report on the card as on the CPU (rough_max_diff_defined "
        f"{[r['rough_max_diff_defined'] for r in pg['per_combine']]})")
    return res


def phase7_host_path(cfg, scans, log):
    """The live mapper's host path: the node under load, reset and the
    exporters, the bag round trip, and the CLI (started as subprocesses
    once the timed parts are done, and read at the end)."""
    payloads = [os1_payload(pad[mask]) for pad, mask, _ in scans]
    res = dict(decode=decode_rates(payloads, log))
    node, launches, res["node"] = phase7_node_under_load(cfg, scans, payloads, log)
    products, outs, res["reset_and_exporters"] = phase7_determinism_and_exporters(node, scans, log)
    del node
    procs = {"replay sequential": start_cli("replay", "--sequential"), "replay batched": start_cli("replay"),
             "selftest": start_cli("selftest"), "parity cuda": start_cli("parity", "--device", "cuda", "--scans", "3"),
             "parity cpu": start_cli("parity", "--device", "cpu", "--scans", "3")}
    try:
        res["bag"] = phase7_bag_round_trip(cfg, scans, products, outs, log)
        res["cli"] = phase7_cli(procs, log)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
    return launches, res


def phase8_bench_and_entry(log):
    """`python -m gvom_tpu_torch.bench` in each of its four modes at its
    defaults (the upstream deployment), 8 steps, best of 2, one subprocess
    at a time, so that nothing else runs on the card beside it; each prints
    bench.py's JSON lines (perscan two, the contract line last), which are
    printed here. Then entry()'s fn on the card against entry(device="cpu"):
    the four maps bitwise."""
    import torch

    from gvom_tpu_torch.entry import entry

    lines = {}
    for mode in BENCH_MODES:
        t0 = time.perf_counter()
        try:
            r = subprocess.run([sys.executable, "-m", "gvom_tpu_torch.bench", "--mode", mode, "--steps", "8",
                                "--repeats", "2"], cwd=ROOT, capture_output=True, text=True, timeout=300)
        except subprocess.TimeoutExpired:
            raise Failed(f"bench --mode {mode}: still running after 300 s")
        check(r.returncode == 0, f"bench --mode {mode}: exit code {r.returncode}: {r.stderr[-3000:]}")
        out = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
        check(len(out) == (2 if mode == "perscan" else 1), f"bench --mode {mode}: {len(out)} JSON lines")
        for x in out:
            check(x["value"] > 0 and x["device"] == torch.cuda.get_device_name(0)
                  and x.get("raycast", x.get("impl", "cuda")) == "cuda", f"bench --mode {mode}: {x}")
            print(json.dumps(x), flush=True)
        check(mode != "perscan" or out[-1].get("combine_every") == 8, "bench: the contract line is not the last")
        lines[mode] = dict(lines=out, command_s=time.perf_counter() - t0)
    fn, args = entry()
    got = fn(*args)
    cfn, cargs = entry(device="cpu")
    for name, a, b in zip(("positive", "negative", "roughness", "visibility"), got, cfn(*cargs)):
        exact(f"entry() on the card vs the CPU: {name}", a.cpu(), b)
    check(int(got[3].sum()) > 0, "entry(): an empty visibility map")
    took = ", ".join(f"{m} {v['command_s']:.1f} s" for m, v in lines.items())
    log(f"phase 8: bench in {len(lines)} modes ({took}); entry()'s four maps on the card bitwise those on the CPU")
    return lines


# ----------------------------------------------------------------------
# 9. the (data, space) mesh on the one card


def mesh_inputs(cfg, scans, dev):
    """The phase-9 batches: two steps of BATCH scans as make_batch stages
    them, and their ray budget."""
    import numpy as np
    import torch

    scans_dev = (torch.stack([torch.from_numpy(p) for p, _, _ in scans[:4]]).to(dev),
                 torch.stack([torch.from_numpy(v) for _, v, _ in scans[:4]]).to(dev),
                 torch.from_numpy(np.stack([e for _, _, e in scans[:4]]).astype(np.float32)).to(dev))
    batches = [make_batch(scans_dev, BATCH, i) for i in range(2)]
    return batches, batched_cfg(cfg, batches[0])


def mesh_steps(step, world, batches, mesh, ingest, barrier=lambda: None):
    """Two timed steps on this rank (host clock, synchronized): the slab
    worlds and products after each, the step ms, the step's own peak device
    bytes, the launches and the bytes gloo moved through the host."""
    import torch

    from gvom_tpu_torch.ops import kernels
    from gvom_tpu_torch.parallel.sharding import shard_batch

    step(world, *shard_batch(*batches[0], mesh, ingest))       # warm: the allocator and the groups
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    mesh.host_bytes = 0
    outs, ms = [], []
    for b in batches:
        barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        world, products = step(world, *shard_batch(*b, mesh, ingest))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        outs.append((world, products))
    stats = dict(step_ms=ms, max_memory_allocated=torch.cuda.max_memory_allocated(),
                 peak_step_bytes=torch.cuda.max_memory_allocated() - base,
                 launches={k.name: k.launches for k in kernels.KERNELS if k.launches}, host_bytes=mesh.host_bytes)
    return outs, stats


def same_as_one_rank(what, world, products, ref_world, ref_products):
    """A gathered mesh world and its products against the one-rank step's:
    every product and hit, miss, min_height and evidence bitwise, the
    moments n bitwise and the nine sums within MOM_ATOL_BATCH (the data
    ranks' sums add in another order). Returns the moments' max abs err."""
    e = same_world(what, world, ref_world, MOM_ATOL_BATCH)
    for name in PRODUCT_FIELDS:
        exact(f"{what}: product {name}", getattr(products, name), getattr(ref_products, name))
    return e


def mesh_rank(argv):
    """One rank of phase 9 (b): gloo on the one card, the meshes of
    MESH_SHAPES, each held on rank 0 against the one-rank step's results
    that the parent saved; prints one JSON line per mesh."""
    import torch

    from gvom_tpu_torch import GvomConfig, make_batched_step
    from gvom_tpu_torch.parallel.mesh import init_distributed, make_mesh, rank_args, shutdown
    from gvom_tpu_torch.parallel.sharding import gather_world, shard_world
    from gvom_tpu_torch.types import empty_world_state

    rank, n, coordinator, rest = rank_args(argv)
    inputs = Path(rest[rest.index("--mesh-rank") + 1])
    init_distributed(coordinator, n, rank, backend="gloo", device=DEVICE)
    meshes = [(name, make_mesh(space=space, device=DEVICE), ingest) for name, space, ingest in MESH_SHAPES]
    dev = meshes[0][1].device
    saved = torch.load(inputs / "inputs.pt", map_location="cpu", weights_only=False)
    cfg, cb = GvomConfig.from_dict(saved["cfg"]), GvomConfig.from_dict(saved["cb"])
    batches = [tuple(t.to(dev) for t in b) for b in saved["batches"]]
    refs = None
    for name, mesh, ingest in meshes:
        step = make_batched_step(cb, dev, mesh=mesh, ingest=ingest)
        outs, stats = mesh_steps(step, shard_world(empty_world_state(cfg, dev), mesh), batches, mesh, ingest,
                                 mesh.barrier)
        full = [(gather_world(w, mesh), p) for w, p in outs]
        if rank == 0:
            if refs is None:
                refs = torch.load(inputs / "refs.pt", map_location=dev, weights_only=False)
            stats["max_abs_err"] = max(same_as_one_rank(f"mesh {name} step {i}", w, p, *refs[i])
                                       for i, (w, p) in enumerate(full))
        del outs, full
        print(json.dumps(dict(mesh=name, shape=mesh.shape, rank=rank, **stats)), flush=True)
    shutdown()
    return 0


def phase9_mesh(cfg, scans, dev, log):
    """The (data, space) mesh on the one card (parallel/mesh.py). The card
    holds one NCCL rank: (a) a one-rank NCCL mesh takes two batched steps
    of BATCH scans, bitwise the same steps with mesh=None but for the
    moments' rounding (the kernels' atomics add in any order);
    (b) four ranks in four processes share the card over gloo on the meshes
    of MESH_SHAPES, each gathered world and its products against the
    one-rank step; (c) dryrun_multichip(4, backend="gloo"); (d) `bench
    --mode scaling --devices 1`. A correctness run of the collectives: four
    ranks on one card measure no scaling."""
    import torch
    import torch.distributed as dist

    from gvom_tpu_torch import make_batched_step
    from gvom_tpu_torch.entry import dryrun_multichip
    from gvom_tpu_torch.parallel.mesh import Mesh, init_distributed, make_mesh, run_ranks
    from gvom_tpu_torch.parallel.sharding import gather_world, shard_world
    from gvom_tpu_torch.types import empty_world_state

    t_phase = time.perf_counter()
    batches, cb = mesh_inputs(cfg, scans, dev)
    one = make_batched_step(cb, dev)
    world = empty_world_state(cfg, dev)
    single = mesh_steps(one, world, batches, Mesh.single(dev), "slab")
    refs = [(w, p) for w, p in single[0]]
    res = dict(one_rank=single[1])
    # K2's and K5's float atomics add in any order: the same step run twice
    # on the card differs in the nine moment sums (not in n), within MOM_ATOL_BATCH
    again = mesh_steps(one, world, batches, Mesh.single(dev), "slab")[0]
    res["one_rank_rerun_moment_diffs"] = [int((a.grid.mom != b.grid.mom).sum()) for (a, _), (b, _) in zip(again, refs)]
    for i, ((w, p), (rw, rp)) in enumerate(zip(again, refs)):
        same_as_one_rank(f"the one-rank step run again, step {i}", w, p, rw, rp)
    del again

    # ---- (a) NCCL, one rank ----
    with tempfile.TemporaryDirectory() as tmp:
        backend = init_distributed(f"file://{tmp}/store", 1, 0, device=DEVICE)
        try:
            mesh = make_mesh(device=DEVICE)
            outs, res["nccl_1x1"] = mesh_steps(make_batched_step(cb, dev, mesh=mesh),
                                               shard_world(empty_world_state(cfg, dev), mesh), batches, mesh, "slab")
            res["nccl_1x1"]["max_abs_err"] = max(
                same_as_one_rank(f"NCCL (1, 1) mesh step {i}", gather_world(w, mesh), p, rw, rp)
                for i, ((w, p), (rw, rp)) in enumerate(zip(outs, refs)))
            res["nccl_1x1"]["moment_diffs"] = [int((w.grid.mom != rw.grid.mom).sum())
                                               for (w, _), (rw, _) in zip(outs, refs)]
            del outs
        finally:
            dist.destroy_process_group()
    check(backend == "nccl", f"one rank on one card took backend {backend}, not NCCL")
    log(f"phase 9 (a): a (1, 1) mesh over NCCL, two steps of {BATCH} scans: products, hit, miss, min_height, "
        f"evidence and n bitwise the one-rank step, the nine moment sums within MOM_ATOL_BATCH (max abs err "
        f"{res['nccl_1x1']['max_abs_err']}; {res['nccl_1x1']['moment_diffs']} elements differ, and "
        f"{res['one_rank_rerun_moment_diffs']} between two runs of the one-rank step: the atomics' order); step "
        f"{res['nccl_1x1']['step_ms'][1]:.2f} ms against {res['one_rank']['step_ms'][1]:.2f} ms with mesh=None "
        f"(host clock)")

    # ---- (b) four ranks on the card over gloo ----
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(cfg=cfg.to_dict(), cb=cb.to_dict(), batches=[tuple(t.cpu() for t in b) for b in batches]),
                   Path(tmp) / "inputs.pt")
        torch.save([(w, p) for w, p in refs], Path(tmp) / "refs.pt")
        del refs, single
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            outs = run_ranks([sys.executable, str(ROOT / "chip_smoke.py"), "--mesh-rank", tmp], MESH_RANKS,
                             timeout=300, cwd=str(ROOT))
        except RuntimeError as e:
            raise Failed(f"phase 9 (b): {e}")
        ranks_s = time.perf_counter() - t0
    lines = [json.loads(x) for o in outs for x in o.splitlines() if x.startswith('{"mesh"')]
    meshes = {}
    for name, space, ingest in MESH_SHAPES:
        per = sorted((x for x in lines if x["mesh"] == name), key=lambda x: x["rank"])
        check(len(per) == MESH_RANKS, f"mesh {name}: {len(per)} ranks reported")
        for x in per:
            own = ("merge_batch",) + tuple(TAIL_HOSTS) + (
                ("ray_pass_counts_slab", "bin_points_slab", "moments_epilogue_slab") if ingest == "slab" and space > 1
                else ())
            for k in own:
                check(x["launches"].get(k, 0) == 2, f"mesh {name} rank {x['rank']}: {k} launched "
                                                     f"{x['launches'].get(k, 0)} times in two steps")
        meshes[name] = per
        log(f"phase 9 (b) mesh {name} ({MESH_RANKS} ranks on one card, gloo): bitwise the one-rank step, "
            f"moments max abs err {per[0]['max_abs_err']}; step ms per rank (host clock) "
            f"{[round(x['step_ms'][1], 2) for x in per]}; max_memory_allocated per rank "
            f"{[x['max_memory_allocated'] for x in per]}, of it the steps' own "
            f"{[x['peak_step_bytes'] for x in per]} (one rank: {res['one_rank']['max_memory_allocated']}, "
            f"{res['one_rank']['peak_step_bytes']}); slab launches "
            f"per rank {[[x['launches'].get(k, 0) for k in ('ray_pass_counts_slab', 'bin_points_slab', 'moments_epilogue_slab')] for x in per]}; "
            f"bytes through the host per rank {[x['host_bytes'] for x in per]}")
    res.update(gloo_4_ranks=meshes, gloo_4_ranks_s=ranks_s)

    # ---- (c) dryrun_multichip, (d) bench --mode scaling ----
    t0 = time.perf_counter()
    res["dryrun"] = dryrun_multichip(MESH_RANKS, backend="gloo", timeout=300)
    res["dryrun_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        r = subprocess.run([sys.executable, "-m", "gvom_tpu_torch.bench", "--mode", "scaling", "--devices", "1",
                            "--steps", "4", "--repeats", "2"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    except subprocess.TimeoutExpired:
        raise Failed("bench --mode scaling: still running after 300 s")
    check(r.returncode == 0, f"bench --mode scaling: exit code {r.returncode}: {r.stderr[-3000:]}")
    line = [json.loads(x) for x in r.stdout.splitlines() if x.startswith("{")]
    check(len(line) == 1 and line[0]["devices"] == [1] and line[0]["backend"] == "nccl"
          and line[0]["scans_per_s"]["1"] > 0, f"bench --mode scaling: {r.stdout[-2000:]}")
    print(json.dumps(line[0]), flush=True)
    res.update(bench_scaling=line[0], bench_scaling_s=time.perf_counter() - t0, phase_s=time.perf_counter() - t_phase)
    log(f"phase 9 (c) {res['dryrun']} ({res['dryrun_s']:.1f} s); (d) bench --mode scaling --devices 1: "
        f"{line[0]['scans_per_s']['1']} scans/s ({res['bench_scaling_s']:.1f} s); phase 9 took {res['phase_s']:.1f} s")
    return res



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
        # float64 work: the kernels whose name (PyTorch's templates) names double
        f64 = [ev for ev in kern if "double" in ev.name]
        f64_us = sum(ev.time_range.elapsed_us() for ev in f64)
        by_name = {}
        for ev in kern:
            by_name.setdefault(ev.name, [0, 0.0])
            by_name[ev.name][0] += 1
            by_name[ev.name][1] += ev.time_range.elapsed_us()
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        out[name] = dict(wall_us=wall_us, device_us=dev_us, launches=len(kern), busy_share=dev_us / wall_us,
                         f64_us=f64_us, f64_launches=len(f64),
                         top=[dict(kernel=k[:120], count=c, device_us=t) for k, (c, t) in top])
        log(f"profile {name}: host span {wall_us:.1f} us, device busy {dev_us:.1f} us "
            f"({100 * dev_us / wall_us:.1f} %), {len(kern)} kernel launches, float64 {f64_us:.1f} us in "
            f"{len(f64)}; top by device time:")
        for k, (c, t) in top[:8]:
            log(f"    {t:10.1f} us  x{c:<5d} {k[:100]}")
    return out


def profile_node(cfg, scans, log):
    """torch.profiler over one warm tick of the node on the card (ingest a
    scan, publish the maps, publish the debug clouds, the card synchronized
    after each): the device time of each region that
    utils.profiling.annotate marks (gvom/ingest, gvom/combine, gvom/export;
    not the combine's sync and copy inside it)
    and of the whole tick. A kernel belongs to the region whose host range
    began last before it started: the synchronizations keep each region's
    kernels after its start and before the next's. (The profiler ties the
    kernels launched through ctypes to no region of its own.)"""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile

    from gvom_tpu_torch import VoxelMapperNode

    node = VoxelMapperNode(config=cfg)
    pad, mask, ego = scans[0]

    def tick():
        node.on_odometry(ego)
        for step in (lambda: node.on_pointcloud(pad[mask]), node.publish_maps, node.publish_debug):
            step()
            torch.cuda.synchronize()

    tick()
    tick()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tick()
        wall_us = 1e6 * (time.perf_counter() - t0)
    events = prof.events()
    marks = sorted((ev.time_range.start, ev.name) for ev in events
                   if ev.name.startswith("gvom/") and ev.name.count("/") == 1
                   and ev.device_type == torch.autograd.DeviceType.CPU)
    starts = [t for t, _ in marks]
    regions, dev_us = {}, 0.0
    for ev in events:
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name.startswith("gvom/"):
            continue   # host events, and the profiler's own spans of the regions on the device
        i = bisect.bisect_right(starts, ev.time_range.start) - 1
        name = marks[i][1] if i >= 0 else "before the first region"
        regions[name] = regions.get(name, 0.0) + ev.time_range.elapsed_us()
        dev_us += ev.time_range.elapsed_us()
    out = dict(wall_us=wall_us, device_us=dev_us, regions_device_us=regions)
    log(f"profile node tick (synchronized after each step): host span {wall_us:.1f} us, device busy {dev_us:.1f} us "
        f"({100 * dev_us / wall_us:.1f} %); by region (device us): "
        + ", ".join(f"{k} {v:.1f}" for k, v in sorted(regions.items())))
    return out


def phase_profile(cfg, scans, dev, log):
    """torch.profiler over one warm ingest_and_insert and one warm combine,
    and one tick of the node by region."""
    from gvom_tpu_torch.models import pipeline
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

    buf, world = empty_buffer_state(cfg, dev), empty_world_state(cfg, dev)
    p, v, e = scan_tensors(scans[0], dev)
    out = profile_calls(dict(ingest=lambda: pipeline.ingest_and_insert(cfg, buf, p, v, e),
                             combine=lambda: pipeline.combine(cfg, buf, world, e)), log)
    out["node"] = profile_node(cfg, scans, log)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every number to this JSON file")
    ap.add_argument("--scans", type=int, default=8, help="scans of the facade drive (default 8)")
    ap.add_argument("--profile", action="store_true",
                    help="also trace one ingest and one combine on the pipeline and one tick of the node with "
                         "torch.profiler (a batched step and a process_pointcloud are traced in every run)")
    ap.add_argument("--mesh-rank", help=argparse.SUPPRESS)   # a phase-9 rank: the directory of its inputs
    args, extra = ap.parse_known_args(argv)
    if extra and not args.mesh_rank:
        ap.error(f"unrecognized arguments: {' '.join(extra)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; nothing was run", file=sys.stderr)
        return 2
    try:
        import gvom_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the gvom_tpu_torch package is not beside this script: {e}", file=sys.stderr)
        return 3
    # the comparisons that the port's selftest shares (MOM_RTOL, MOM_ATOL: see there), for every phase below
    global MOM_ATOL, MOM_RTOL, Failed, bitwise, check, clean_sums, close, exact, moments_close, sums_close, tol_share
    from gvom_tpu_torch.utils.compare import (MOM_ATOL, MOM_RTOL, Failed, bitwise, check, clean_sums, close, exact,
                                              moments_close, sums_close, tol_share)
    try:
        if args.mesh_rank:
            return mesh_rank(sys.argv[1:] if argv is None else argv)
        return run(args, torch)
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1


def run(args, torch) -> int:
    from gvom_tpu_torch import GvomConfig
    from gvom_tpu_torch.ops import kernels

    def log(msg):
        print(msg, flush=True)

    report = {}
    t0 = time.perf_counter()
    probe = kernels.CudaKernel("atomic_rate", "atomic_rate.cu", "gvom_atomic_rate",
                               [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p],
                               "not a TPU kernel: a probe of the card's atomic rate")
    probe_build = probe.start_build()
    # K4 for the ring buffers of entry() (2), of the bench's async mode (8), of
    # phase 1's other depths (7, 16) and of the configuration sweep, so that no
    # timed or checked call waits for nvcc
    b0 = GvomConfig().buffer_size
    depths = [kernels.CMB.start_build((f"-DGVOM_COMBINE_B={b}",)) for b in sorted(
        {2, 7, 8, 16} | {f.get("buffer_size", b0) for _, f in SWEEP_CONFIGS.values()} - {b0})]
    reports = kernels.build_all()
    reports[probe.name] = probe.finish_build(probe_build)
    for proc in depths:
        kernels.CMB.finish_build(proc)
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

    prep = phase1_prepare(cfg, scans, dev, log)
    phase1_knife_edges(dev, log)
    err, buf, world, last = phase1_kernels_vs_plain(cfg, scans[:4], dev, log)
    phase1_combine_other_b(dev, log)
    slab_launches, slab = phase1_slabs(cfg, scans[0], dev, log, err)
    phase1_near_tier(cfg, scans[1], dev, log)
    report["epilogue_radii"] = phase1_epilogue_radii(cfg, scans[0], dev, log, err)
    report["epilogue_radii"]["direct_past_passes"] = direct = phase1_epilogue_direct_wide(cfg, dev, log)
    report["wide_forms"] = dict(phase1_merge_tall(cfg, dev, log), **phase1_wide_configs(cfg, scans, dev, log))
    report["large_grid"] = phase1_large(dev, log, err)
    report["config_sweep"] = phase1_config_sweep(cfg, scans, dev, log, err)
    launches, report["facade"], _ = phase2_facade(cfg, scans, log)
    phase3_small_reference(cfg, scans, log)
    rates = atomic_rates(probe, dev, log)
    rows, report["inputs"] = phase4_timings(cfg, buf, world, last, slab, prep, rates, dev, log)
    del buf, world, last, slab, prep
    report["end_to_end"] = phase_end_to_end(cfg, scans, dev, log)
    batched_launches, (k5_row, merge_row), report["batched"] = phase5_batched(cfg, scans, rates, dev, log, err)
    report["batched"]["ray_pass_counts_lap"] = phase5_raycast_lap(rows, rates, dev, log)
    phase6_replay(log)
    node_launches, report["host_path"] = phase7_host_path(cfg, scans, log)
    report["bench"] = phase8_bench_and_entry(log)
    report["mesh"] = phase9_mesh(cfg, scans, dev, log)
    if args.profile:
        report["profile"] = phase_profile(cfg, scans, dev, log)

    # each kernel's launches on the path that is its own: the facade's for
    # K1-K4 and the 2-D stencils (the maps' tail is in theirs: "includes"),
    # the batched step's for K5 and the merge, ingest_scan(y_window=)'s for
    # the slabs. The plane fit's tail alone is off every path: its sweep and
    # timing are in the report, not the line
    rows += [k5_row, merge_row]
    order = [k.name for k in kernels.KERNELS]
    rows.sort(key=lambda r: order.index(r["name"]))
    mesh_kernels = ("ray_pass_counts_slab", "bin_points_slab", "moments_epilogue_slab", "merge_batch") + tuple(
        TAIL_HOSTS)
    for r in rows:
        own = (slab_launches if r["name"].endswith("_slab") else
               batched_launches if r["name"] in ("moments_epilogue", "merge_batch") else launches)
        r["launches"] = own[r["name"]]
        r["launches_batched_path"] = batched_launches[r["name"]]
        r["launches_slab_path"] = slab_launches[r["name"]]
        r["launches_node_path"] = node_launches[r["name"]]
        if r["name"] in mesh_kernels:
            r["launches_mesh_path"] = [x["launches"].get(r["name"], 0) for x in report["mesh"]["gloo_4_ranks"]["(1, 4) slab"]]
        r["max_abs_err"] = err[r["name"]]
        if r["name"] in direct["launches"]:
            # the direct form past the passes' tile (phase 1): its own launches, times and errors
            forms = direct["K5" if r["name"] == "moments_epilogue" else "K3"]
            keep = ("ms", "bound_ms", "max_abs_err", "max_rel_err")
            r["direct_past_passes"] = dict(eigen=direct["eigen"], grid=direct["grid"],
                                           launches=direct["launches"][r["name"]],
                                           **{k: {q: v[q] for q in keep if q in v} for k, v in forms.items()})
        check(r["launches"] > 0, f"kernel {r['name']} was launched no time on its path")
        if r["name"] in FACADE_KERNELS:
            check(r["launches_node_path"] > 0, f"kernel {r['name']} was launched no time on the node's path")
    check([r["name"] for r in rows] == [k.name for k in kernels.KERNELS if k is not kernels.PLANEFIT_TAIL],
          "the kernels line misses a kernel")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms")
    line = {"kernels": [{k: r[k] for k in keys + ("includes", "atomic_floor_ms", "wrapper_ms", "launches_node_path",
                                                 "launches_mesh_path", "direct_past_passes") if k in r}
                        for r in rows]}
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
    sys.exit(main())
