"""Benchmark of the port: sustained end-to-end mapping throughput on one GPU.

    python -m gvom_tpu_torch.bench [--mode perscan|combine|async|batched|scaling] [--steps 64] [--repeats 3]
                                   [--device cuda|cpu] [--devices 1,2,4] [--processes N --backend gloo]

The counterpart of the JAX package's bench.py, with its modes, flags, metric
names and JSON fields. Each step of the default mode is the full reference
workload: one OS1-128-density scan ingested (ingest_and_insert: transform,
voxelize, raycast, moments) and a combine (buffer fusion, previous-map decay
and every 2D map product), at the reference's published grid (256×256×64 at
0.4 m, a buffer of 4). vs_baseline divides by 10.5 Hz, the middle of the
upstream G-VOM's 9-12 Hz on its GPU (a Quadro RTX 4000).

  * perscan (default): two lines, the strict form (a combine every scan,
    K = 1, metric suffix `_strict`) and then the contract form (a combine
    every K = 8 scans, the reference's async 10 Hz timer), which is the last
    line. --combine-every K prints one line for that K. --pipelined combines
    the buffer as it stood before this scan's insert (the products lag one
    scan), on the same CUDA stream.
  * combine: combine alone, on a buffer filled with real scans; each step's
    world gets a data-dependent +1 on its hit counts, so that every step
    depends on the one before.
  * async: two sensor threads ingest into the Gvom facade's ring buffer of
    8 at 20 Hz each while the main thread combines back to back.
  * batched: 32 (scan, ego) pairs a step through make_batched_step, one
    combine a step, the egos advancing every step.
  * scaling: the weak-scaling efficiency of the batched step over a
    (data, space) mesh of ranks (parallel/mesh.py): --batch scans per rank
    a step while the rank count grows over --devices (default 1, 2, 4, ...
    up to the cards), one rank per card over NCCL, each count a set of
    processes; value = throughput(n) / (n × throughput(1)). Counts beyond
    the cards are refused. --processes N --backend gloo instead times the
    same global batch on one rank and on N ranks over gloo (on the CPU, or
    sharing one card): value = time(1) / time(N).

Four distinct scans are staged first (host-side input preparation, not
timed). A first, untimed call of each timed function builds the CUDA
kernels; each timed region ends in torch.cuda.synchronize(), and the best
of --repeats is reported. --device cpu runs the plain PyTorch versions on
the CPU (`raycast` / `impl` then read "plain"); without a GPU and without
--device cpu the bench exits 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.io import synthetic
from gvom_tpu_torch.models import pipeline
from gvom_tpu_torch.ops import kernels
from gvom_tpu_torch.types import empty_buffer_state, empty_world_state, resolve_device

BASELINE_HZ = 10.5   # the upstream G-VOM's 9-12 Hz midpoint (its README)
N_DISTINCT = 4


def _positive_int(v):
    iv = int(v)
    if iv <= 0:
        raise argparse.ArgumentTypeError("must be a positive integer")
    return iv


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m gvom_tpu_torch.bench", description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=_positive_int, default=64, help="steps per timed run")
    ap.add_argument("--mode", default="perscan",
                    choices=["perscan", "batched", "combine", "async", "scaling", "scaling-worker"])
    ap.add_argument("--batch", type=_positive_int, default=32,
                    help="scans per step in batched mode; per rank in scaling mode")
    ap.add_argument("--devices", default=None,
                    help="scaling mode: comma-separated rank counts, one card each (default: 1,2,...,all cards)")
    ap.add_argument("--processes", type=_positive_int, default=1,
                    help="scaling mode: the same global batch on 1 rank vs N ranks, over --backend gloo")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="scaling mode: the ranks' process-group backend (default: NCCL, one card a rank)")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--coordinator", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--pipelined", action="store_true",
                    help="perscan: combine the buffer as it stood before this scan's insert (products lag a scan)")
    ap.add_argument("--combine-every", type=_positive_int, default=None,
                    help="perscan: combine once per K scans and print that one line (default: K = 1, then 8)")
    ap.add_argument("--repeats", type=_positive_int, default=3)
    ap.add_argument("--xy-size", type=int, default=256)
    ap.add_argument("--z-size", type=int, default=64)
    ap.add_argument("--points", type=int, default=131072, help="OS1-128 density")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    ap.add_argument("--verbose", action="store_true")
    return ap


def _drive(ego: np.ndarray, n: int) -> list:
    """n egos, each 0.45 / 0.25 / 0.01 m past the one before (the first past ego)."""
    out = []
    for _ in range(n):
        ego = ego + np.array([0.45, 0.25, 0.01])
        out.append(ego)
    return out


class _Bench:
    """The staged inputs and the device of one bench run."""

    def __init__(self, args, dev: torch.device):
        self.args = args
        self.dev = dev
        self.cfg = GvomConfig(xy_size=args.xy_size, z_size=args.z_size, max_points=args.points, buffer_size=4)
        self.cuda = dev.type == "cuda"
        self.impl = "cuda" if self.cuda else "plain"
        self.device_name = torch.cuda.get_device_name(dev) if self.cuda else "cpu"
        self.terrain = synthetic.composite_terrain()
        egos = _drive(np.array([0.5, 0.0, 1.6]), N_DISTINCT)
        padded = [synthetic.pad_scan(pts, self.cfg.max_points) for pts in self.scans_at(egos, range(N_DISTINCT))]
        self.scans = torch.from_numpy(np.stack([p for p, _ in padded])).to(dev)
        self.masks = torch.from_numpy(np.stack([m for _, m in padded])).to(dev)
        self.egos = torch.from_numpy(np.stack(egos).astype(np.float32)).to(dev)
        if args.verbose:
            print(f"[bench] staged {N_DISTINCT} scans, {int(self.masks[0].sum())} real points each", file=sys.stderr)

    def scans_at(self, egos, seeds):
        """One synthetic scan at each (ego, seed), made in threads (numpy
        leaves the interpreter lock in its array work)."""
        def scan(job):
            return synthetic.simulate_lidar_scan(self.terrain, job[0], channels=128, azimuth_steps=1200,
                                                 max_range=60.0, seed=job[1], coarse_step=0.5, refine_iters=12)

        with ThreadPoolExecutor(max_workers=len(egos)) as ex:
            return list(ex.map(scan, zip(egos, seeds)))

    def sync(self):
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def best_of(self, run, fresh):
        """Best wall time of --repeats calls of run(*fresh()), after one
        untimed call (the kernels' build); fresh() makes the inputs."""
        run(*fresh())
        self.sync()
        times = []
        for _ in range(self.args.repeats):
            inputs = fresh()
            self.sync()
            t0 = time.perf_counter()
            run(*inputs)
            self.sync()
            times.append(time.perf_counter() - t0)
        return min(times)


def _probe(products) -> torch.Tensor:
    """A checksum of every map product, on the device."""
    return torch.stack([getattr(products, f.name).sum().float() for f in dataclasses.fields(products)]).sum()


def run_perscan(b: _Bench, K: int) -> dict:
    args, cfg = b.args, b.cfg

    def run(buf, world):
        for i in range(args.steps):
            j = i % N_DISTINCT
            if args.pipelined:
                if i % K == 0:
                    world, _, _ = pipeline.combine(cfg, buf, world, b.egos[j])
                buf, _ = pipeline.ingest_and_insert(cfg, buf, b.scans[j], b.masks[j], b.egos[j])
            else:
                buf, _ = pipeline.ingest_and_insert(cfg, buf, b.scans[j], b.masks[j], b.egos[j])
                if (i + 1) % K == 0:
                    world, _, _ = pipeline.combine(cfg, buf, world, b.egos[j])
        return buf, world

    # the buffer is written in place: every run starts from an empty one
    best = b.best_of(run, lambda: (empty_buffer_state(cfg, b.dev), empty_world_state(cfg, b.dev)))
    scans_per_s = args.steps / best
    result = {
        "metric": f"e2e_scan+combine_throughput_1chip_{args.points}pts_{args.xy_size}x{args.xy_size}x{args.z_size}",
        "value": round(scans_per_s, 2),
        "unit": "scans/s",
        "vs_baseline": round(scans_per_s / BASELINE_HZ, 2),
        "steps": args.steps,
        "best_s": round(best, 4),
        "per_step_ms": round(best / args.steps * 1e3, 2),
        "raycast": b.impl,
        "pipelined": bool(args.pipelined),
        "device": b.device_name,
    }
    if K > 1:
        result["combine_every"] = K
        result["combine_hz"] = round(scans_per_s / K, 2)
    return result


def run_combine(b: _Bench) -> dict:
    args, cfg = b.args, b.cfg
    buf = empty_buffer_state(cfg, b.dev)
    for i in range(cfg.buffer_size):
        buf, _ = pipeline.ingest_and_insert(cfg, buf, b.scans[i % N_DISTINCT], b.masks[i % N_DISTINCT],
                                            b.egos[i % N_DISTINCT])
    ego = b.egos[(cfg.buffer_size - 1) % N_DISTINCT]

    def run(world):
        for _ in range(args.steps):
            world, products, _ = pipeline.combine(cfg, buf, world, ego)
            bump = (_probe(products) > -1.0).to(torch.int32)   # always 1, but data-dependent
            world = dataclasses.replace(world, grid=dataclasses.replace(world.grid, hit=world.grid.hit + bump))
        return world

    best = b.best_of(run, lambda: (empty_world_state(cfg, b.dev),))
    hz = args.steps / best
    return {
        "metric": f"combine_maps_rate_1chip_{args.xy_size}x{args.xy_size}x{args.z_size}_buffer4",
        "value": round(hz, 2),
        "unit": "Hz",
        "vs_baseline": round(hz / BASELINE_HZ, 2),
        "steps": args.steps,
        "best_s": round(best, 4),
        "per_combine_ms": round(best / args.steps * 1e3, 3),
        "impl": b.impl,
        "device": b.device_name,
    }


def run_async(b: _Bench) -> dict:
    from gvom_tpu_torch.engine.gvom import Gvom

    args = b.args
    cfg = dataclasses.replace(b.cfg, buffer_size=8)
    engine = Gvom(config=cfg, device=b.dev)     # builds K4's library for B = 8 on the card
    n_per = 3
    # two sensors half a metre apart, three distinct scans each
    egos = [e for s in range(2) for e in _drive(np.array([0.5 + 0.5 * s, 0.3 * s, 1.6]), n_per)]
    pts = b.scans_at(egos, [10 * s + i for s in range(2) for i in range(n_per)])
    sensor_scans = [list(zip(pts[s * n_per:(s + 1) * n_per], egos[s * n_per:(s + 1) * n_per])) for s in range(2)]

    engine.process_pointcloud(*sensor_scans[0][0])
    engine.combine_maps()
    b.sync()

    stop = threading.Event()
    counts = [0, 0]
    errors = []

    def producer(s):
        # a real sensor's rate, each scan synced as the reference copies a
        # cell count back per scan; an unpaced loop would flood the stream
        period = 1.0 / 20.0
        nxt = time.monotonic()
        i = 0
        try:
            while not stop.is_set():
                pts, ego = sensor_scans[s][i % n_per]
                ok = engine.process_pointcloud(pts, ego)
                if ok is not None:
                    bool(ok)
                counts[s] += 1
                i += 1
                nxt += period
                delay = nxt - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
                else:
                    nxt = time.monotonic()
        except BaseException as e:   # reported after the run
            errors.append(e)

    threads = [threading.Thread(target=producer, args=(s,), daemon=True) for s in range(2)]
    for t in threads:
        t.start()
    time.sleep(0.2)   # let the producers fill the buffer
    best = scans_in_window = None
    out = None
    try:
        for _ in range(args.repeats):
            c0 = sum(counts)
            t0 = time.perf_counter()
            for _ in range(args.steps):
                out = engine.combine_maps()
            b.sync()
            dt = time.perf_counter() - t0
            if best is None or dt < best:
                best, scans_in_window = dt, sum(counts) - c0
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=10)
    if errors:
        raise errors[0]
    if out is None:
        raise RuntimeError("async bench: combine_maps returned no maps")
    hz = args.steps / best
    return {
        "metric": f"async_combine_rate_2sensors_buffer8_{args.xy_size}x{args.xy_size}x{args.z_size}",
        "value": round(hz, 2),
        "unit": "Hz",
        "vs_baseline": round(hz / BASELINE_HZ, 2),
        "steps": args.steps,
        "best_s": round(best, 4),
        "ingest_scans_per_s": round(scans_in_window / best, 2),
        "device": b.device_name,
    }


def batched_ray_budget(cfg: GvomConfig, batch: int) -> GvomConfig:
    """The DDA budget of the batched mode: the centered bound plus the
    largest in-batch ego drift, (batch − 1)·0.02 m (the egos advance
    0.02 / 0.01 m a scan within a batch)."""
    if cfg.ray_steps_override is not None:
        return cfg
    drift_vox = (batch - 1) * 0.02 / min(cfg.xy_resolution, cfg.z_resolution)
    return dataclasses.replace(cfg, ray_steps_override=min(
        max(cfg.xy_size, cfg.z_size) // 2 + 6 + int(math.ceil(drift_vox)), max(cfg.xy_size, cfg.z_size) + 4))


def run_batched(b: _Bench) -> dict:
    from gvom_tpu_torch.parallel.sharding import make_batched_step

    args = b.args
    B = args.batch
    cfg = batched_ray_budget(b.cfg, B)
    bstep = make_batched_step(cfg, b.dev)
    reps = torch.arange(B, device=b.dev) % N_DISTINCT
    bscans, bmasks, begos_base = b.scans[reps], b.masks[reps], b.egos[reps]
    drift = torch.arange(B, dtype=torch.float32, device=b.dev)[:, None] * torch.tensor(
        [0.02, 0.01, 0.0], dtype=torch.float32, device=b.dev)
    advance = torch.tensor([0.3, 0.15, 0.0], dtype=torch.float32, device=b.dev)

    def run(world, ego0):
        for _ in range(args.steps):
            # the egos advance every step, so the origin moves; a scan's points
            # move rigidly with its ego, as a replayed log's are captured there
            begos = ego0[None, :] + drift
            world, _ = bstep(world, bscans + (begos - begos_base)[:, None, :], bmasks, begos)
            ego0 = ego0 + advance
        return world

    best = b.best_of(run, lambda: (empty_world_state(cfg, b.dev), b.egos[0]))
    total_scans = B * args.steps
    scans_per_s = total_scans / best
    return {
        "metric": f"batched_replay_throughput_1chip_{args.points}pts_{args.xy_size}x{args.xy_size}x{args.z_size}",
        "value": round(scans_per_s, 2),
        "unit": "scans/s",
        "vs_baseline": round(scans_per_s / BASELINE_HZ, 2),
        "batch": B,
        "steps": args.steps,
        "best_s": round(best, 4),
        "per_scan_ms": round(best / total_scans * 1e3, 3),
        "raycast": b.impl,
        "device": b.device_name,
    }


def run_scaling_worker(args) -> dict:
    """One rank of a scaling run: --batch scans a step on this rank, the
    world in slabs over the default mesh, --steps steps as the batched mode
    runs them, best of --repeats; rank 0's line has the times."""
    from gvom_tpu_torch.parallel.mesh import init_distributed, make_mesh, shutdown
    from gvom_tpu_torch.parallel.sharding import make_batched_step, shard_batch, shard_world

    init_distributed(args.coordinator, args.world, args.rank, backend=args.backend, device=args.device)
    mesh = make_mesh(device=args.device)
    b = _Bench(args, mesh.device)
    B = args.batch * mesh.size
    cfg = batched_ray_budget(b.cfg, B)
    bstep = make_batched_step(cfg, mesh.device, mesh=mesh)
    everyone = torch.arange(B, device=b.dev)
    mine = shard_batch(everyone, everyone, everyone, mesh)[0]          # this rank's scans of the batch
    reps = mine % N_DISTINCT
    bscans, bmasks, begos_base = b.scans[reps], b.masks[reps], b.egos[reps]
    drift = mine.float()[:, None] * torch.tensor([0.02, 0.01, 0.0], dtype=torch.float32, device=b.dev)
    advance = torch.tensor([0.3, 0.15, 0.0], dtype=torch.float32, device=b.dev)

    def run():
        world, ego0 = shard_world(empty_world_state(cfg, b.dev), mesh), b.egos[0]
        mesh.barrier()
        b.sync()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            begos = ego0[None, :] + drift
            world, _ = bstep(world, bscans + (begos - begos_base)[:, None, :], bmasks, begos)
            ego0 = ego0 + advance
        b.sync()
        return time.perf_counter() - t0

    run()          # the first call builds the kernels and warms the allocator
    best = min(run() for _ in range(args.repeats))
    shutdown()
    return {"worker_best_s": best, "batch_total": B, "steps": args.steps, "rank": mesh.rank, "mesh": mesh.shape,
            "host_bytes": mesh.host_bytes, "device": b.device_name}


def _launch_scaling(args, ranks: int, batch: int, backend: str) -> dict:
    """Rank 0's line of a scaling run on `ranks` ranks of `batch` scans each."""
    from pathlib import Path

    from gvom_tpu_torch.parallel.mesh import run_ranks

    argv = [sys.executable, "-m", "gvom_tpu_torch.bench", "--mode", "scaling-worker", "--backend", backend,
            "--device", args.device, "--batch", str(batch), "--steps", str(args.steps),
            "--repeats", str(args.repeats), "--xy-size", str(args.xy_size), "--z-size", str(args.z_size),
            "--points", str(args.points)]
    outs = run_ranks(argv, ranks, timeout=3600, cwd=str(Path(__file__).resolve().parent.parent))
    for line in outs[0].splitlines():
        if line.startswith("{"):
            return json.loads(line)
    raise RuntimeError(f"bench: the scaling worker printed no JSON line:\n{outs[0][-3000:]}")


def scaling_plan(args):
    """(rank counts, backend) of a scaling run, or a ValueError or
    RuntimeError that refuses it: counts beyond the cards, NCCL without a
    card a rank (resolve_backend), --processes without --backend gloo."""
    from gvom_tpu_torch.parallel.mesh import resolve_backend

    if args.processes > 1:
        if args.backend != "gloo":
            raise ValueError("--processes N runs its ranks over gloo: pass --backend gloo")
        return [1, args.processes], resolve_backend(args.processes, args.device, "gloo")
    visible = torch.cuda.device_count() if args.device == "cuda" else (os.cpu_count() or 1)
    if args.devices:
        counts = [int(c) for c in args.devices.split(",")]
        bad = [c for c in counts if c > visible or c < 1]
        if bad:
            raise ValueError(f"--devices {bad} exceed the {visible} visible device(s); use --processes N "
                             f"--backend gloo to run N ranks on one card")
    else:
        counts = [1 << k for k in range(visible.bit_length()) if 1 << k <= visible]
        if counts[-1] != visible:
            counts.append(visible)
    return counts, resolve_backend(max(counts), args.device, args.backend)


def run_scaling(args, counts, backend) -> dict:
    """The weak-scaling line (the JAX package's bench.py --mode scaling)."""
    per_count, lines = {}, {}
    for n in counts:
        lines[n] = _launch_scaling(args, n, args.batch, backend)
        per_count[n] = lines[n]["batch_total"] * args.steps / lines[n]["worker_best_s"]
        if args.verbose:
            print(f"[bench] {n} ranks: {per_count[n]:.1f} scans/s", file=sys.stderr)
    n_max = counts[-1]
    eff = per_count[n_max] / (n_max * per_count[counts[0]] / counts[0])
    return {
        "metric": f"weak_scaling_efficiency_{n_max}dev_batch{args.batch}perdev",
        "value": round(eff, 3),
        "unit": "efficiency",
        "vs_baseline": round(eff / 0.8, 2),
        "scans_per_s": {str(k): round(v, 1) for k, v in per_count.items()},
        "steps": args.steps,
        "raycast": "cuda" if args.device == "cuda" else "plain",
        "devices": counts,
        "platform": args.device,
        "backend": backend,
        "device": lines[n_max]["device"],
    }


def run_scaling_dist(args) -> dict:
    """The same global batch (--batch × --processes scans) on one rank and
    on --processes ranks over gloo: the cost of crossing the process
    boundary at constant work (the JAX package's bench.py --processes)."""
    n = args.processes
    r1 = _launch_scaling(args, 1, args.batch * n, "gloo")
    rn = _launch_scaling(args, n, args.batch, "gloo")
    t1, tn = r1["worker_best_s"], rn["worker_best_s"]
    return {
        "metric": f"dist_scaling_{n}dev_{n}proc_gloo",
        "value": round(t1 / tn, 3),
        "unit": "1proc/Nproc runtime ratio (1.0 = free process boundary)",
        "vs_baseline": round((t1 / tn) / 0.8, 2),
        "best_s_1proc": round(t1, 4),
        f"best_s_{n}proc": round(tn, 4),
        "scans_per_s_1proc": round(r1["batch_total"] * args.steps / t1, 2),
        f"scans_per_s_{n}proc": round(rn["batch_total"] * args.steps / tn, 2),
        "batch_total": r1["batch_total"],
        "steps": args.steps,
        "grid": [args.xy_size, args.xy_size, args.z_size],
        "points": args.points,
        "mesh": rn["mesh"],
        "host_bytes_per_rank": rn["host_bytes"],
        "device": rn["device"],
        "note": "the same global batch both runs; N ranks over gloo share the device(s) of the one rank",
    }


def main(argv=None) -> int:
    args = _parser().parse_args(argv)
    if args.cpu:
        args.device = "cpu"
    try:
        dev = resolve_device(args.device)
        if args.mode == "scaling":
            counts, backend = scaling_plan(args)
    except (RuntimeError, ValueError) as e:
        print(f"bench: {e}", file=sys.stderr)
        return 2
    if args.mode == "scaling-worker":
        line = run_scaling_worker(args)
        if args.rank == 0:
            print(json.dumps(line))
        return 0
    if args.mode == "scaling":
        print(json.dumps(run_scaling_dist(args) if args.processes > 1 else run_scaling(args, counts, backend)))
        return 0
    b = _Bench(args, dev)
    if b.cuda:
        kernels.build_all(b.cfg)
    if args.mode == "batched":
        print(json.dumps(run_batched(b)))
    elif args.mode == "combine":
        print(json.dumps(run_combine(b)))
    elif args.mode == "async":
        print(json.dumps(run_async(b)))
    elif args.combine_every is not None:
        print(json.dumps(run_perscan(b, args.combine_every)))
    else:
        # the strict form first, the reference's contract (a combine every
        # 8 scans) last: the line a reader of the last line takes
        strict = run_perscan(b, 1)
        print(json.dumps(dict(strict, metric=strict["metric"] + "_strict")), flush=True)
        contract = run_perscan(b, 8)
        contract["strict_scans_per_s"] = strict["value"]
        print(json.dumps(contract))
    return 0


if __name__ == "__main__":
    sys.exit(main())
