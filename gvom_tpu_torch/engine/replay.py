"""Scan-log replay.

Two modes (counterparts of gvom_tpu/engine/replay.py):
  * sequential_replay: feeds a log through the facade exactly like the live
    node (parity runs, latency measurement).
  * batched_replay: stacks (scan, pose) pairs and runs the batched step
    (parallel/sharding.py), one world snapshot per batch, on one device or
    over a (data, space) mesh of ranks.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.engine.gvom import Gvom
from gvom_tpu_torch.io.logio import ScanLog
from gvom_tpu_torch.io.synthetic import pad_scan
from gvom_tpu_torch.parallel.sharding import make_batched_step, shard_batch, shard_world
from gvom_tpu_torch.types import empty_world_state, resolve_device
from gvom_tpu_torch.utils.checkpoint import load_world, save_world
from gvom_tpu_torch.utils.metrics import StepMetrics

__all__ = ["sequential_replay", "batched_replay", "batched_ray_steps"]


def sequential_replay(cfg: GvomConfig, log: ScanLog, combine_every: int = 1,
                      device="cuda") -> Tuple[Gvom, List, StepMetrics]:
    """Feed the log through the facade: one process_pointcloud per scan, one
    combine_maps every `combine_every` scans. Returns (engine, the combines'
    outputs, metrics). The times are host-clock times of the calls;
    process_pointcloud does not wait for the device."""
    engine = Gvom(config=cfg, device=device)
    metrics = StepMetrics()
    outputs = []
    for i, (points, ego, transform) in enumerate(log):
        t0 = time.perf_counter()
        engine.process_pointcloud(points, ego, transform)
        metrics.record("ingest_s", time.perf_counter() - t0)
        metrics.bump("scans")
        if (i + 1) % combine_every == 0:
            t0 = time.perf_counter()
            out = engine.combine_maps()
            metrics.record("combine_s", time.perf_counter() - t0)
            metrics.bump("combines")
            outputs.append(out)
    return engine, outputs, metrics


def batched_ray_steps(cfg: GvomConfig, egos: np.ndarray, batch_size: int) -> int:
    """The static DDA budget of a batched replay. Each batch rasterizes at
    its LAST scan's origin, so the budget needs only the centered bound plus
    the worst in-batch ego drift (in voxels), far below the any-in-grid
    bound the batched step would otherwise assume. egos [n, 3] are the
    log's, in order."""
    res = np.array([cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution])
    egos = np.asarray(egos, np.float64)
    drift = 0.0
    for b0 in range(0, len(egos), batch_size):
        eb = egos[b0:b0 + batch_size]
        drift = max(drift, float((np.abs(eb - eb[-1]) / res).max()))
    size = max(cfg.xy_size, cfg.z_size)
    return min(size // 2 + 6 + int(np.ceil(drift)), size + 4)


def batched_replay(
    cfg: GvomConfig,
    log: ScanLog,
    batch_size: int,
    device="cuda",
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume_from: Optional[str] = None,
    skip_batches: int = 0,
    heartbeat: Optional[object] = None,
    mesh=None,
):
    """Run the log through the batched step, `batch_size` scans per step.
    Returns (final world, list of per-batch MapProducts, metrics).

    With `checkpoint_dir` and `checkpoint_every=k`, the world is snapshotted
    every k batches (crash recovery for long replays); `resume_from` starts
    from a prior snapshot instead of an empty world, and `skip_batches`
    skips the log batches already fused into it. The returned products list
    covers only the batches fused in THIS call: on resume its first entry is
    global batch `skip_batches + 1` (skipped batches get no placeholder).
    `heartbeat`, if given, is any object with `.beat()`, beaten once per
    fused batch, after its checkpoint (liveness = durable forward progress).
    A scan's transform is applied on the host, before the scan is padded.

    With a mesh (parallel/mesh.py), every rank of it calls batched_replay
    with the same log and arguments. Each batch is padded with dead scans
    to a multiple of the mesh size, as the JAX package's replay pads it, and
    each rank steps its shard (sharding.shard_batch) on its world slab; the
    returned world is this rank's slab, the products are whole, and the
    scan count counts real scans only. Checkpoints hold the whole world."""
    dev = resolve_device(device) if mesh is None else mesh.device
    if cfg.ray_steps_override is None:
        egos = np.stack([np.asarray(e, np.float64) for _, e, _ in log])
        cfg = dataclasses.replace(cfg, ray_steps_override=batched_ray_steps(cfg, egos, batch_size))
    step = make_batched_step(cfg, dev, mesh=mesh)
    if resume_from is not None:
        world = load_world(resume_from, dev, mesh=mesh)
    else:
        world = empty_world_state(cfg, dev)
        world = world if mesh is None else shard_world(world, mesh)
    metrics = StepMetrics()
    products_list = []
    batch: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
    b_idx = 0  # global batch number, counting skipped ones: checkpoint names
    # continue the numbering of the run that was interrupted

    def flush():
        nonlocal world, b_idx
        if not batch:
            return
        b_idx += 1
        if b_idx <= skip_batches:
            metrics.bump("skipped_batches")
            batch.clear()
            return
        n_real = len(batch)
        if mesh is not None:
            pts0, mask0, ego_last = batch[-1]
            batch.extend([(np.zeros_like(pts0), np.zeros_like(mask0), ego_last)] * (-n_real % mesh.size))
        t0 = time.perf_counter()
        pts, mask, ego = (torch.from_numpy(np.stack(a)).to(dev) for a in zip(*batch))
        if mesh is not None:
            pts, mask, ego = shard_batch(pts, mask, ego, mesh)
        world, products = step(world, pts, mask, ego)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        metrics.record("batch_s", time.perf_counter() - t0)
        metrics.bump("scans", n_real)
        metrics.bump("batches")
        products_list.append(products)
        if checkpoint_dir and checkpoint_every > 0 and b_idx % checkpoint_every == 0:
            save_world(os.path.join(checkpoint_dir, f"world_b{b_idx}"), world, cfg, mesh=mesh)
            metrics.bump("checkpoints")
        if heartbeat is not None:
            heartbeat.beat()
        batch.clear()

    for points, ego, transform in log:
        if transform is not None:
            tf = np.asarray(transform)
            points = np.asarray(points) @ tf[:3, :3].T + tf[:3, 3]
        pts, mask = pad_scan(np.asarray(points), cfg.max_points)
        batch.append((pts, mask, np.asarray(ego, np.float32)))
        if len(batch) >= batch_size:
            flush()
    flush()
    return world, products_list, metrics
