"""The port's top-level entry points (the counterparts of __graft_entry__.py).

entry()              — the single-step function on a small configuration;
dryrun_multichip(n)  — n ranks on a (data, space) mesh run the batched step
                       on tiny shapes and agree with one rank.

    fn, args = entry()              # on the CUDA GPU
    fn, args = entry(device="cpu")  # the plain versions on the CPU
    positive, negative, roughness, visibility = fn(*args)

fn(buf, world, points, valid, ego) runs one pipeline.full_step (ingest one
scan into the ring buffer, then combine) on a small configuration (a
64×64×32 grid, 4,096 points, a buffer of 2) and returns four of its map
products. The example arguments are an empty buffer and world and one
synthetic scan of the composite terrain (32 × 64 beams, range 25 m). The
buffer is updated in place, so each call of fn on the same arguments ingests
the scan once more.

dryrun_multichip(n, device="cuda", backend=None) starts n ranks (processes
of `python -m gvom_tpu_torch.entry`, each bounded by a timeout) over
torch.distributed: one card each with NCCL, or several on one card with
backend="gloo", or gloo on the CPU with device="cpu". Each runs one batch of
two scans per data rank on the default mesh (parallel/mesh.factor_devices),
on the pure-space (1, n) mesh and on one rank; rank 0 checks what the JAX
package's dryrun checks (visibility, positive and negative obstacles and the
occupancy equal across the three runs, visibility not empty) and prints one
summary line, which dryrun_multichip prints and returns.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.io import synthetic
from gvom_tpu_torch.models import pipeline
from gvom_tpu_torch.parallel.mesh import init_distributed, make_mesh, rank_args, resolve_backend, run_ranks, shutdown
from gvom_tpu_torch.parallel.sharding import gather_world, make_batched_step, shard_batch, shard_world
from gvom_tpu_torch.types import empty_buffer_state, empty_world_state, resolve_device

__all__ = ["entry", "small_cfg", "dryrun_multichip"]


def small_cfg() -> GvomConfig:
    return GvomConfig(xy_size=64, z_size=32, max_points=4096, buffer_size=2)


def entry(device="cuda"):
    """(fn, example_args) on `device`; see the module docstring."""
    dev = resolve_device(device)
    cfg = small_cfg()
    ego = np.array([0.3, -0.2, 1.5], np.float32)
    pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego, channels=32, azimuth_steps=64,
                                        max_range=25.0)
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)

    def fn(buf, world, points, valid, ego_position):
        buf, world, products, ok = pipeline.full_step(cfg, buf, world, points, valid, ego_position)
        return products.positive_obstacle, products.negative_obstacle, products.roughness, products.visibility

    example_args = (
        empty_buffer_state(cfg, dev),
        empty_world_state(cfg, dev),
        torch.from_numpy(pad).to(dev),
        torch.from_numpy(mask).to(dev),
        torch.from_numpy(ego).to(dev),
    )
    return fn, example_args


def _dryrun_batch(cfg, n_scans: int):
    """The JAX package's dryrun batch: scans from egos 0.2 / 0.1 m apart."""
    scans, masks, egos = [], [], []
    ego = np.array([0.3, -0.2, 1.5])
    for _ in range(n_scans):
        ego = ego + np.array([0.2, 0.1, 0.0])
        pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego, channels=8, azimuth_steps=32,
                                            max_range=15.0)
        pad, mask = synthetic.pad_scan(pts, cfg.max_points)
        scans.append(pad)
        masks.append(mask)
        egos.append(ego.astype(np.float32))
    return tuple(torch.from_numpy(np.stack(a)) for a in (scans, masks, egos))


def _dryrun_rank(argv) -> int:
    """One rank of dryrun_multichip (the command line that it builds)."""
    rank, n, coordinator, rest = rank_args(argv)
    ap = argparse.ArgumentParser(prog="python -m gvom_tpu_torch.entry")
    ap.add_argument("--device", required=True)
    ap.add_argument("--backend", required=True)
    args = ap.parse_args(rest)
    init_distributed(coordinator, n, rank, backend=args.backend, device=args.device)
    cfg = small_cfg()
    meshes = [make_mesh(device=args.device), make_mesh(space=n, device=args.device)]
    dev = meshes[0].device
    batch = tuple(t.to(dev) for t in _dryrun_batch(cfg, 2 * meshes[0].shape[0]))
    runs = []
    for mesh in meshes:
        step = make_batched_step(cfg, dev, mesh=mesh)
        world, products = step(shard_world(empty_world_state(cfg, dev), mesh), *shard_batch(*batch, mesh))
        runs.append((gather_world(world, mesh), products))
    runs.append(make_batched_step(cfg, dev)(empty_world_state(cfg, dev), *batch))
    if rank == 0:
        for world, products in runs[:2]:
            for name in ("visibility", "positive_obstacle", "negative_obstacle"):
                if not torch.equal(getattr(products, name), getattr(runs[2][1], name)):
                    raise AssertionError(f"dryrun_multichip: {name} differs from the one-rank run")
            if not torch.equal(world.grid.hit > 0, runs[2][0].grid.hit > 0):
                raise AssertionError("dryrun_multichip: the occupancy differs from the one-rank run")
        vis = runs[0][1].visibility
        if tuple(vis.shape) != cfg.map_shape or int(vis.sum()) == 0:
            raise AssertionError("dryrun_multichip: the visibility map is empty")
        shapes = " and ".join(f"{m.shape}" for m in meshes)
        print(f"dryrun_multichip ok: meshes (data, space) {shapes} over {meshes[0].backend} on {dev.type}, "
              f"{batch[1].shape[0]} scans, {int(vis.sum())} visible cells, world slabs on {n} ranks, both mesh "
              f"shapes match the one-rank run exactly", flush=True)
    shutdown()
    return 0


def dryrun_multichip(n_devices: int, device="cuda", backend=None, timeout: float = 600.0) -> str:
    """Run n_devices ranks of the batched step on tiny shapes (the module
    docstring) and return rank 0's summary line, which is printed. Raises
    if a rank fails or the ranks are not done after `timeout` seconds."""
    backend = resolve_backend(n_devices, device, backend)
    outs = run_ranks([sys.executable, "-m", "gvom_tpu_torch.entry", "--device", str(device), "--backend", backend],
                     n_devices, timeout, cwd=str(Path(__file__).resolve().parent.parent))
    line = next((x for x in outs[0].splitlines() if x.startswith("dryrun_multichip ok")), None)
    if line is None:
        raise RuntimeError(f"dryrun_multichip: rank 0 printed no summary:\n{outs[0][-3000:]}")
    print(line)
    return line


if __name__ == "__main__":
    sys.exit(_dryrun_rank(sys.argv[1:]))
