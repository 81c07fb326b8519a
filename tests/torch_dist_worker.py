"""One rank of tests/test_torch_mesh.py's 4-rank gloo mesh on the CPU (not
collected by pytest). It imports no JAX.

    python torch_dist_worker.py OUT.npz CHECKPOINT_DIR --rank R --world 4 --coordinator HOST:PORT

Every rank runs, at GvomConfig(xy_size=32, z_size=16, max_points=1024,
buffer_size=2) with 8 scans a step (STEPS steps, the second merging a moved
live world):
  * the batched step on each mesh of MESHES, the world gathered after each
    step, with each rank's slab bytes;
  * on the (2, 2) slab mesh, a sharded save after the first step, a load and
    the second step from the loaded slabs;
  * batched_replay(mesh=) of REPLAY_SCANS scans in batches of 8 on the
    (2, 2) slab mesh (the final batch of 2 padded to 4), with a checkpoint
    after every batch.
Rank 0 writes every result to OUT.npz, keyed "<run>/<step>/<field>".
"""

import os
import sys

_HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_HERE))

import numpy as np  # noqa: E402

from gvom_tpu_torch.io import synthetic  # noqa: E402

CFG = dict(xy_size=32, z_size=16, max_points=1024, buffer_size=2)
S = 8
STEPS = 2
DEAD = (1, 5)    # (step, scan) whose mask is all False
# (name, space, ingest) on 4 ranks: data = 4 / space
MESHES = (("2x2_slab", 2, "slab"), ("1x4_slab", 4, "slab"), ("4x1_slab", 1, "slab"), ("2x2_scatter", 2, "scatter"))
REPLAY_SCANS = 10
REPLAY_BATCH = 8
PRODUCT_FIELDS = ("origin", "height", "inferred_height", "slope_x", "slope_y", "roughness",
                  "guessed_height_delta", "positive_obstacle", "negative_obstacle", "visibility")


def batch(cfg, step):
    """[S,N,3] points, [S,N] masks, [S,3] egos of one step of the drive,
    scan DEAD all masked out."""
    scans, masks, egos = [], [], []
    for i in range(S):
        k = step * S + i
        ego = np.array([0.3, -0.2, 1.5]) + k * np.array([0.15, 0.1, 0.0])
        pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego, channels=8, azimuth_steps=32,
                                            max_range=10.0, seed=k)
        pad, mask = synthetic.pad_scan(pts, cfg.max_points)
        if (step, i) == DEAD:
            mask = np.zeros_like(mask)
        scans.append(pad)
        masks.append(mask)
        egos.append(ego.astype(np.float32))
    return np.stack(scans), np.stack(masks), np.stack(egos)


def replay_log():
    from gvom_tpu_torch.io.logio import synthesize_log

    return synthesize_log(REPLAY_SCANS, channels=8, azimuth_steps=32, max_range=10.0)


def record(res: dict, key: str, world, products) -> None:
    from gvom_tpu_torch.utils import convert

    for k, v in convert.to_numpy(world).items():
        res[f"{key}/world/{k}"] = v
    for k in PRODUCT_FIELDS:
        res[f"{key}/products/{k}"] = getattr(products, k).numpy()


def slab_bytes(world) -> int:
    g = world.grid
    return sum(t.numel() * t.element_size() for t in (g.hit, g.miss, g.min_height, g.mom, world.evidence))


def main(argv) -> int:
    import torch

    from gvom_tpu_torch.config import GvomConfig
    from gvom_tpu_torch.engine.replay import batched_replay
    from gvom_tpu_torch.parallel.mesh import init_distributed, make_mesh, rank_args, shutdown
    from gvom_tpu_torch.parallel.sharding import gather_world, make_batched_step, shard_batch, shard_world
    from gvom_tpu_torch.types import empty_world_state
    from gvom_tpu_torch.utils.checkpoint import load_world, save_world

    torch.set_num_threads(1)
    rank, world_size, coordinator, (out, ckpt_dir) = rank_args(argv)
    init_distributed(coordinator, world_size, rank, device="cpu", timeout_s=120)
    cfg = GvomConfig(**CFG)
    batches = [tuple(torch.from_numpy(a) for a in batch(cfg, s)) for s in range(STEPS)]
    res = {}
    for name, space, ingest in MESHES:
        mesh = make_mesh(space=space, device="cpu")
        step = make_batched_step(cfg, "cpu", mesh=mesh, ingest=ingest)
        w = shard_world(empty_world_state(cfg, "cpu"), mesh)
        res[f"{name}/slab_bytes"] = np.array([slab_bytes(w)])
        for s, b in enumerate(batches):
            w, p = step(w, *shard_batch(*b, mesh, ingest))
            record(res, f"{name}/{s}", gather_world(w, mesh), p)
            if name == "2x2_slab" and s == 0:
                path = save_world(os.path.join(ckpt_dir, "mesh_world"), w, cfg, mesh=mesh)
                loaded = load_world(path, "cpu", mesh=mesh)
                same = all(torch.equal(a, b) for a, b in zip(
                    (w.grid.hit, w.grid.miss, w.grid.min_height, w.grid.mom, w.evidence, w.grid.origin, w.valid),
                    (loaded.grid.hit, loaded.grid.miss, loaded.grid.min_height, loaded.grid.mom, loaded.evidence,
                     loaded.grid.origin, loaded.valid)))
                res["resume/loaded_equal"] = np.array([same])
                wr, pr = step(loaded, *shard_batch(*batches[1], mesh, ingest))
                record(res, "resume/1", gather_world(wr, mesh), pr)
        res[f"{name}/host_bytes"] = np.array([mesh.host_bytes])

    mesh = make_mesh(space=2, device="cpu")
    w, prods, met = batched_replay(cfg, replay_log(), REPLAY_BATCH, device="cpu", mesh=mesh,
                                   checkpoint_dir=os.path.join(ckpt_dir, "replay"), checkpoint_every=1)
    record(res, "replay/last", gather_world(w, mesh), prods[-1])
    counters = met.snapshot()["counters"]
    for k in ("scans", "batches", "checkpoints"):
        res[f"replay/{k}"] = np.array([counters.get(k, 0)])
    res["replay/products"] = np.array([len(prods)])
    if rank == 0:
        np.savez(out, **res)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
