#!/usr/bin/env python3
"""Host-clock time of the batched step on a (data, space) mesh of gloo ranks
that share one NVIDIA GPU, with each of the step's collectives timed alone.

    python3 scripts/time_mesh_step.py [--root DIR] [--ranks 4] [--steps 6] [--batch-cache FILE.npz]

Imports gvom_tpu_torch from DIR (default: this checkout; tree_timing.use_root),
so that two commits unpacked side by side can be timed in one call, each by
its own code. The batches are scripts/tree_timing.py's (batch_points,
make_batch): 8 synthetic OS1-128 scans repeated to 32 with moving egos, at
the upstream deployment (GvomConfig(): 256×256×64); --batch-cache keeps
their points in a file. The meshes are those of chip_smoke.py's phase 9:
(1, 4) slab, (2, 2) slab and (2, 2) scatter, --ranks processes over gloo on
the one card.

On each rank and mesh, after a warm step into an empty world:

  step_ms     --steps steps on the host clock (the card synchronized, the
              ranks at a barrier before each step);
  then the same steps again with every collective of the Mesh
  (all_gather, all_reduce, reduce_scatter) wrapped: the card synchronized
  before and after it, its host-clock time (the wait for the other ranks
  included) and its bytes recorded in the order the step calls them, and
  the time since the previous collective's end (the rank's own work) as
  its gap_ms;
  bare_ms     then each of those collectives called alone, on a tensor of
              the same shape and dtype with the same arguments, --steps
              times (the ranks at a barrier before each call): what gloo
              takes for the same bytes with no step around it, on this
              host at this time.

Prints one JSON line (per mesh: each rank's median step_ms, and rank 0's
collectives with their median ms, gap_ms and bare_ms), then the card's
name and power limit.
"""

import argparse
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import tree_timing as tt

MESHES = (("(1, 4) slab", 4, "slab"), ("(2, 2) slab", 2, "slab"), ("(2, 2) scatter", 2, "scatter"))
COLLECTIVES = ("all_gather", "all_reduce", "reduce_scatter")


def timed_collectives(mesh, log):
    """Wrap mesh's collectives so that each call appends (kind, shape,
    bytes, start, end, dtype, arguments) on the host clock, the card
    synchronized around it."""
    import torch

    for kind in COLLECTIVES:
        f = getattr(mesh, kind)

        def wrapped(t, *a, _f=f, _kind=kind, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _f(t, *a, **k)
            torch.cuda.synchronize()
            log.append((_kind, list(t.shape), t.numel() * t.element_size(), t0, time.perf_counter(), t.dtype, a, k))
            return out

        setattr(mesh, kind, wrapped)


def run_steps(step, world, batches, mesh, ingest, shard_batch):
    """Host-clock ms of each step, the world carried from step to step."""
    import torch

    ms = []
    for b in batches:
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        world, _ = step(world, *shard_batch(*b, mesh, ingest))
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ms, world


def worker(argv) -> int:
    import torch

    rest = argv[argv.index("--worker") + 1:]
    tt.use_root(rest[0])
    inputs = Path(rest[1])
    from gvom_tpu_torch import GvomConfig, make_batched_step
    from gvom_tpu_torch.parallel.mesh import init_distributed, make_mesh, rank_args, shutdown
    from gvom_tpu_torch.parallel.sharding import shard_batch, shard_world
    from gvom_tpu_torch.types import empty_world_state

    rank, n, coordinator, _ = rank_args(argv)
    init_distributed(coordinator, n, rank, backend="gloo", device="cuda")
    meshes = [(name, make_mesh(space=space, device="cuda"), ingest) for name, space, ingest in MESHES]
    dev = meshes[0][1].device
    cfg = GvomConfig()
    batches = [tuple(t.to(dev) for t in b) for b in torch.load(inputs, map_location="cpu")]
    for name, mesh, ingest in meshes:
        step = make_batched_step(cfg, dev, mesh=mesh, ingest=ingest)
        world, _ = step(shard_world(empty_world_state(cfg, dev), mesh), *shard_batch(*batches[0], mesh, ingest))
        plain, _ = run_steps(step, world, batches[1:], mesh, ingest, shard_batch)
        log = []
        timed_collectives(mesh, log)
        calls = []
        for b in batches[1:]:
            del log[:]
            mesh.barrier()
            torch.cuda.synchronize()
            t_prev = time.perf_counter()
            world, _ = step(world, *shard_batch(*b, mesh, ingest))
            torch.cuda.synchronize()
            t_end = time.perf_counter()
            one = []
            for kind, shape, nbytes, t0, t1, _, _, _ in log:
                one.append(dict(kind=kind, shape=shape, bytes=nbytes, ms=1e3 * (t1 - t0), gap_ms=1e3 * (t0 - t_prev)))
                t_prev = t1
            calls.append((one, 1e3 * (t_end - t_prev)))
        for kind in COLLECTIVES:
            delattr(mesh, kind)
        bare = []
        for kind, shape, _, _, _, dtype, a, k in log:
            t = torch.ones(shape, dtype=dtype, device=dev)
            ms = []
            for _ in batches[1:]:
                mesh.barrier()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                getattr(mesh, kind)(t, *a, **k)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            bare.append(statistics.median(ms))
        coll = [dict(c, ms=statistics.median(s[0][i]["ms"] for s in calls), bare_ms=bare[i],
                     gap_ms=statistics.median(s[0][i]["gap_ms"] for s in calls)) for i, c in enumerate(calls[0][0])]
        print(json.dumps(dict(mesh=name, rank=rank, step_ms=plain, step_ms_median=statistics.median(plain),
                              collectives=coll, collectives_ms=sum(c["ms"] for c in coll), bare_ms=sum(bare),
                              tail_ms=statistics.median(c[1] for c in calls))), flush=True)
    shutdown()
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--worker" in argv:
        return worker(argv)
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(tt.ROOT), help="checkout whose gvom_tpu_torch is timed")
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--batch-cache", help="npz file of the batch's eight distinct scans (read, or written if missing)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_mesh_step: no CUDA device is available", file=sys.stderr)
        return 2
    root = tt.use_root(args.root)
    from gvom_tpu_torch import GvomConfig
    from gvom_tpu_torch.ops import kernels
    from gvom_tpu_torch.parallel.mesh import run_ranks

    cfg = GvomConfig()
    kernels.build_all()          # once here, so that the ranks find every library built
    bp, bv, be = (torch.from_numpy(a) for a in tt.batch_points(root, cfg, args.batch_cache))
    batches = [tt.make_batch(bp, bv, be, step_index=i) for i in range(args.steps + 1)]
    with tempfile.TemporaryDirectory() as tmp:
        inputs = Path(tmp) / "batches.pt"
        torch.save(batches, inputs)
        outs = run_ranks([sys.executable, str(Path(__file__).resolve()), "--worker", str(root), str(inputs)],
                         args.ranks, timeout=600)
    lines = [json.loads(x) for o in outs for x in o.splitlines() if x.startswith('{"mesh"')]
    out = dict(root=str(root), ranks=args.ranks, steps=args.steps, meshes={})
    for name, _, _ in MESHES:
        per = sorted((x for x in lines if x["mesh"] == name), key=lambda x: x["rank"])
        out["meshes"][name] = dict(step_ms_median_per_rank=[x["step_ms_median"] for x in per],
                                   step_ms_rank0=per[0]["step_ms"],
                                   collectives_ms_per_rank=[x["collectives_ms"] for x in per],
                                   tail_ms_per_rank=[x["tail_ms"] for x in per],
                                   bare_ms_per_rank=[x["bare_ms"] for x in per], collectives_rank0=per[0]["collectives"])
    print(json.dumps(out))
    print(tt.card())
    return 0


if __name__ == "__main__":
    sys.exit(main())
