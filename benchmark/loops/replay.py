"""The replay loop: a recorded drive fused into maps by the batched step.

Set-up: the lap is made on the card and staged there whole; the step is
built as engine/replay.batched_replay builds it (make_batched_step with the
ray budget of batched_ray_steps over the lap's egos); `warm_steps` steps
from an empty world warm every shape. The window then dispatches the
cell's batches of consecutive scans back to back, round the lap, with no
host sync inside, and ends in torch.cuda.synchronize().

The comparison: the reference replays the warm steps from an empty world
on its own, and repeats from the program's own input world one step drawn
from the seed in the window, the window's last step and, traced, the
traced steps one after another.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import check as chk
from benchmark import roofline, scangen
from benchmark.reference import pipeline as ref
from benchmark.reference.config import GvomConfig as RefConfig
from benchmark.reference.config import empty_world_state as ref_empty_world
from benchmark.stretch import TracedStretch

__all__ = ["run", "check"]

ENQUEUE_PROBES = 20   # steps called on an idle device queue after the traced stretch, each timed on the host


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _to_host(pinned, world):
    """The world's copy on the host: enqueued into pinned memory without a
    wait on the card, a plain copy on the CPU."""
    if pinned is None:
        return chk.host_copy(world)
    chk.copy_into(pinned, world)
    return pinned


def run(spec) -> dict:
    from gvom_tpu_torch.config import GvomConfig
    from gvom_tpu_torch.engine.replay import batched_ray_steps
    from gvom_tpu_torch.parallel.sharding import make_batched_step
    from gvom_tpu_torch.types import empty_world_state

    dev, cell = spec.device, spec.cell
    batch, warm = int(cell["batch"]), int(cell["warm_steps"])
    gvom = spec.config["gvom"]
    t_gen = time.perf_counter()
    lap = scangen.make_lap(spec.config["sensor"], spec.drive, gvom["ground_to_lidar_height"], spec.seed, dev)
    points, valid, egos = lap["points"], lap["valid"], lap["egos"]
    staged = sum(t.numel() * t.element_size() for t in (points, valid, egos))
    nb = points.shape[0] // batch
    batches = [(points[b * batch:(b + 1) * batch], valid[b * batch:(b + 1) * batch],
                egos[b * batch:(b + 1) * batch]) for b in range(nb)]
    _sync(dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_lap = time.perf_counter()
    cfg = GvomConfig.from_dict(gvom)
    cfg = cfg.replace(ray_steps_override=batched_ray_steps(cfg, egos.cpu().numpy(), batch))
    step = make_batched_step(cfg, dev)
    world = empty_world_state(cfg, dev)
    for b in range(warm):
        world, products = step(world, *batches[b])
    _sync(dev)
    start = dict(world=chk.host_copy(world), products=products)
    rng = np.random.default_rng(spec.seed)
    u = float(rng.uniform(0.2, 0.8))
    stretch = None
    pinned = (chk.pinned_like(world), chk.pinned_like(world)) if dev.type == "cuda" else None
    if spec.trace:
        stretch = TracedStretch(spec.out_dir / "trace.json", spec.seconds)
    traced, enqueue_ms, sample = dict(b=[]), [], None
    b, n = warm % nb, 0
    _sync(dev)
    t_first = time.perf_counter()
    t0 = t_first
    while True:
        if stretch is not None:
            stretch.before(n)
        prev = world
        world, products = step(prev, *batches[b])
        if stretch is not None:
            # the traced steps hold nothing on the card (a held world would make the allocator call
            # cudaMalloc inside the stretch): their input world goes to the host before the stretch, and
            # the reference replays them from it
            if n == stretch.first - 1:
                traced["prev"] = _to_host(pinned and pinned[0], world)
            if stretch.traced(n):
                traced["b"].append(b)
            if n == stretch.last:
                traced.update(world=world, products=products)
            stretch.after(n)
            if n == stretch.last:
                for _ in range(ENQUEUE_PROBES):
                    b = (b + 1) % nb
                    prev = world
                    _sync(dev)
                    t = time.perf_counter()
                    world, products = step(prev, *batches[b])
                    enqueue_ms.append(1e3 * (time.perf_counter() - t))
        elif sample is None and time.perf_counter() - t0 >= u * spec.seconds:
            sample = dict(b=b, prev=_to_host(pinned and pinned[0], prev), world=_to_host(pinned and pinned[1], world),
                          products=products)
        n += 1
        last_b = b
        b = (b + 1) % nb
        if stretch is not None and n <= stretch.last:
            continue
        if time.perf_counter() - t0 >= spec.seconds:
            break
    _sync(dev)
    window_s = time.perf_counter() - t0
    if stretch is not None:
        stretch.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    steps = n + len(enqueue_ms)
    timings = dict(start_s=t_gen - spec.t_start, lap_s=t_lap - t_gen, program_setup_s=t_first - t_lap)
    rec = dict(timings=timings, loop="replay", setup_s=t_first - spec.t_start, window_s=window_s, steps=steps,
               scans=steps * batch, attempted=steps, failed=0, memory_peak_bytes=peak,
               device_mem_bytes=peak - staged, batches=batches, batch=batch, warm=warm, start=start,
               sample=sample, last=dict(b=last_b, prev=prev, world=world, products=products), traced=traced,
               enqueue_ms=enqueue_ms, egos=egos, notes=[])
    if stretch is not None:
        rec.update(trace_path=stretch.path, launch_deltas=stretch.deltas, untraced_ms=stretch.untraced_ms,
                   traced_iters=stretch.active)
        rec["notes"].append(f"step ms by CUDA events: untraced {stretch.untraced_ms!r} over {stretch.wait} steps, "
                            f"traced {stretch.traced_ms!r} over {stretch.active}")
    del step
    return rec


def check(spec, rec) -> chk.Tally:
    """The reference against every compared step; traced, each traced
    step's kernel bounds too (rec["bounds"])."""
    dev = spec.device
    rcfg = RefConfig.from_dict(spec.config["gvom"])
    rcfg = rcfg.replace(ray_steps_override=ref.batched_ray_steps(rcfg, rec["egos"].cpu().numpy(), rec["batch"]))
    batches = rec["batches"]
    tally = chk.Tally()
    w = ref_empty_world(rcfg, dev)
    for b in range(rec["warm"]):
        w, p, _ = ref.batched_step(rcfg, w, *batches[b])
    tally.world("warm steps", rec["start"]["world"], w)
    tally.products("warm steps", rec["start"]["products"], p)
    del w, p
    for what, job in (("sampled step", rec["sample"]), ("last step", rec["last"])):
        if job is None:
            continue
        w, p, _ = ref.batched_step(rcfg, chk.to_ref_world(job["prev"], dev), *batches[job["b"]])
        tally.world(what, job["world"], w)
        tally.products(what, job["products"], p)
        del w, p
    bounds, tr = {}, rec["traced"]
    if tr["b"]:
        w = chk.to_ref_world(tr["prev"], dev)
        for b in tr["b"]:
            w_in = w
            w, p, parts = ref.batched_step(rcfg, w_in, *batches[b])
            for k, v in roofline.replay_step_bounds(rcfg, w_in, parts, tuple(batches[b][1].shape)).items():
                bounds[k] = bounds.get(k, 0.0) + v
            del w_in, parts
        tally.world("traced steps", tr["world"], w)
        tally.products("traced steps", tr["products"], p)
    rec["bounds"] = bounds
    return tally
