"""The live loop: the robot's mapper, one scan in and one cost map out.

Set-up: the lap is made on the card and held on the host as each scan's
real points (numpy), as the sensor's node hands them over; the Gvom facade
is made (its kernels built) and `warm_maps` maps from an empty state warm
it. The window is a closed loop on one thread: process_pointcloud(points,
ego) and then combine_maps() for each scan of the lap in turn, as fast as
the facade takes them. A map's latency runs from the call of
process_pointcloud to the return of combine_maps with its numpy maps.

The comparison: the reference replays the warm maps from an empty state on
its own; for maps drawn from the seed in the window and the window's last
map it rebuilds the ring buffer from the last `buffer_size` scans and
combines it with the program's own previous world; traced, it replays the
traced maps one after another from the world before them.
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


def run(spec) -> dict:
    from gvom_tpu_torch.config import GvomConfig
    from gvom_tpu_torch.engine.gvom import Gvom

    dev, cell = spec.device, spec.cell
    warm = int(cell["warm_maps"])
    gvom = spec.config["gvom"]
    t_gen = time.perf_counter()
    lap = scangen.make_lap(spec.config["sensor"], spec.drive, gvom["ground_to_lidar_height"], spec.seed, dev)
    host = lap["points"].cpu().numpy()
    counts = lap["counts"].cpu().numpy()
    egos = lap["egos"].cpu().numpy()
    L = host.shape[0]
    scans = [host[s, :counts[s]] for s in range(L)]
    del lap
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t_lap = time.perf_counter()
    g = Gvom(config=GvomConfig.from_dict(gvom), device=dev)
    outs = []
    for j in range(warm):
        g.process_pointcloud(scans[j % L], egos[j % L])
        outs.append(g.combine_maps())
    start = dict(world=chk.host_copy(g.world_state), outs=outs)
    rng = np.random.default_rng(spec.seed)
    due = sorted(rng.uniform(0.15, 0.85, size=int(cell["sampled_maps"])) * spec.seconds)
    stretch = None
    pinned = chk.pinned_like(g.world_state) if dev.type == "cuda" else None
    if spec.trace:
        stretch = TracedStretch(spec.out_dir / "trace.json", spec.seconds)
    lat, ingest_ms, combine_ms, samples, traced = [], [], [], [], dict(j=[])
    failed, n, j = 0, 0, warm
    t_first = time.perf_counter()
    t0 = t_first
    while True:
        s = j % L
        if stretch is not None:
            stretch.before(n)
        prev = g.world_state
        ta = time.perf_counter()
        g.process_pointcloud(scans[s], egos[s])
        tb = time.perf_counter()
        out = g.combine_maps()
        tc = time.perf_counter()
        lat.append(tc - ta)
        ingest_ms.append(1e3 * (tb - ta))
        combine_ms.append(1e3 * (tc - tb))
        failed += out is None
        if stretch is not None:
            # the traced maps hold nothing on the card (a held world would make the allocator call
            # cudaMalloc inside the stretch): the world before them goes to the host first, and the
            # reference replays them from it
            if n == stretch.first - 1:
                if pinned is not None:
                    chk.copy_into(pinned, g.world_state)
                traced["prev"] = pinned if pinned is not None else chk.host_copy(g.world_state)
            if stretch.traced(n):
                traced["j"].append(j)
            if n == stretch.last:
                traced.update(world=g.world_state, out=out)
            stretch.after(n)
        elif due and tc - t0 >= due[0]:
            due.pop(0)
            samples.append(dict(j=j, prev=chk.host_copy(prev), world=chk.host_copy(g.world_state), out=out))
        n += 1
        j += 1
        if stretch is not None and n <= stretch.last:
            continue
        if tc - t0 >= spec.seconds:
            break
    window_s = tc - t0
    if stretch is not None:
        stretch.stop()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    timings = dict(start_s=t_gen - spec.t_start, lap_s=t_lap - t_gen, program_setup_s=t_first - t_lap)
    q = np.percentile(np.asarray(lat) * 1e3, [50, 95, 99])
    notes = [f"maps {n}, map ms median {q[0]:.4f}, p95 {q[1]:.4f}, p99 {q[2]:.4f}, mean {1e3 * np.mean(lat):.4f}"]
    rec = dict(timings=timings, loop="live", setup_s=t_first - spec.t_start, window_s=window_s, maps=n, attempted=n,
               failed=failed, latencies_s=lat, ingest_ms=ingest_ms, combine_ms=combine_ms,
               memory_peak_bytes=peak, device_mem_bytes=peak, scans=scans, egos=egos, warm=warm, start=start,
               samples=samples, last=dict(j=j - 1, prev=prev, world=g.world_state, out=out), traced=traced,
               notes=notes)
    if stretch is not None:
        rec.update(trace_path=stretch.path, launch_deltas=stretch.deltas, untraced_ms=stretch.untraced_ms,
                   traced_iters=stretch.active)
        notes.append(f"map ms by CUDA events: untraced {stretch.untraced_ms!r} over {stretch.wait} maps, "
                     f"traced {stretch.traced_ms!r} over {stretch.active}")
    del g
    return rec


def _returned(cfg: RefConfig, world, products) -> dict:
    """combine_maps' 5-tuple, as the facade returns it, from reference maps."""
    res = np.array([cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution])
    return dict(origin=products.origin.cpu().numpy().astype(np.float64) * res,
                positive=products.positive_obstacle.cpu().numpy(),
                negative=products.negative_obstacle.cpu().numpy(),
                roughness=products.roughness.cpu().numpy(), visibility=products.visibility.cpu().numpy())


def _as_dict(out) -> dict:
    if out is None:
        return dict(origin=np.zeros(0), positive=np.zeros(0), negative=np.zeros(0), roughness=np.zeros(0),
                    visibility=np.zeros(0))
    return dict(zip(("origin", "positive", "negative", "roughness", "visibility"), out))


class _Replayer:
    """The reference's ring buffer, fed the lap's scans in order from any
    map index on (every scan of the lap keeps an in-grid endpoint, so map j
    holds scans j − B + 1 .. j in slots (j − B + 1) mod B ..)."""

    def __init__(self, cfg: RefConfig, rec, device):
        self.cfg, self.rec, self.dev = cfg, rec, device
        self.buf = ref.new_buffer(cfg, device)
        self.next = None
        self.bad = 0

    def feed(self, j: int):
        B = self.cfg.buffer_size
        if self.next is None or j < self.next or j - self.next >= B:
            self.buf = ref.new_buffer(self.cfg, self.dev)
            self.next = max(0, j - B + 1)
            self.buf.cursor.fill_(self.next % B)
        L = len(self.rec["scans"])
        while self.next <= j:
            s = self.next % L
            pts = torch.from_numpy(self.rec["scans"][s]).to(self.dev)
            _, ok, _ = ref.ingest(self.cfg, self.buf, pts, torch.from_numpy(self.rec["egos"][s]).to(self.dev))
            self.bad += not bool(ok)
            self.next += 1
        return self.buf


def check(spec, rec) -> chk.Tally:
    """The reference against every compared map; traced, K4's bound of each
    traced map too (rec["bounds"])."""
    dev = spec.device
    cfg = RefConfig.from_dict(spec.config["gvom"])
    tally = chk.Tally()
    L = len(rec["scans"])
    ego = lambda j: torch.from_numpy(rec["egos"][j % L]).to(dev)
    rp = _Replayer(cfg, rec, dev)
    w = ref_empty_world(cfg, dev)
    for j in range(rec["warm"]):
        w, p, _ = ref.combine(cfg, rp.feed(j), w, ego(j))
        tally.arrays(f"warm map {j}", _as_dict(rec["start"]["outs"][j]), _returned(cfg, w, p))
    tally.world("warm maps", rec["start"]["world"], w)
    for what, job in [(f"sampled map {i}", t) for i, t in enumerate(rec["samples"])] + [("last map", rec["last"])]:
        w, p, _ = ref.combine(cfg, rp.feed(job["j"]), chk.to_ref_world(job["prev"], dev), ego(job["j"]))
        tally.world(what, job["world"], w)
        tally.arrays(what, _as_dict(job["out"]), _returned(cfg, w, p))
    bounds, tr = {}, rec["traced"]
    if tr["j"]:
        w = chk.to_ref_world(tr["prev"], dev)
        for j in tr["j"]:
            buf, w_in = rp.feed(j), w
            w, p, _ = ref.combine(cfg, buf, w_in, ego(j))
            origin = buf.grids.origin[int(buf.last_slot)]
            bounds["combine"] = bounds.get("combine", 0.0) + roofline.bound_ms(
                *roofline.combine_bound(cfg, buf, w_in, origin, w.grid.hit))
        tally.world("traced maps", tr["world"], w)
        tally.arrays("traced maps", _as_dict(tr["out"]), _returned(cfg, w, p))
    if rp.bad:
        rec["notes"].append(f"{rp.bad} scans of the reference's ring buffer kept no in-grid endpoint")
        tally.mismatch += rp.bad
    rec["bounds"] = bounds
    return tally
