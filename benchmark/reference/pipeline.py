"""The reference pipeline: what the port computes, in plain PyTorch.

A frozen copy of the port's plain versions (its models/pipeline.py ingest
and fuse_plain, parallel/sharding.py's merge and batched step, and
engine/replay.batched_ray_steps), composed as the port's entry points
compose its kernels:

  * ingest / combine   the Gvom facade's process_pointcloud and
                       combine_maps: one scan into the ring buffer, then the
                       buffer fused with the previous world and the 2-D maps;
  * batched_step       make_batched_step's step: a batch of scans in the
                       frame of its last scan, merged into the world.

`dtype` is the precision in which each point's moment terms and their sums
are held, and `point_dtype` the one to which the prepared points are
rounded: float32 as the configuration states, or bfloat16 for the
comparison's controls (benchmark/control.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark.reference import binning, maps2d, moments, raycast
from benchmark.reference import grid as gridops
from benchmark.reference.config import (BufferState, GvomConfig, MapProducts, VoxelGrid, WorldState,
                                        empty_buffer_state)

__all__ = ["batched_ray_steps", "ingest", "combine", "batched_step", "merge_batch_plain", "fuse_plain"]


def _round(p: torch.Tensor, dtype) -> torch.Tensor:
    return p if dtype == torch.float32 else p.to(dtype).float()


def batched_ray_steps(cfg: GvomConfig, egos: np.ndarray, batch_size: int) -> int:
    """The static DDA budget of a batched replay: the centred bound plus the
    worst in-batch ego drift, in voxels (each batch rasterizes at its last
    scan's origin)."""
    res = np.array([cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution])
    egos = np.asarray(egos, np.float64)
    drift = 0.0
    for b0 in range(0, len(egos), batch_size):
        eb = egos[b0:b0 + batch_size]
        drift = max(drift, float((np.abs(eb - eb[-1]) / res).max()))
    size = max(cfg.xy_size, cfg.z_size)
    return min(size // 2 + 6 + int(np.ceil(drift)), size + 4)


# ----------------------------------------------------------------------
# the facade: one scan into the ring buffer, then the combine


def ingest(cfg: GvomConfig, buf: BufferState, points: torch.Tensor, ego: torch.Tensor, dtype=torch.float32,
           point_dtype=torch.float32):
    """One scan (points [n, 3] world frame, every one valid) into the ring
    buffer, in place: the scan's own origin, its passes, hit, min height
    and occupancy-masked moments, at the cursor or the write-off slot B.
    Returns (buf, scan_ok, the scan's VoxelGrid)."""
    ego = ego.float()
    valid = torch.ones(points.shape[:1], dtype=torch.bool, device=points.device)
    p, keep, origin, scan_ok = binning.prepare_plain(cfg, points.float()[None], valid[None], ego[None],
                                                     frame_ego=ego)
    p, keep, scan_ok = _round(p[0], point_dtype), keep[0], scan_ok[0]
    passes = raycast.pass_counts_plain(cfg, p[None], keep[None], ego[None], origin)
    hit, minh, mom = moments.point_moments(cfg, p, keep, origin, occupancy_mask=True, dtype=dtype)
    grid = VoxelGrid(hit=hit, miss=passes, min_height=minh, mom=mom, origin=origin)
    B = cfg.buffer_size
    slot = int(buf.cursor) if bool(scan_ok) else B
    g = buf.grids
    for stacked, leaf in ((g.hit, hit), (g.miss, passes), (g.min_height, minh), (g.mom, mom), (g.origin, origin)):
        stacked[slot] = leaf
    if bool(scan_ok):
        cur = int(buf.cursor)
        buf.slot_valid[cur] = True
        buf.last_slot.fill_(cur)
        buf.cursor.fill_((cur + 1) % B)
    return buf, scan_ok, grid


def fuse_plain(cfg: GvomConfig, buf: BufferState, world: WorldState, origin: torch.Tensor, ego: torch.Tensor):
    """Fuse the B buffer slots and the old world into the new world's
    channels, and take the per-column products (slot order, occupied-wins,
    evidence latching and the staleness veto of gvom.py:198-266, 941-997).
    Returns (hit, miss, min_height, evidence, mom) with the any_valid latch
    applied, and the torus [X, Y] column products (height, inferred height,
    band hit sum, band total sum, band_ok)."""
    dev = origin.device
    B = cfg.buffer_size
    any_valid = buf.slot_valid.any()
    g = buf.grids
    masks = [gridops.overlap_mask(cfg, origin, g.origin[i]) & buf.slot_valid[i] for i in range(B)]

    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    occ = torch.zeros(cfg.grid_shape, dtype=torch.bool, device=dev)
    evidence = torch.zeros(cfg.grid_shape, dtype=torch.int32, device=dev)
    s_occs = []
    for i, am in enumerate(masks):
        s_occ = (g.hit[i] > 0) & am
        s_ev = torch.where(am & ~s_occ, g.miss[i], zero_i)
        evidence = torch.where((s_ev > 0) & ~occ, evidence + s_ev, evidence)
        occ = occ | s_occ
        s_occs.append(s_occ)
    old = world.grid
    old_mask = gridops.overlap_mask(cfg, origin, old.origin) & world.valid
    old_occ = (old.hit > 0) & old_mask
    revive = old_occ & ~occ & (evidence <= cfg.decay_miss_limit)   # staleness veto (gvom.py:992)
    occ = occ | revive
    old_ev = torch.where(old_mask, world.evidence, zero_i)
    evidence = torch.where(~old_occ & (old_ev > 0) & ~occ, evidence + old_ev, evidence)
    evidence = torch.where(occ, zero_i, evidence)                    # occupied-wins (gvom.py:947-950)

    hit = torch.zeros(cfg.grid_shape, dtype=torch.int32, device=dev)
    miss = torch.zeros_like(hit)
    min_height = torch.ones(cfg.grid_shape, dtype=torch.float32, device=dev)
    mom = torch.zeros_like(old.mom)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    sources = [(g.hit[i], g.miss[i], g.min_height[i], g.mom[i], s_occs[i], masks[i]) for i in range(B)]
    sources.append((old.hit, old.miss, old.min_height, old.mom, old_occ & occ, old_mask & occ))
    for s_hit, s_miss, s_minh, s_mom, sel, mom_mask in sources:
        hit = hit + torch.where(sel, s_hit, zero_i)
        miss = miss + torch.where(sel, s_miss, zero_i)
        min_height = torch.where(sel, torch.minimum(min_height, s_minh), min_height)
        mom = mom + torch.where(mom_mask, s_mom, zero_f)

    hm_t = maps2d.height_map(cfg, occ, min_height, origin, ego)
    ihm_t = maps2d.inferred_height_map(cfg, occ, evidence, origin)
    pnum, pden, band_ok = maps2d.positive_band_sums(cfg, occ, hit, hit + miss, hm_t, origin)

    outs = tuple(torch.where(any_valid, new, prev) for new, prev in (
        (hit, old.hit), (miss, old.miss), (min_height, old.min_height), (evidence, world.evidence),
        (mom, old.mom)))
    return outs + (hm_t, ihm_t, pnum, pden, band_ok)


def _products(cfg: GvomConfig, hm_t, ihm_t, pnum, pden, band_ok, origin) -> MapProducts:
    hm, ihm, rough, sx, sy = maps2d.plane_fit_window_plain(cfg, hm_t, ihm_t, origin)
    ghd, pos, neg, vis = maps2d.guess_products_plain(cfg, hm, ihm, sx, sy, pnum, pden, band_ok, origin)
    return MapProducts(origin=origin, height=hm, inferred_height=ihm, slope_x=sx, slope_y=sy, roughness=rough,
                       guessed_height_delta=ghd, positive_obstacle=pos, negative_obstacle=neg, visibility=vis)


def combine(cfg: GvomConfig, buf: BufferState, world: WorldState, ego: torch.Tensor):
    """The buffer fused with the previous world, and the 2-D maps. Returns
    (new world, products, combine_ok)."""
    ego = ego.float()
    origin = buf.grids.origin[int(buf.last_slot)]
    any_valid = buf.slot_valid.any()
    hit, miss, minh, evidence, mom, hm_t, ihm_t, pnum, pden, band_ok = fuse_plain(cfg, buf, world, origin, ego)
    grid = VoxelGrid(hit=hit, miss=miss, min_height=minh, mom=mom,
                     origin=torch.where(any_valid, origin, world.grid.origin))
    new_world = WorldState(grid=grid, evidence=evidence, valid=world.valid | any_valid)
    return new_world, _products(cfg, hm_t, ihm_t, pnum, pden, band_ok, origin), any_valid


def new_buffer(cfg: GvomConfig, device) -> BufferState:
    return empty_buffer_state(cfg, device)


# ----------------------------------------------------------------------
# the batched step


def merge_batch_plain(cfg: GvomConfig, world: WorldState, contrib: VoxelGrid):
    """Merge one batch's contribution (hit, miss, min_height and RAW moments
    at contrib.origin) with the old world. Returns (merged VoxelGrid,
    evidence, occ2). The batch's negative evidence at a voxel that the
    fused map leaves unoccupied is its total miss count."""
    origin = contrib.origin
    old = world.grid
    zero_i = torch.zeros((), dtype=torch.int32, device=origin.device)
    zero_f = torch.zeros((), dtype=torch.float32, device=origin.device)
    omask = gridops.overlap_mask(cfg, origin, old.origin)
    old_ev = torch.where(omask, world.evidence, zero_i)
    occ = contrib.hit > 0
    old_occ = (old.hit > 0) & omask & world.valid
    revive = old_occ & ~occ & (contrib.miss <= cfg.decay_miss_limit)   # staleness veto (gvom.py:992)
    occ2 = occ | revive
    evidence = torch.where(~old_occ & (old_ev > 0) & ~occ2 & world.valid, contrib.miss + old_ev, contrib.miss)
    evidence = torch.where(occ2, zero_i, evidence)
    msel = old_occ & occ2
    merged = VoxelGrid(
        hit=contrib.hit + torch.where(msel, old.hit, zero_i),
        miss=contrib.miss + torch.where(msel, old.miss, zero_i),
        min_height=torch.where(msel, torch.minimum(contrib.min_height, old.min_height), contrib.min_height),
        mom=torch.where(occ[None], contrib.mom, zero_f) + torch.where((omask & occ2)[None], old.mom, zero_f),
        origin=origin)
    return merged, evidence, occ2


@dataclasses.dataclass
class StepParts:
    """What a reference step computed on its way, for the roofline counts."""

    keep: torch.Tensor       # [S, N] bool, dead scans masked out
    contrib: VoxelGrid       # the batch's contribution (raw moments)
    sums_n: torch.Tensor     # [Xp, Yp, Zp] own-voxel point counts on the padded window


def batched_step(cfg: GvomConfig, world: WorldState, scans: torch.Tensor, valid: torch.Tensor, egos: torch.Tensor,
                 dtype=torch.float32, point_dtype=torch.float32):
    """One batched step: the batch in the frame of its last scan's ego,
    every scan's rays from its own ego, the raw moments of all the batch's
    points, merged with the world. Returns (new world, products, parts)."""
    S, N = valid.shape
    egos = egos.float()
    ego_last = egos[-1]
    pw, keep, origin, _ = binning.prepare_plain(cfg, scans.float(), valid, egos, frame_ego=ego_last, drop_dead=True)
    pw = _round(pw, point_dtype)
    miss = raycast.pass_counts_plain(cfg, pw, keep, egos, origin)
    flat, fkeep = pw.view(-1, 3), keep.view(-1)
    bins = binning.bin_points(cfg, flat, fkeep, origin, dtype=dtype)
    mom = moments.moments_epilogue_plain(cfg, bins.sums, bins.hit, origin, occupancy_mask=False).float()
    contrib = VoxelGrid(hit=bins.hit, miss=miss, min_height=bins.min_height, mom=mom, origin=origin)
    merged, evidence, occ2 = merge_batch_plain(cfg, world, contrib)
    hm_t = maps2d.height_map(cfg, occ2, merged.min_height, origin, ego_last)
    ihm_t = maps2d.inferred_height_map(cfg, occ2, evidence, origin)
    pnum, pden, band_ok = maps2d.positive_band_sums(cfg, occ2, merged.hit, merged.hit + merged.miss, hm_t, origin)
    products = _products(cfg, hm_t, ihm_t, pnum, pden, band_ok, origin)
    new_world = WorldState(grid=merged, evidence=evidence, valid=torch.ones((), dtype=torch.bool, device=egos.device))
    return new_world, products, StepParts(keep=keep, contrib=contrib, sums_n=bins.sums[0].float())
