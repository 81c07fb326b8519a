"""The batched step: a batch of (scan, ego) pairs fused into the world map in
one step, on one device.

Counterpart of gvom_tpu/parallel/sharding.py (`make_batched_step`'s
device_fn) on a mesh of one device: no mesh, no collectives, no y-slab. The
JAX package shards the same step over a (data, space) mesh; that needs only
torch.distributed plumbing around this function (the slab forms of the
kernels exist, ops/kernels.py) and is not here yet.

Batched semantics against the reference: all scans of a batch rasterize
into one common frame, the origin of the batch's last scan, and fuse
associatively (order-free), where the reference goes through its
slot-ordered ring buffer. The ring buffer exists to decouple sensor threads
from the combine timer (gvom.py:163-175), which a batched step subsumes.
Negative evidence uses the associative form: the batch's total misses at
voxels the fused map leaves unoccupied.

Per step: kernel K1 once for all scans (each scan's rays from its own ego,
all adding into one miss grid); kernels K2 and K5 once on the merged points
of the whole batch, the moments raw (no occupancy mask); then the merge with
the old world and the 2D maps in plain PyTorch, as the JAX package computes
them outside any Pallas kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import binning, kernels, maps2d
from gvom_tpu_torch.ops import grid as gridops
from gvom_tpu_torch.types import MapProducts, VoxelGrid, WorldState, resolve_device

__all__ = ["batched_step", "make_batched_step", "prepare_batch", "merge_batch_plain"]


def merge_batch_plain(cfg: GvomConfig, world: WorldState, contrib: VoxelGrid):
    """Merge one batch's contribution (hit, miss, min_height and RAW moments
    at contrib.origin) with the old world: masks only, no data moves.
    Returns (merged VoxelGrid, evidence, occ2).

    The evidence formula is the batched step's own, not fuse_plain's
    slot-latched one: the batch's negative evidence at a voxel the fused map
    leaves unoccupied is exactly its total miss count, because every
    consumer reads evidence only where the fused map is unoccupied, and
    there no scan of the batch has a hit."""
    origin = contrib.origin
    old = world.grid
    zero_i = torch.zeros((), dtype=torch.int32, device=origin.device)
    zero_f = torch.zeros((), dtype=torch.float32, device=origin.device)
    omask = gridops.overlap_mask(cfg, origin, old.origin)       # the two windows' overlap
    old_ev = torch.where(omask, world.evidence, zero_i)
    occ = contrib.hit > 0
    old_occ = (old.hit > 0) & omask & world.valid
    revive = old_occ & ~occ & (contrib.miss <= cfg.decay_miss_limit)   # staleness veto (gvom.py:992)
    occ2 = occ | revive
    evidence = torch.where(~old_occ & (old_ev > 0) & ~occ2 & world.valid, contrib.miss + old_ev, contrib.miss)
    evidence = torch.where(occ2, zero_i, evidence)                       # occupied-wins
    msel = old_occ & occ2
    merged = VoxelGrid(
        hit=contrib.hit + torch.where(msel, old.hit, zero_i),
        miss=contrib.miss + torch.where(msel, old.miss, zero_i),
        min_height=torch.where(msel, torch.minimum(contrib.min_height, old.min_height), contrib.min_height),
        # the batch's moments are raw, so the batch's occupancy masks them;
        # the old world's are occupancy-masked by induction, so the overlap
        # and the new occupancy are their only live factors
        mom=torch.where(occ[None], contrib.mom, zero_f) + torch.where((omask & occ2)[None], old.mom, zero_f),
        origin=origin,
    )
    return merged, evidence, occ2


def prepare_batch(cfg: GvomConfig, scans: torch.Tensor, valid: torch.Tensor, egos: torch.Tensor):
    """The batch as one flat point set in the common frame: (origin, points
    [S·N,3], keep [S·N]). The frame is the origin
    of the batch's last scan. A scan that bins no in-grid endpoint (the same
    predicate as "produced no occupied voxel", gvom.py:148-150) is dead: its
    points are masked out of keep and it contributes nothing."""
    S, N = valid.shape
    egos = egos.float()
    origin = gridops.compute_origin(cfg, egos[-1])
    egos_pt = egos[:, None, :].expand(S, N, 3).reshape(-1, 3)
    pw, keep = binning.prepare_points(cfg, scans.reshape(-1, 3), valid.reshape(-1), egos_pt)
    vox = torch.floor(gridops.map_local(cfg, pw, origin)).to(torch.int32)
    oks = (keep & gridops.in_bounds(cfg, vox)).view(S, N).any(dim=1)
    return origin, pw, keep & oks[:, None].expand(S, N).reshape(-1)


def make_batched_step(cfg: GvomConfig, device="cuda") -> Callable:
    """Build the step (world, scans [S,N,3], valid [S,N], egos [S,3]) →
    (world, products) on `device`. The inputs are tensors on that device;
    the step returns a new world and leaves the old one untouched.

    All scans of a batch rasterize at the LAST scan's origin, so earlier
    egos can sit anywhere in the grid, and the centered-ego DDA budget
    (config.ray_steps) would cut their long rays short. The budget is raised
    to the any-in-grid bound unless the caller pinned one; the raycast ends
    each ray where it dies, so the wider bound admits only live steps."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        kernels.build_all()      # nvcc at start-up, never inside a step
    if cfg.ray_steps_override is None:
        cfg = dataclasses.replace(cfg, ray_steps_override=max(cfg.xy_size, cfg.z_size) + 4)

    def step(world: WorldState, scans: torch.Tensor, valid: torch.Tensor,
             egos: torch.Tensor) -> Tuple[WorldState, MapProducts]:
        for name, t in (("scans", scans), ("valid", valid), ("egos", egos), ("world", world.grid.hit)):
            if t.device.type != dev.type or (dev.index is not None and t.device.index != dev.index):
                raise ValueError(f"{name} is on {t.device}; this step was made for {dev}")
        S, N = valid.shape
        egos = egos.float().contiguous()
        ego_last = egos[-1]
        origin, pw, keep = prepare_batch(cfg, scans, valid, egos)

        # ---- the raycast: one launch, each scan's rays from ITS ego, all
        # adding into one miss grid ----
        miss = torch.zeros(cfg.grid_shape, dtype=torch.int32, device=dev)
        kernels.ray_pass_counts(cfg, pw.view(S, N, 3), keep.view(S, N), egos, origin, out=miss)

        # ---- merged endpoint metrics: ONE pass over the whole batch's
        # points (binning and moments are ego-free and additive over
        # points). The moments come back raw; the batch's occupancy masks
        # them in the merge ----
        hit, minh, mom = kernels.point_moments(cfg, pw, keep, origin, occupancy_mask=False)
        contrib = VoxelGrid(hit=hit, miss=miss, min_height=minh, mom=mom, origin=origin)

        # ---- merge with the world, then the 2D maps ----
        merged, evidence, occ2 = merge_batch_plain(cfg, world, contrib)
        hm_t = maps2d.height_map(cfg, occ2, merged.min_height, origin, ego_last)
        ihm_t = maps2d.inferred_height_map(cfg, occ2, evidence, origin)
        hm = gridops.torus_to_window(hm_t, origin, grid_ndim=2)
        ihm = gridops.torus_to_window(ihm_t, origin, grid_ndim=2)
        sx, sy, rough = maps2d.slope_and_roughness(cfg, hm)
        ghd = maps2d.guess_height_delta(cfg, hm, ihm)
        sx_t = gridops.window_to_torus(sx, origin, grid_ndim=2)
        sy_t = gridops.window_to_torus(sy, origin, grid_ndim=2)
        pos_t = maps2d.positive_obstacle_map(cfg, occ2, merged.hit, merged.hit + merged.miss, hm_t, sx_t, sy_t,
                                             origin)
        products = MapProducts(
            origin=origin, height=hm, inferred_height=ihm, slope_x=sx, slope_y=sy, roughness=rough,
            guessed_height_delta=ghd,
            positive_obstacle=gridops.torus_to_window(pos_t, origin, grid_ndim=2),
            negative_obstacle=maps2d.negative_obstacle_map(cfg, ghd),
            visibility=maps2d.visibility_map(hm),
        )
        new_world = WorldState(grid=merged, evidence=evidence,
                               valid=torch.ones((), dtype=torch.bool, device=dev))
        return new_world, products

    return step


def batched_step(cfg: GvomConfig, world, scans, valid, egos, device="cuda"):
    return make_batched_step(cfg, device)(world, scans, valid, egos)
