"""The batched step: a batch of (scan, ego) pairs fused into the world map in
one step, on one device or over a (data, space) mesh of ranks.

Counterpart of gvom_tpu/parallel/sharding.py. Collective layout per step, by
ingest strategy (make_batched_step), over torch.distributed (parallel/mesh.py):

  * "slab" (the default): scans shard over `data` only; each rank rasterizes
    its scans straight into its y-slab through the slab forms of the kernels
    (K6), and the only grid collective is an all_reduce of slab-sized
    tensors over `data`;
  * "scatter": scans shard over both axes; each rank rasterizes the full grid
    with the full-grid kernels (K1, K2, K5), then reduce_scatter along y over
    `space` and all_reduce over `data`; min_height is reduced over every
    rank, then sliced.

The merge with the world slab is shard-local (masks built from the slab's
global torus y indices); the column maps run on the slab and only the
[X, X] 2D maps are gathered over `space` for the stencils and the maps'
tail. The world never leaves its slabs in 3D. On one device (mesh=None)
the step is the same code on a mesh of one rank, whose collectives return
their input.

Batched semantics against the reference: all scans of a batch rasterize
into one common frame, the origin of the batch's last scan, and fuse
associatively (order-free), where the reference goes through its
slot-ordered ring buffer. The ring buffer exists to decouple sensor threads
from the combine timer (gvom.py:163-175), which a batched step subsumes.
Negative evidence uses the associative form: the batch's total misses at
voxels the fused map leaves unoccupied.

Per step and rank: the point preparation once for the rank's scans (the
transform-free world points, keep with the dead scans masked out, the
common origin); kernel K1 once for the rank's scans (each scan's rays
from its own ego, all adding into one miss grid); kernels K2 and K5 once on
the merged points of the rank's scans, the moments raw (no occupancy mask),
channels 1-9 of K2's sums in a scratch that the step keeps across its
calls (binning.MomentScratch);
then the merge kernel (the merge with the old world and the column maps,
csrc/merge.cu), the plane fit (which moves the column maps to the window
layout as it loads them) and the guess height (which writes the obstacle
maps and the visibility as its epilogue): the port's kernels for what the
JAX package computes in XLA outside any Pallas kernel.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
from typing import Callable, Tuple

import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import binning, kernels, maps2d
from gvom_tpu_torch.ops import grid as gridops
from gvom_tpu_torch.parallel.mesh import DATA_AXIS, SPACE_AXIS, Mesh
from gvom_tpu_torch.types import MapProducts, VoxelGrid, WorldState
from gvom_tpu_torch.utils.profiling import annotate

__all__ = ["batched_step", "make_batched_step", "prepare_batch", "merge_batch_plain", "merge_and_columns_plain",
           "shard_batch", "shard_world", "gather_world"]


def merge_batch_plain(cfg: GvomConfig, world: WorldState, contrib: VoxelGrid, coords=None):
    """Merge one batch's contribution (hit, miss, min_height and RAW moments
    at contrib.origin) with the old world: masks only, no data moves.
    Returns (merged VoxelGrid, evidence, occ2).

    The evidence formula is the batched step's own, not fuse_plain's
    slot-latched one: the batch's negative evidence at a voxel the fused map
    leaves unoccupied is exactly its total miss count, because every
    consumer reads evidence only where the fused map is unoccupied, and
    there no scan of the batch has a hit. A y-slab passes its global torus
    indices as `coords` (ops/grid.overlap_mask)."""
    origin = contrib.origin
    old = world.grid
    zero_i = torch.zeros((), dtype=torch.int32, device=origin.device)
    zero_f = torch.zeros((), dtype=torch.float32, device=origin.device)
    omask = gridops.overlap_mask(cfg, origin, old.origin, coords)       # the two windows' overlap
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


def merge_and_columns_plain(cfg: GvomConfig, world: WorldState, contrib: VoxelGrid, ego: torch.Tensor, y0: int = 0):
    """The plain twin of the merge kernel (kernels.merge_batch): the merge of
    merge_batch_plain on the y-slab of torus rows [y0, y0+Ys) (Ys is the
    contribution's), then the merged world's column maps. Returns (merged
    VoxelGrid, evidence, cols [2, X, Ys] f32: height and inferred height,
    bands [3, X, Ys] int32: the band's hit sum, total sum and band_ok),
    torus layout."""
    X, Ys, Z = contrib.hit.shape
    dev = contrib.hit.device
    y_coords = torch.arange(y0, y0 + Ys, dtype=torch.int32, device=dev)
    coords = (torch.arange(X, dtype=torch.int32, device=dev), y_coords, torch.arange(Z, dtype=torch.int32, device=dev))
    merged, evidence, occ2 = merge_batch_plain(cfg, world, contrib, coords)
    origin = contrib.origin
    hm_t = maps2d.height_map(cfg, occ2, merged.min_height, origin, ego, y_coords)
    ihm_t = maps2d.inferred_height_map(cfg, occ2, evidence, origin)
    pnum, pden, band_ok = maps2d.positive_band_sums(cfg, occ2, merged.hit, merged.hit + merged.miss, hm_t, origin)
    return merged, evidence, torch.stack([hm_t, ihm_t]), torch.stack([pnum, pden, band_ok])


def prepare_batch(cfg: GvomConfig, scans: torch.Tensor, valid: torch.Tensor, egos: torch.Tensor,
                  frame_ego: torch.Tensor = None):
    """The batch as one flat point set in the common frame: (origin, points
    [S·N,3], keep [S·N]), from the point-preparation kernel (the plain twin
    on the CPU). The frame is that of `frame_ego`, by default the batch's
    last scan's ego. A scan that bins no in-grid endpoint (the same
    predicate as "produced no occupied voxel", gvom.py:148-150) is dead: its
    points are masked out of keep and it contributes nothing."""
    egos = egos.float().contiguous()
    frame = egos[-1] if frame_ego is None else frame_ego.float()
    pw, keep, origin, _ = kernels.prepare_points(cfg, scans.float().contiguous(), valid.contiguous(), egos,
                                                 frame_ego=frame.contiguous(), drop_dead=True)
    return origin, pw.view(-1, 3), keep.view(-1)


def _ingest(ingest: str) -> str:
    if ingest == "auto":
        return "slab"
    if ingest not in ("slab", "scatter"):
        raise ValueError(f"unknown ingest strategy {ingest!r}")
    return ingest


def _slab_rows(Y: int, mesh: Mesh) -> slice:
    """The torus rows of this rank's y-slab."""
    nsp = mesh.shape[1]
    if Y % nsp != 0:
        raise ValueError(f"xy_size {Y} not divisible by space axis {nsp}")
    Ys = Y // nsp
    return slice(mesh.space_index * Ys, (mesh.space_index + 1) * Ys)


def shard_batch(scans: torch.Tensor, valid: torch.Tensor, egos: torch.Tensor, mesh: Mesh, ingest: str = "auto"):
    """This rank's shard (scans, valid, egos) of a global batch: the scans
    split in order over `data` (slab ingest) or over both axes in rank order
    (scatter), as the JAX package's in_specs shard them. The batch must
    split evenly."""
    parts, idx = (mesh.shape[0], mesh.data_index) if _ingest(ingest) == "slab" else (mesh.size, mesh.rank)
    S = valid.shape[0]
    if S % parts != 0:
        raise ValueError(f"{S} scans do not split over {parts} ranks ({_ingest(ingest)} ingest on mesh {mesh.shape})")
    k = S // parts
    return scans[idx * k:(idx + 1) * k], valid[idx * k:(idx + 1) * k], egos[idx * k:(idx + 1) * k]


def shard_world(world: WorldState, mesh: Mesh) -> WorldState:
    """This rank's y-slab of a logical world, on the rank's device: the
    counterpart of the JAX package's world_pspecs (the grid's y axis over
    `space`, replicated over `data`; origin and valid replicated)."""
    g, dev = world.grid, mesh.device
    rows = _slab_rows(g.hit.shape[1], mesh)

    def cut(t, dim):
        return t.narrow(dim, rows.start, rows.stop - rows.start).to(dev).contiguous()

    return WorldState(grid=VoxelGrid(hit=cut(g.hit, 1), miss=cut(g.miss, 1), min_height=cut(g.min_height, 1),
                                     mom=cut(g.mom, 2), origin=g.origin.to(dev).clone()),
                      evidence=cut(world.evidence, 1), valid=world.valid.to(dev).clone())


def gather_world(slab: WorldState, mesh: Mesh) -> WorldState:
    """The logical world of the slabs of this rank's space group: an
    all_gather over `space` (every rank of the mesh calls it)."""
    g = slab.grid

    def gather(t, dim):
        return mesh.all_gather(t, SPACE_AXIS, dim)

    return WorldState(grid=VoxelGrid(hit=gather(g.hit, 1), miss=gather(g.miss, 1),
                                     min_height=gather(g.min_height, 1), mom=gather(g.mom, 2), origin=g.origin),
                      evidence=gather(slab.evidence, 1), valid=slab.valid)


def make_batched_step(cfg: GvomConfig, device="cuda", mesh: Mesh = None, ingest: str = "auto") -> Callable:
    """Build the step (world, scans [S,N,3], valid [S,N], egos [S,3]) →
    (world, products) on `device`. The inputs are tensors on that device;
    the step returns a new world and leaves the old one untouched.

    With a mesh (parallel/mesh.py), every rank calls the step together, on
    the mesh's device (`device` must be of its type): with its world slab
    [X, Ys, Z] (shard_world; mom [10, X, Ys, Z]) and its shard of the batch
    (shard_batch), and gets its new slab and the full products. `ingest` is
    "slab" (the default, "auto") or "scatter" (the module docstring). The
    grid's y size must divide by the space axis. On the card, a grid past
    the kernels' int32 indexing is refused here (kernels.check_card_limits)
    and a batch past them when the step gets it (kernels.check_batch).

    All scans of a batch rasterize at the LAST scan's origin, so earlier
    egos can sit anywhere in the grid, and the centered-ego DDA budget
    (config.ray_steps) would cut their long rays short. The budget is raised
    to the any-in-grid bound unless the caller pinned one; the raycast ends
    each ray where it dies, so the wider bound admits only live steps.

    The step keeps K2's moment scratch (binning.MomentScratch, made at its
    first call) across its calls, so its calls must run one after another
    on one stream, as the world each returns already orders them."""
    if mesh is None:
        mesh = Mesh.single(device)
    elif torch.device(device).type != mesh.device.type:
        raise ValueError(f"device {device!r} and a mesh on {mesh.device}")
    dev = mesh.device
    slab = _ingest(ingest) == "slab"
    rows = _slab_rows(cfg.xy_size, mesh)
    nsp = mesh.shape[1]
    X, Y, Z = cfg.grid_shape
    Ys = rows.stop - rows.start
    ywin = (rows.start, Ys) if slab and nsp > 1 else None
    scan_axis = DATA_AXIS if slab else None
    if dev.type == "cuda":
        kernels.check_card_limits(cfg, slab=ywin is not None)
        kernels.build_all()      # nvcc at start-up, never inside a step
    if cfg.ray_steps_override is None:
        cfg = dataclasses.replace(cfg, ray_steps_override=max(cfg.xy_size, cfg.z_size) + 4)

    seq = itertools.count()
    multi = mesh.size > 1
    scratch = []

    def step(world: WorldState, scans: torch.Tensor, valid: torch.Tensor,
             egos: torch.Tensor) -> Tuple[WorldState, MapProducts]:
        with annotate("step", next(seq)):
            return _step(world, scans, valid, egos)

    def _step(world, scans, valid, egos):
        for name, t in (("scans", scans), ("valid", valid), ("egos", egos), ("world", world.grid.hit)):
            if t.device.type != dev.type or (dev.index is not None and t.device.index != dev.index):
                raise ValueError(f"{name} is on {t.device}; this step was made for {dev}")
        if tuple(world.grid.hit.shape) != (X, Ys, Z):
            raise ValueError(f"world of shape {tuple(world.grid.hit.shape)}; this rank's slab is {(X, Ys, Z)}")
        S, N = valid.shape
        if dev.type == "cuda":
            kernels.check_batch(S, N)
        with annotate("step/prepare"):
            egos = egos.float().contiguous()
            # ---- the common frame: the origin of the batch's globally last scan ----
            ego_last = mesh.all_gather(egos, scan_axis, 0)[-1]
            origin, pw, keep = prepare_batch(cfg, scans, valid, egos, ego_last)

        # ---- the raycast: one launch, each scan's rays from ITS ego, all
        # adding into one miss grid (this rank's slab under slab ingest) ----
        with annotate("step/raycast"):
            miss = torch.zeros((X, Ys if ywin else Y, Z), dtype=torch.int32, device=dev)
            kernels.ray_pass_counts(cfg, pw.view(S, N, 3), keep.view(S, N), egos, origin, y_window=ywin, out=miss)

        # ---- merged endpoint metrics: ONE pass over the rank's points
        # (binning and moments are ego-free and additive over points). The
        # moments come back raw; the batch's occupancy masks them in the merge ----
        with annotate("step/moments"):
            if not scratch:
                scratch.append(binning.moment_scratch(cfg, dev, ywin))
            bins = kernels.bin_points(cfg, pw, keep, origin, y_window=ywin, scratch=scratch[0])
            del pw, keep    # dead: keep's bytes are free again before K5 and the merge allocate
            hit, minh = bins.hit, bins.min_height
            mom = kernels.moments_epilogue(cfg, bins.n, bins.rest, hit, origin, ywin, occupancy_mask=False)
            del bins

        # ---- the rank's contributions reduced into its slab ----
        with annotate("step/reduce") if multi else contextlib.nullcontext():
            if slab:
                hit, miss, mom = (mesh.all_reduce(t, "sum", DATA_AXIS) for t in (hit, miss, mom))
                minh = mesh.all_reduce(minh, "min", DATA_AXIS)
            else:
                hit, miss = (mesh.all_reduce(mesh.reduce_scatter(t, SPACE_AXIS, 1), "sum", DATA_AXIS)
                             for t in (hit, miss))
                mom = mesh.all_reduce(mesh.reduce_scatter(mom, SPACE_AXIS, 2), "sum", DATA_AXIS)
                minh = mesh.all_reduce(minh, "min")[:, rows].contiguous()
        contrib = VoxelGrid(hit=hit, miss=miss, min_height=minh, mom=mom, origin=origin)

        # ---- merge with the world slab and the column maps (one kernel, in
        # place over the contribution), then the 2D maps on the gathered
        # [X, X] maps: the plane fit, then the guess height with the maps after it ----
        with annotate("step/merge"):
            merged, evidence, cols, bands = kernels.merge_batch(cfg, world, contrib, ego_last, rows.start)
        with annotate("step/maps"):
            cols = mesh.all_gather(cols, SPACE_AXIS, 2)
            bands = mesh.all_gather(bands, SPACE_AXIS, 2)
            hm, ihm, rough, sx, sy = kernels.plane_fit(cfg, cols[0], cols[1], origin)
            ghd, pos, neg, vis = kernels.guess_height(cfg, hm, ihm, sx, sy, bands[0], bands[1], bands[2], origin)
        products = MapProducts(
            origin=origin, height=hm, inferred_height=ihm, slope_x=sx, slope_y=sy, roughness=rough,
            guessed_height_delta=ghd, positive_obstacle=pos, negative_obstacle=neg, visibility=vis)
        new_world = WorldState(grid=merged, evidence=evidence,
                               valid=torch.ones((), dtype=torch.bool, device=dev))
        return new_world, products

    return step


def batched_step(cfg: GvomConfig, world, scans, valid, egos, device="cuda", mesh: Mesh = None,
                 ingest: str = "auto"):
    """One step of make_batched_step(cfg, device, mesh, ingest)."""
    return make_batched_step(cfg, device, mesh, ingest)(world, scans, valid, egos)
