"""The mapping pipeline: one scan's ingest into the ring buffer, and the
combine of the buffer with the previous world map.

Counterpart of gvom_tpu/models/pipeline.py (the reference's
process_pointcloud + combine_maps, gvom.py:99-354):
  * ingest_scan        voxelize one scan into a VoxelGrid of its own
                       (kernels K1, K2, K5), in a pinned frame or for a
                       y-slab if asked;
  * ingest_and_insert  voxelize one scan straight into its ring-buffer slot
                       (kernels K1, K2, K3);
  * buffer_insert      write an already voxelized scan into the buffer;
  * combine            fuse the buffer and the previous world (kernel K4),
                       then derive the 2D maps (the stencil and map-tail
                       kernels);
  * full_step          ingest_and_insert + combine.

The buffer is updated IN PLACE: its tensors are written at a slot index that
is computed on the device (the cursor, or the write-off slot B when the scan
is degenerate), so no step waits for the host. The combine returns a new
world and leaves its inputs untouched. Degenerate inputs (empty cloud, no
occupied voxel, empty buffer; reference warnings at gvom.py:107-109,
148-150, 179-181) are masked no-ops flagged by boolean tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import binning, kernels, maps2d
from gvom_tpu_torch.ops import grid as gridops
from gvom_tpu_torch.ops import raycast
from gvom_tpu_torch.types import BufferState, MapProducts, VoxelGrid, WorldState

__all__ = ["ingest_scan", "buffer_insert", "ingest_and_insert", "fuse_plain", "combine", "full_step"]


def _write_slot(stacked: torch.Tensor, slot: torch.Tensor, leaf: torch.Tensor) -> None:
    stacked.index_copy_(0, slot.reshape(1).long(), leaf.unsqueeze(0))


def _advance(cfg: GvomConfig, buf: BufferState, scan_ok: torch.Tensor) -> None:
    """Ring-buffer bookkeeping after a write (gvom.py:163-175), in place."""
    cur = buf.cursor.reshape(1).long()
    buf.slot_valid.index_copy_(0, cur, buf.slot_valid.index_select(0, cur) | scan_ok.reshape(1))
    nxt = torch.where(scan_ok, torch.remainder(buf.cursor + 1, cfg.buffer_size), buf.cursor)
    buf.last_slot.copy_(torch.where(scan_ok, buf.cursor, buf.last_slot))
    buf.cursor.copy_(nxt)


def _target_slot(cfg: GvomConfig, buf: BufferState, scan_ok: torch.Tensor) -> torch.Tensor:
    """The slot a scan is written to: the cursor, or the write-off slot B."""
    return torch.where(scan_ok, buf.cursor, torch.full_like(buf.cursor, cfg.buffer_size)).to(torch.int32)


def _prepare(cfg: GvomConfig, points, valid, ego, transform, origin=None):
    """One scan's (p [N,3] world frame, keep [N], origin, scan_ok) from the
    point-preparation kernel (the plain twin on the CPU); the origin is the
    pinned one, or the ego's."""
    p, keep, origin, scan_ok = kernels.prepare_points(
        cfg, points.float().contiguous()[None], valid.contiguous()[None], ego.reshape(1, 3).contiguous(),
        frame_ego=ego.contiguous() if origin is None else None, origin=origin,
        transform=None if transform is None else transform.float().contiguous())
    return p[0], keep[0], origin, scan_ok[0]


def ingest_scan(
    cfg: GvomConfig,
    points: torch.Tensor,
    valid: torch.Tensor,
    ego_position: torch.Tensor,
    transform: Optional[torch.Tensor] = None,
    origin: Optional[torch.Tensor] = None,
    y_window=None,
) -> Tuple[VoxelGrid, torch.Tensor]:
    """One scan → dense voxel map. Returns (grid, scan_ok).

    scan_ok is False when the scan produced no occupied voxel; the
    reference drops such scans without buffering them (gvom.py:148-150).
    `origin` pins the map frame (a batched replay rasterizes every scan into
    one common frame); the default is the reference's ego-centered origin.
    `y_window` = (ys0, Ys) restricts every accumulated array to that torus
    y-slab: the grid channels come back [X, Ys, Z] / [10, X, Ys, Z] and
    scan_ok refers to the slab. The moments are occupancy-masked: stored
    zero wherever hit == 0, since every consumer reads them under hit > 0."""
    ego = ego_position.float()
    p, keep, origin, _ = _prepare(cfg, points, valid, ego, transform, origin)
    passes = raycast.ray_pass_counts(cfg, p, keep, ego, origin, y_window=y_window)
    hit, min_height, mom = kernels.point_moments(cfg, p, keep, origin, y_window=y_window)
    grid = VoxelGrid(hit=hit, miss=passes, min_height=min_height, mom=mom, origin=origin)
    return grid, (hit > 0).any()


def buffer_insert(cfg: GvomConfig, buf: BufferState, grid: VoxelGrid, scan_ok: torch.Tensor) -> BufferState:
    """Ring-buffer write (gvom.py:163-175), in place: every channel of `grid`
    goes into slot `cursor`, or into the write-off slot B when the scan is
    degenerate, so the write is unconditional. Returns `buf`."""
    slot = _target_slot(cfg, buf, scan_ok)
    g = buf.grids
    for stacked, leaf in ((g.hit, grid.hit), (g.miss, grid.miss), (g.min_height, grid.min_height),
                          (g.mom, grid.mom), (g.origin, grid.origin)):
        _write_slot(stacked, slot, leaf)
    _advance(cfg, buf, scan_ok)
    return buf


def ingest_and_insert(
    cfg: GvomConfig,
    buf: BufferState,
    points: torch.Tensor,
    valid: torch.Tensor,
    ego_position: torch.Tensor,
    transform: Optional[torch.Tensor] = None,
) -> Tuple[BufferState, torch.Tensor]:
    """Voxelize one scan straight into the ring buffer, in place. Returns
    (buf, scan_ok).

    scan_ok ("the scan has at least one occupied voxel", gvom.py:148-150) is
    decided up front from the in-grid endpoints, so the slot is known before
    any channel is written: the cursor, or the write-off slot B. The slot
    index stays on the device; kernel K3 reads it there and writes the
    moments straight into buf.grids.mom[slot], and the other channels are
    indexed copies into the same slot. Nothing here waits for the host.
    K2's scratch (buf.moments) is made at the first call and kept."""
    ego = ego_position.float()
    p, keep, origin, scan_ok = _prepare(cfg, points, valid, ego, transform)
    slot = _target_slot(cfg, buf, scan_ok)

    passes = raycast.ray_pass_counts(cfg, p, keep, ego, origin)
    if buf.moments is None:
        buf.moments = binning.moment_scratch(cfg, p.device)
    bins = kernels.bin_points(cfg, p, keep, origin, scratch=buf.moments)
    g = buf.grids
    kernels.ingest_epilogue(cfg, bins.n, bins.rest, bins.hit, origin, g.mom, slot)
    for stacked, leaf in ((g.hit, bins.hit), (g.miss, passes), (g.min_height, bins.min_height),
                          (g.origin, origin)):
        _write_slot(stacked, slot, leaf)
    _advance(cfg, buf, scan_ok)
    return buf, scan_ok


# ----------------------------------------------------------------------
# combine


def fuse_plain(cfg: GvomConfig, buf: BufferState, world: WorldState, origin: torch.Tensor, ego: torch.Tensor):
    """Plain twin of kernel K4: fuse the B buffer slots and the old world
    into the new world's channels, and take the per-column products.

    Slot order and the occupied-wins / evidence latching / staleness-veto
    semantics follow gvom.py:198-266 and 941-997, in the arithmetic of
    gvom_tpu/models/pipeline.py::combine (impl="xla"). Returns (hit, miss,
    min_height, evidence, mom) of the new world with the any_valid latch
    applied (no valid slot: the old world passes through), and the torus
    [X, Y] column products (height, inferred height, positive-obstacle band
    hit sum, band total sum, band_ok) of the pre-latch fusion."""
    dev = origin.device
    B = cfg.buffer_size
    any_valid = buf.slot_valid.any()
    g = buf.grids
    masks = [gridops.overlap_mask(cfg, origin, g.origin[i]) & buf.slot_valid[i] for i in range(B)]

    # ---- phase A: occupancy + negative evidence (slot order latches) ----
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

    # ---- phase B: data fusion where source and target are occupied ----
    hit = torch.zeros(cfg.grid_shape, dtype=torch.int32, device=dev)
    miss = torch.zeros_like(hit)
    min_height = torch.ones(cfg.grid_shape, dtype=torch.float32, device=dev)
    mom = torch.zeros_like(old.mom)
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    # slot moments are occupancy-pre-masked at ingest, so their merge mask is
    # alignment ∧ validity; the old world's adds the new occupancy
    sources = [(g.hit[i], g.miss[i], g.min_height[i], g.mom[i], s_occs[i], masks[i]) for i in range(B)]
    sources.append((old.hit, old.miss, old.min_height, old.mom, old_occ & occ, old_mask & occ))
    for s_hit, s_miss, s_minh, s_mom, sel, mom_mask in sources:
        hit = hit + torch.where(sel, s_hit, zero_i)
        miss = miss + torch.where(sel, s_miss, zero_i)
        min_height = torch.where(sel, torch.minimum(min_height, s_minh), min_height)
        mom = mom + torch.where(mom_mask, s_mom, zero_f)

    # ---- per-column products of the pre-latch fusion ----
    hm_t = maps2d.height_map(cfg, occ, min_height, origin, ego)
    ihm_t = maps2d.inferred_height_map(cfg, occ, evidence, origin)
    pnum, pden, band_ok = maps2d.positive_band_sums(cfg, occ, hit, hit + miss, hm_t, origin)

    # ---- any_valid latch: with no valid slot the old world passes through ----
    outs = tuple(torch.where(any_valid, new, prev) for new, prev in (
        (hit, old.hit), (miss, old.miss), (min_height, old.min_height), (evidence, world.evidence),
        (mom, old.mom)))
    return outs + (hm_t, ihm_t, pnum, pden, band_ok)


def combine(
    cfg: GvomConfig,
    buf: BufferState,
    world: WorldState,
    ego_position: torch.Tensor,
) -> Tuple[WorldState, MapProducts, torch.Tensor]:
    """Fuse the buffered scans and the decayed previous world, and derive the
    2D maps (gvom.py:177-354). Returns (new world, products, combine_ok);
    combine_ok is False when the buffer holds no valid scan, and then the
    new world is the old one.

    The fusion and the per-column products are kernel K4 (the plain twin
    fuse_plain on the CPU); then two kernels derive the 2D maps: the plane
    fit, which moves the height maps to the window layout as it loads them,
    and the guess height, which computes the obstacle maps and the
    visibility as its epilogue."""
    ego = ego_position.float()
    origin = buf.grids.origin.index_select(0, buf.last_slot.reshape(1).long())[0]
    any_valid = buf.slot_valid.any()
    hit, miss, minh, evidence, mom, hm_t, ihm_t, pnum, pden, band_ok = kernels.combine(
        cfg, buf, world, origin, ego)
    grid = VoxelGrid(hit=hit, miss=miss, min_height=minh, mom=mom,
                     origin=torch.where(any_valid, origin, world.grid.origin))
    new_world = WorldState(grid=grid, evidence=evidence, valid=world.valid | any_valid)

    hm, ihm, rough, slope_x, slope_y = kernels.plane_fit(cfg, hm_t, ihm_t, origin)
    ghd, pos, neg, vis = kernels.guess_height(cfg, hm, ihm, slope_x, slope_y, pnum, pden, band_ok, origin)
    products = MapProducts(
        origin=origin,
        height=hm,
        inferred_height=ihm,
        slope_x=slope_x,
        slope_y=slope_y,
        roughness=rough,
        guessed_height_delta=ghd,
        positive_obstacle=pos,
        negative_obstacle=neg,
        visibility=vis,
    )
    return new_world, products, any_valid


def full_step(
    cfg: GvomConfig,
    buf: BufferState,
    world: WorldState,
    points: torch.Tensor,
    valid: torch.Tensor,
    ego_position: torch.Tensor,
    transform: Optional[torch.Tensor] = None,
) -> Tuple[BufferState, WorldState, MapProducts, torch.Tensor]:
    """Ingest one scan and run one combine: the reference's sensor callback
    and timer callback as one step. The buffer is updated in place."""
    buf, scan_ok = ingest_and_insert(cfg, buf, points, valid, ego_position, transform)
    world, products, ok = combine(cfg, buf, world, ego_position)
    return buf, world, products, ok & (scan_ok | buf.slot_valid.any())
