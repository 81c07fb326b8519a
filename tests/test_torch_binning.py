"""K2's contract of its kept scratch on the CPU, through its plain twin
(binning.bin_points with a MomentScratch): between calls the scratch's
channels 1-9 are zero wherever its touched byte is 0; after a call they hold
the call's sums where n > 0 and zero elsewhere, the touched bytes are those
voxels, and the bins equal those on a fresh scratch bit for bit, whatever
the scratch held from earlier calls. The epilogues of a kept scratch give
what a fresh one gives, and the batched step and the ring buffer's ingest,
which keep one scratch across their calls, give what fresh ones give. Also
the stats twin (binning.bin_stats_plain) on batches whose counts are known.
Every case runs at small_cfg."""

import dataclasses

import numpy as np
import pytest
import torch

from gvom_tpu_torch.io import synthetic
from gvom_tpu_torch.models import pipeline
from gvom_tpu_torch.ops import binning, kernels
from gvom_tpu_torch.ops import grid as gridops
from gvom_tpu_torch.parallel import make_batched_step
from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

from torch_helpers import tcfg

S = 4


def scans(cfg, first, s=S, n_az=48, channels=16):
    """[s·N, 3] world points, keep [s·N] (each scan's returns first, then
    its padding), egos [s, 3] of s scans of a short drive from scan `first`."""
    pts, keep, egos = [], [], []
    for k in range(first, first + s):
        ego = np.array([0.3, -0.2, 1.5]) + k * np.array([0.4, 0.25, 0.0])
        p = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego, channels=channels, azimuth_steps=n_az,
                                          max_range=12.0, seed=k)
        pad, mask = synthetic.pad_scan(p, cfg.max_points)
        pts.append(pad)
        keep.append(mask)
        egos.append(ego.astype(np.float32))
    return (torch.from_numpy(np.concatenate(pts)).float(), torch.from_numpy(np.concatenate(keep)),
            torch.from_numpy(np.stack(egos)))


def windows(cfg):
    """None, a quarter slab, and a slab across the window seam of the origin
    of scans(cfg, 0)'s last ego."""
    return [None, (16, 16), (cfg.xy_size - 8, 8)]


@pytest.mark.parametrize("w", [0, 1, 2])
def test_kept_scratch_twin_equals_a_fresh_one(small_cfg, w):
    """Three point sets in turn on one scratch: after each call the bins
    equal those on a fresh scratch bit for bit, channels 1-9 are zero where
    n is 0, and the touched bytes are 1 at the voxels with n > 0."""
    cfg = tcfg(small_cfg)
    y_window = windows(cfg)[w]
    scratch = binning.moment_scratch(cfg, "cpu", y_window)
    for first in (0, 6, 0):
        pts, keep, egos = scans(cfg, first)
        origin = gridops.compute_origin(cfg, egos[-1])
        kept = binning.bin_points(cfg, pts, keep, origin, y_window, scratch)
        fresh = binning.bin_points(cfg, pts, keep, origin, y_window)
        assert kept.n.shape == (1,) + binning.padded_shape(cfg, y_window)
        assert kept.rest is scratch.rest and fresh.rest is not scratch.rest
        assert torch.equal(kept.hit, fresh.hit) and torch.equal(kept.min_height, fresh.min_height)
        assert torch.equal(kept.sums, fresh.sums)
        live = fresh.n[0].reshape(-1) > 0
        assert live.any() and not live.all()
        assert not scratch.rest.reshape(9, -1)[:, ~live].any()
        assert torch.equal(scratch.touched.view(-1), live.to(torch.uint8))


def test_one_pass_twin_clears_only_the_touched_voxels(small_cfg):
    """The twin puts channels 1-9 back to zero only where the touched bytes
    say: a value they do not record stays (the scratch must start zero),
    and a recorded one goes. (The kernel clears the 32-byte sectors around
    them, which the contract keeps zero.)"""
    cfg = tcfg(small_cfg)
    pts, keep, egos = scans(cfg, 0)
    origin = gridops.compute_origin(cfg, egos[-1])
    live = binning.bin_points(cfg, pts, keep, origin).sums[0].reshape(-1) > 0
    dead = int(torch.nonzero(~live)[0])
    scratch = binning.moment_scratch(cfg, "cpu")
    flat = scratch.rest.view(9, -1)
    flat[3, dead] = 5.0
    binning.bin_points(cfg, pts, keep, origin, scratch=scratch)
    assert flat[3, dead] == 5.0
    scratch.touched.view(-1)[dead] = 1
    binning.bin_points(cfg, pts, keep, origin, scratch=scratch)
    assert flat[3, dead] == 0.0
    assert not flat[:, ~live].any()


@pytest.mark.parametrize("w", [0, 1, 2])
def test_moment_scratch_shapes(small_cfg, w):
    """A fresh scratch: channels 1-9 and a touched byte a voxel of the sums
    scratch's shape (a slab's Ys + 4ry rows), all zero."""
    cfg = tcfg(small_cfg)
    y_window = windows(cfg)[w]
    scratch = binning.moment_scratch(cfg, "cpu", y_window)
    shape = binning.padded_shape(cfg, y_window)
    assert scratch.rest.shape == (9,) + shape and scratch.rest.dtype == torch.float32
    assert scratch.touched.shape == shape and scratch.touched.dtype == torch.uint8
    assert not scratch.rest.any() and not scratch.touched.any()


@pytest.mark.parametrize("w", [0, 1, 2])
def test_epilogues_of_a_kept_scratch_equal_a_fresh_ones(small_cfg, w):
    """K5 (mask on and off) and, on the full grid, K3 on the bins of a
    scratch that binned other scans first give what they give on a fresh
    scratch's bins; K3's slot is K5's with the mask on."""
    cfg = tcfg(small_cfg)
    y_window = windows(cfg)[w]
    scratch = binning.moment_scratch(cfg, "cpu", y_window)
    binning.bin_points(cfg, *scans(cfg, 6)[:2], gridops.compute_origin(cfg, scans(cfg, 6)[2][-1]), y_window, scratch)
    pts, keep, egos = scans(cfg, 0)
    origin = gridops.compute_origin(cfg, egos[-1])
    kept = binning.bin_points(cfg, pts, keep, origin, y_window, scratch)
    fresh = binning.bin_points(cfg, pts, keep, origin, y_window)
    for mask in (True, False):
        got = kernels.moments_epilogue(cfg, kept.n, kept.rest, kept.hit, origin, y_window, mask)
        assert torch.equal(got, kernels.moments_epilogue(cfg, fresh.n, fresh.rest, fresh.hit, origin, y_window, mask))
        assert got[0].sum() > 0
    if y_window is None:
        out = torch.zeros((2, 10) + cfg.grid_shape)
        kernels.ingest_epilogue(cfg, kept.n, kept.rest, kept.hit, origin, out, torch.tensor([1], dtype=torch.int32))
        assert torch.equal(out[1], kernels.moments_epilogue(cfg, fresh.n, fresh.rest, fresh.hit, origin))
        assert not out[0].any()


def test_batched_step_scratch_carries_nothing_between_steps(small_cfg):
    """A step that bins other scans first (its scratch touched) gives the
    same world and products as a fresh step on the same input world."""
    cfg = tcfg(small_cfg)

    def batch(first):
        pts, keep, egos = scans(cfg, first)
        N = cfg.max_points
        return pts.view(S, N, 3), keep.view(S, N), egos

    step = make_batched_step(cfg, "cpu")
    world, _ = step(empty_world_state(cfg, "cpu"), *batch(0))
    used, used_products = step(world, *batch(6))
    fresh, fresh_products = make_batched_step(cfg, "cpu")(world, *batch(6))
    for a, b in ((used.grid, fresh.grid), (used_products, fresh_products)):
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f.name
    assert torch.equal(used.evidence, fresh.evidence)
    assert used.grid.hit.sum() > 0


def test_ring_buffer_scratch_carries_nothing_between_scans(small_cfg):
    """The ring buffer's ingest makes K2's scratch at its first scan and
    keeps it; a scan ingested after others writes the slot that a fresh
    buffer's first ingest of it writes."""
    cfg = tcfg(small_cfg)
    N = cfg.max_points
    pts, keep, egos = scans(cfg, 0)
    used = empty_buffer_state(cfg, "cpu")
    assert used.moments is None
    for s in (1, 2):
        pipeline.ingest_and_insert(cfg, used, pts[s * N:(s + 1) * N], keep[s * N:(s + 1) * N], egos[s])
    made = used.moments
    assert made is not None and made.touched.any()
    fresh = empty_buffer_state(cfg, "cpu")
    for buf in (used, fresh):
        pipeline.ingest_and_insert(cfg, buf, pts[:N], keep[:N], egos[0])
    assert used.moments is made
    slot_used, slot_fresh = int(used.last_slot), int(fresh.last_slot)
    for name in ("hit", "min_height", "mom", "origin"):
        a, b = getattr(used.grids, name)[slot_used], getattr(fresh.grids, name)[slot_fresh]
        assert torch.equal(a, b), name
    assert used.grids.hit[slot_used].sum() > 0


def test_bin_stats_counts_blocks_and_flushes(small_cfg):
    """The stats twin on S scans whose returns fill the first slots of
    each scan: a block of a scan's whole padding is empty; one slot a block
    flushes once a point; one block over everything flushes once a voxel;
    the atomics follow the flushes."""
    cfg = tcfg(small_cfg)
    N = cfg.max_points
    pts, keep, egos = scans(cfg, 0)
    origin = gridops.compute_origin(cfg, egos[-1])
    returns = keep.view(S, N).sum(dim=1)
    assert (returns < N // 2).all() and keep.view(S, N)[:, N // 2:].sum() == 0
    half = binning.bin_stats_plain(cfg, pts, keep, origin, block=N // 2, n_scans=S)
    assert (half["slots"], half["kept"], half["blocks"], half["empty_blocks"]) == (S * N, int(keep.sum()), 2 * S, S)

    bins = binning.bin_points(cfg, pts, keep, origin)
    vox = gridops.floor_i32(gridops.map_local(cfg, pts, origin))
    in_grid = int((keep & gridops.in_bounds(cfg, vox)).sum())
    in_window = int(sum(sel.sum() for sel, _ in binning.scratch_pieces(cfg, vox, keep, origin)))
    one = binning.bin_stats_plain(cfg, pts, keep, origin, block=1, n_scans=S)
    assert one["flushes"] == dict(torus=in_grid, window=in_window)
    assert one["empty_blocks"] == S * N - in_window
    whole = binning.bin_stats_plain(cfg, pts, keep, origin, block=N, scans=S, n_scans=S)
    voxels = int((bins.n > 0).sum())
    assert whole["flushes"] == dict(torus=int((bins.hit > 0).sum()), window=voxels)
    assert whole["window_voxels"] == voxels and whole["blocks"] == 1
    k = binning.bin_stats_plain(cfg, pts, keep, origin, n_scans=S)
    assert k["atomics"] == 2 * k["flushes"]["torus"] + 10 * k["flushes"]["window"]
    assert whole["flushes"]["window"] <= k["flushes"]["window"] <= one["flushes"]["window"]
