"""The kernels' least times on one H100: the bytes and operations that this
cell's data needs, whatever implements it.

The arithmetic is chip_smoke.py's (`prep_bound`, `k1_bound`, `k2_bound`,
`epilogue_bound`, `combine_bound`, `merge_bound`, `plane_fit_bound`,
`guess_bound`), copied here so that a change to the program cannot move it.
A bound is the larger of bytes over the memory rate and operations over
the float32 rate; each input byte is counted read once and each output byte
written once, and only what the data needs.
"""

from __future__ import annotations

import torch

from benchmark.reference import grid as gridops
from benchmark.reference.binning import moment_pad
from benchmark.reference.pipeline import merge_batch_plain

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "bound_ms", "prep_bound", "k1_bound", "k2_bound", "epilogue_bound",
           "combine_bound", "merge_bound", "plane_fit_bound", "guess_bound", "replay_step_bounds"]

HBM_BYTES_PER_S = 3.35e12   # H100 SXM memory rate (NVIDIA's data sheet, at 700 W)
F32_OPS_PER_S = 67e12       # H100 SXM float32 rate outside the tensor cores
PREP_OPS = 16               # f32 operations of the preparation a point: d², its test, voxel, bounds
PLANE_FIT_OPS = 150         # f32 operations of the whole plane fit a cell
GUESS_OPS = 13              # f32 operations of the guess and its products a cell
MERGE_OPS = 40              # f32 and int operations of the merge a voxel
F32 = 4


def bound_ms(nbytes: float, ops_s: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, ops_s)


def prep_bound(n_points: int, n_scans: int):
    """The preparation: points (12 bytes) and valid (1) read, keep (1)
    written, the egos, the origin and scan_ok; PREP_OPS a point."""
    return n_points * 14 + n_scans * 13 + 2 * 12, n_points * PREP_OPS / F32_OPS_PER_S


def k1_bound(n_points: int, n_scans: int, n_rays: int, n_pass: int, n_out: int):
    """K1: points and keep read, each scan's ego, the grid written once;
    about 40 f32 operations a ray and 8 a live step."""
    return n_points * 13 + n_scans * 12 + n_out * 4, (40 * n_rays + 8 * n_pass) / F32_OPS_PER_S


def k2_bound(n_points: int, n_kept: int, n_out: int, n_scratch: int, n_scratch_nz: int):
    """K2: points and keep read; hit and min_height written over the grid,
    n over the scratch and the nine other channels where n > 0; about 30
    f32 operations a kept point."""
    return n_points * 13 + 2 * n_out * 4 + n_scratch * 4 + 9 * n_scratch_nz * 4, 30 * n_kept / F32_OPS_PER_S


def box_counts(t: torch.Tensor, r):
    """Sums of t over every (2r + 1) box inside it, by int64 prefix sums."""
    t = t.to(torch.int64)
    for ax, q in enumerate(r):
        c = t.cumsum(ax)
        c = torch.cat([torch.zeros_like(c.narrow(ax, 0, 1)), c], ax)
        n = t.shape[ax] - 2 * q
        t = c.narrow(ax, 2 * q + 1, n) - c.narrow(ax, 0, n)
    return t


def epilogue_bound(cfg, n_w: torch.Tensor, targets_w: torch.Tensor, n_out: int, mask: bool):
    """K3 / K5 on the padded own-voxel counts n_w: ten channels written, hit
    read when it masks, n read over the voxels that a target's box reaches
    and the nine other channels where n > 0 there; about 52 operations a
    (target, non-empty neighbour) term. Returns (bytes, ops seconds)."""
    r = moment_pad(cfg)
    pad = lambda t: torch.nn.functional.pad(t, (r[2], r[2], r[1], r[1], r[0], r[0]))
    reach = box_counts(pad(pad(targets_w.to(torch.int32))), r) > 0
    nz = n_w > 0
    n_reach, n_reach_nz = int(reach.sum()), int((reach & nz).sum())
    terms = int(box_counts(nz, r)[targets_w].sum())
    nbytes = (n_out * F32 if mask else 0) + 10 * n_out * F32 + n_reach * F32 + 9 * n_reach_nz * F32
    return nbytes, 52 * terms / F32_OPS_PER_S


def combine_bound(cfg, buf, world, target: torch.Tensor, new_hit: torch.Tensor):
    """K4, as its plain version reads its inputs: each slot's hit, miss and
    moments where aligned and valid, its min_height where also occupied;
    the old world's hit and evidence where aligned, its miss and min_height
    where its occupied voxel stays occupied, its moments where aligned and
    the new world occupied; the 14 channels and five [X, Y] maps written.
    Returns (bytes, ops seconds)."""
    X, Y, Z = cfg.grid_shape
    V, B = X * Y * Z, cfg.buffer_size
    g, w = buf.grids, world.grid
    if not bool(buf.slot_valid.any()):
        words = 14 * V
    else:
        words = 0
        for i in range(B):
            al = gridops.overlap_mask(cfg, target, g.origin[i]) & buf.slot_valid[i]
            words += 12 * int(al.sum()) + int((al & (g.hit[i] > 0)).sum())
        oal = gridops.overlap_mask(cfg, target, w.origin) & world.valid
        occ = new_hit > 0
        words += (2 * int(oal.sum()) + 2 * int((oal & (w.hit > 0) & occ).sum()) + 10 * int((oal & occ).sum()))
    words += (B + 2) * 4 + 3 + 14 * V + 5 * X * Y
    return words * F32, 0.0


def merge_bound(cfg, world, contrib):
    """The batched merge: the batch's hit, miss and min_height everywhere
    and its moments where it occupies; the old world's hit and evidence
    where the windows overlap and it is valid, its miss and min_height where
    its occupied voxel stays occupied, its moments where the windows overlap
    and the merged voxel is occupied; 14 channels and five [X, Y] maps
    written. Returns (bytes, ops seconds)."""
    X, Y, Z = contrib.hit.shape
    V = X * Y * Z
    _, _, occ2 = merge_batch_plain(cfg, world, contrib)
    om = gridops.overlap_mask(cfg, contrib.origin, world.grid.origin)
    ow = om & world.valid
    words = (3 * V + 10 * int((contrib.hit > 0).sum()) + 2 * int(ow.sum())
             + 2 * int((ow & (world.grid.hit > 0) & occ2).sum()) + 10 * int((om & occ2).sum())
             + 14 * V + 5 * X * Y + 3 + 3 + 3 + 1)
    return words * F32, MERGE_OPS * V / F32_OPS_PER_S


def plane_fit_bound(n_cells: int):
    """The plane fit with the window layout as its load: 8 bytes a cell
    read, 20 written; PLANE_FIT_OPS a cell."""
    return n_cells * 28 + 12, n_cells * PLANE_FIT_OPS / F32_OPS_PER_S


def guess_bound(n_cells: int):
    """The guess height with the maps' products: 28 bytes a cell read, 16
    written; GUESS_OPS a cell."""
    return n_cells * 44 + 12, n_cells * GUESS_OPS / F32_OPS_PER_S


def replay_step_bounds(cfg, world_in, parts, scans_shape) -> dict:
    """bound_ms of each port kernel of one batched step, by the kernel
    groups of benchmark.trace.PORT_KERNELS."""
    S, N = scans_shape
    V = cfg.voxel_count
    keep, c = parts.keep, parts.contrib
    n_kept = int(keep.sum())
    targets = torch.ones(cfg.grid_shape, dtype=torch.bool, device=keep.device)   # the mask off: every voxel
    cells = cfg.xy_size * cfg.xy_size
    return {
        "prepare": bound_ms(*prep_bound(S * N, S)),
        "raycast": bound_ms(*k1_bound(S * N, S, n_kept, int(c.miss.sum()), V)),
        "binning": bound_ms(*k2_bound(S * N, n_kept, V, parts.sums_n.numel(), int((parts.sums_n > 0).sum()))),
        "epilogue": bound_ms(*epilogue_bound(cfg, parts.sums_n, targets, V, False)),
        "merge": bound_ms(*merge_bound(cfg, world_in, c)),
        "plane_fit": bound_ms(*plane_fit_bound(cells)),
        "guess": bound_ms(*guess_bound(cells)),
    }
