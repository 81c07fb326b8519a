"""The benchmark's frozen copy of the port's plain PyTorch version of this stage, which the
benchmark's comparison holds the port against; it imports nothing of the port.

Point → voxel accumulation (the reference's endpoint binning
gvom.py:1084-1090, min height gvom.py:1301-1329, and the per-voxel raw stage
of the metrics pipeline gvom.py:1170-1299).

`prepare_plain` is the point preparation: the min-distance filter, the grid
origin, and each scan's scan_ok. `bin_points` is the endpoint binning: hit
counts and min sub-voxel z in the torus layout, and the ten OWN-voxel raw
moment sums on a grid padded by the eigen support radius in the window
layout. The reference expands each point into neighbors without checking
the point's own voxel bounds (gvom.py:1184-1202), so points just outside
the window feed border voxels: hence the padding. The neighborhood box
itself is reference/moments.py.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from benchmark.reference import grid as gridops
from benchmark.reference.config import GvomConfig

__all__ = ["PAIRS", "PointBins", "prepare_plain", "bin_points", "moment_pad", "padded_shape", "sum_sq3"]

# second-moment pairs, in channel order (xx, xy, xz, yy, yz, zz)
PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def moment_pad(cfg: GvomConfig) -> Tuple[int, int, int]:
    return (cfg.xy_eigen_dist, cfg.xy_eigen_dist, cfg.z_eigen_dist)


def padded_shape(cfg: GvomConfig) -> Tuple[int, int, int]:
    """Shape of the own-voxel sums scratch: the grid padded by the eigen radii."""
    return tuple(s + 2 * p for s, p in zip(cfg.grid_shape, moment_pad(cfg)))


class PointBins(NamedTuple):
    """One point set's bins. `sums` holds the own-voxel raw sums (n, S1,
    R2) in the padded window layout; channels 1-9 are zero where n is."""

    hit: torch.Tensor         # [X,Y,Z] int32, torus layout
    min_height: torch.Tensor  # [X,Y,Z] f32, torus layout (1.0 where no point)
    sums: torch.Tensor        # [10, X+2rx, Y+2ry, Z+2rz] — own-voxel raw sums, padded window layout


def sum_sq3(v: torch.Tensor) -> torch.Tensor:
    """v0² + v1² + v2² per row, rounded as the reference's compiled
    jnp.sum(v*v, axis=1): two fused multiply-adds onto v0²."""
    return gridops.fma32(v[:, 2], v[:, 2], gridops.fma32(v[:, 1], v[:, 1], v[:, 0] * v[:, 0]))


def prepare_plain(cfg: GvomConfig, points: torch.Tensor, valid: torch.Tensor, egos: torch.Tensor,
                  frame_ego: torch.Tensor, drop_dead: bool = False):
    """S scans (points [S,N,3] world frame, valid [S,N], each scan's ego
    [S,3]) → (p [S,N,3], keep [S,N], origin [3] int32, scan_ok [S]).

    keep is valid and the min-distance filter (gvom.py:1064-1068: the
    world-frame norm, the reference's quirk, unless
    cfg.ego_relative_min_distance); the origin is compute_origin(frame_ego);
    scan_ok[s] is whether scan s keeps an endpoint inside that window.
    drop_dead also takes a dead scan's points out of keep."""
    S, N = valid.shape
    origin = gridops.compute_origin(cfg, frame_ego)
    p = points.float().reshape(-1, 3)
    if cfg.ego_relative_min_distance:
        d2 = sum_sq3(p - egos.float()[:, None, :].expand(S, N, 3).reshape(-1, 3))
    else:
        d2 = sum_sq3(p)
    md = torch.tensor(cfg.min_distance, dtype=torch.float32)
    keep = valid.reshape(-1) & (d2 >= float(md * md))
    vox = gridops.floor_i32(gridops.map_local(cfg, p, origin))
    scan_ok = (keep & gridops.in_bounds(cfg, vox)).view(S, N).any(dim=1)
    keep = keep.view(S, N)
    if drop_dead:
        keep = keep & scan_ok[:, None]
    return p.view(S, N, 3), keep, origin, scan_ok


def bin_points(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, origin: torch.Tensor,
               dtype=torch.float32) -> PointBins:
    """Dense binning of a point set [N,3] in the world frame, at map-local
    voxel coordinates pn = points/res − origin (grid.map_local). `dtype`
    holds each point's moment terms and their sums."""
    pn = gridops.map_local(cfg, points, origin)
    dev = pn.device
    X, Y, Z = cfg.grid_shape
    vox = torch.floor(pn).to(torch.int32)
    local = pn - vox.float()                           # sub-voxel coords in [0,1)

    # ---- endpoint hit counts + min height (in-bounds points; torus layout) ----
    size = gridops.size_vector(cfg, dev)
    vt = torch.remainder(vox + origin[None, :], size[None, :])
    inb = keep & gridops.in_bounds(cfg, vox)
    flat = ((vt[:, 0] * Y + vt[:, 1]) * Z + vt[:, 2])[inb].long()
    hit = torch.bincount(flat, minlength=X * Y * Z).to(torch.int32)
    mh = torch.ones(X * Y * Z, dtype=torch.float32, device=dev)
    mh.scatter_reduce_(0, flat, local[inb, 2], reduce="amin", include_self=True)

    # ---- own-voxel raw moments on the padded window grid ----
    rx, ry, rz = moment_pad(cfg)
    Xp, Yp, Zp = padded_shape(cfg)
    vp = vox + torch.tensor([rx, ry, rz], dtype=torch.int32, device=dev)[None, :]
    sel = keep & torch.all((vp >= 0) & (vp < torch.tensor([Xp, Yp, Zp], dtype=torch.int32, device=dev)), dim=1)
    pflat = ((vp[:, 0] * Yp + vp[:, 1]) * Zp + vp[:, 2])[sel].long()
    lk = local[sel]
    vals = torch.stack([torch.ones_like(lk[:, 0]), lk[:, 0], lk[:, 1], lk[:, 2]]
                       + [lk[:, i] * lk[:, j] for i, j in PAIRS], dim=0)     # [10, n]
    sums = torch.zeros(10, Xp * Yp * Zp, dtype=dtype, device=dev)
    sums.index_add_(1, pflat, vals.to(dtype))
    return PointBins(hit=hit.view(X, Y, Z), min_height=mh.view(X, Y, Z), sums=sums.view(10, Xp, Yp, Zp))
