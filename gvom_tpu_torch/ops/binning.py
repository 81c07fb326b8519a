"""Point → voxel accumulation (the reference's endpoint binning
gvom.py:1084-1090, min height gvom.py:1301-1329, and the per-voxel raw stage
of the metrics pipeline gvom.py:1170-1299).

`bin_points` is the plain PyTorch twin of kernel K2 (ops/kernels.py,
csrc/binning.cu): endpoint hit counts and min sub-voxel z in the torus
layout, and the ten OWN-voxel raw moment sums on a grid padded by the eigen
support radius in the window layout. The reference expands each point into
neighbors without checking the point's own voxel bounds (gvom.py:1184-1202),
so points just outside the window feed border voxels: hence the padding. The
neighborhood box itself is ops/moments (kernel K3).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import grid as gridops

__all__ = ["PAIRS", "PointBins", "prepare_points", "bin_points", "moment_pad", "padded_shape", "sum_sq3"]

# second-moment pairs, in MOMENT_CHANNELS order (xx, xy, xz, yy, yz, zz)
PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def moment_pad(cfg: GvomConfig) -> Tuple[int, int, int]:
    return (cfg.xy_eigen_dist, cfg.xy_eigen_dist, cfg.z_eigen_dist)


def padded_shape(cfg: GvomConfig) -> Tuple[int, int, int]:
    return tuple(s + 2 * p for s, p in zip(cfg.grid_shape, moment_pad(cfg)))


class PointBins(NamedTuple):
    hit: torch.Tensor         # [X,Y,Z] int32, torus layout
    min_height: torch.Tensor  # [X,Y,Z] f32, torus layout (1.0 where no point)
    sums: torch.Tensor        # [10, X+2rx, Y+2ry, Z+2rz] f32 — own-voxel raw sums, padded window layout


def sum_sq3(v: torch.Tensor) -> torch.Tensor:
    """v0² + v1² + v2² per row, rounded as the reference's compiled
    jnp.sum(v*v, axis=1): two fused multiply-adds onto v0²."""
    return gridops.fma32(v[:, 2], v[:, 2], gridops.fma32(v[:, 1], v[:, 1], v[:, 0] * v[:, 0]))


def prepare_points(
    cfg: GvomConfig,
    points: torch.Tensor,
    valid: torch.Tensor,
    ego_position: torch.Tensor,
    transform: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Transform (gvom.py:1038-1056) + min-distance filter (gvom.py:1064-1068).

    The distance filter uses the post-transform world-frame norm — the
    reference quirk — unless cfg.ego_relative_min_distance."""
    p = points.float()
    if transform is not None:
        t = transform.float()
        p = p @ t[:3, :3].T + t[:3, 3]
    if cfg.ego_relative_min_distance:
        d2 = sum_sq3(p - ego_position.float())
    else:
        d2 = sum_sq3(p)
    md = torch.tensor(cfg.min_distance, dtype=torch.float32)
    keep = valid & (d2 >= float(md * md))
    return p, keep


def bin_points(cfg: GvomConfig, pn: torch.Tensor, keep: torch.Tensor, origin: torch.Tensor) -> PointBins:
    """Dense binning of one scan from its map-local voxel coordinates
    pn = points/res − origin [N,3] (grid.map_local): the plain twin of
    kernel K2."""
    dev = pn.device
    X, Y, Z = cfg.grid_shape
    vox = torch.floor(pn).to(torch.int32)
    local = pn - vox.float()                           # sub-voxel coords in [0,1)

    # ---- endpoint hit counts + min height (in-bounds points; torus layout) ----
    size = gridops.size_vector(cfg, dev)
    inb = keep & gridops.in_bounds(cfg, vox)
    vt = torch.remainder(vox + origin[None, :], size[None, :])[inb].long()
    flat = (vt[:, 0] * Y + vt[:, 1]) * Z + vt[:, 2]
    hit = torch.zeros(X * Y * Z, dtype=torch.int32, device=dev)
    hit.index_put_((flat,), torch.ones_like(flat, dtype=torch.int32), accumulate=True)
    mh = torch.ones(X * Y * Z, dtype=torch.float32, device=dev)
    mh.scatter_reduce_(0, flat, local[inb, 2], reduce="amin", include_self=True)

    # ---- own-voxel raw moments on the padded window grid ----
    pad = torch.tensor(moment_pad(cfg), dtype=torch.int32, device=dev)
    Xp, Yp, Zp = padded_shape(cfg)
    vp = vox + pad[None, :]
    inp = keep & torch.all((vp >= 0) & (vp < torch.tensor([Xp, Yp, Zp], dtype=torch.int32, device=dev)), dim=1)
    vpk = vp[inp].long()
    pflat = (vpk[:, 0] * Yp + vpk[:, 1]) * Zp + vpk[:, 2]
    lk = local[inp]
    vals = torch.stack([torch.ones_like(lk[:, 0]), lk[:, 0], lk[:, 1], lk[:, 2]]
                       + [lk[:, i] * lk[:, j] for i, j in PAIRS], dim=0)     # [10, n]
    sums = torch.zeros(10, Xp * Yp * Zp, dtype=torch.float32, device=dev)
    sums.index_add_(1, pflat, vals)
    return PointBins(hit=hit.view(X, Y, Z), min_height=mh.view(X, Y, Z), sums=sums.view(10, Xp, Yp, Zp))
