"""The benchmark's frozen copy of the port's plain PyTorch version of this stage, which the
benchmark's comparison holds the port against; it imports nothing of the port.

Moment algebra: raw voxel-local sums and the neighborhood box aggregation
(the reference's neighborhood expansion K8-K11, gvom.py:1170-1299).

State is raw sums in the target voxel's local frame — n, S1 = Σ(p − v),
R2 = Σ(p − v)(p − v)ᵀ — so every merge is a plain masked add and re-origining
needs no mean adjustment. The ±eigen_dist neighborhood is a box filter whose
terms are translated into the target's frame (the parallel-axis update
`translate_raw`). `moments_epilogue_plain` is the box, the crop, the move to
the torus layout and, optionally, the occupancy mask; `point_moments` is the
binning then that epilogue.
"""

from __future__ import annotations

import torch

from benchmark.reference import binning
from benchmark.reference import grid as gridops
from benchmark.reference.binning import moment_pad
from benchmark.reference.config import GvomConfig

__all__ = ["translate_raw", "box_aggregate_moments", "moments_epilogue_plain", "point_moments"]

# per axis: (diagonal s2 index, [(cross s2 index, S1 component)]), s2 order (xx,xy,xz,yy,yz,zz)
_AX_TERMS = {
    0: (0, ((1, 1), (2, 2))),  # xx; xy += t·S1_y, xz += t·S1_z
    1: (3, ((1, 0), (4, 2))),  # yy; xy += t·S1_x, yz += t·S1_z
    2: (5, ((2, 0), (4, 1))),  # zz; xz += t·S1_x, yz += t·S1_y
}


def translate_raw(n, s1, s2, axis: int, t: float):
    """Re-express raw local sums after shifting the frame by −t along `axis`
    (coordinates become x + t·e_axis): S1' = S1 + n·t·e, R2' picks up the
    parallel-axis cross terms."""
    diag, cross = _AX_TERMS[axis]
    s2_c = [s2[i] for i in range(6)]
    s2_c[diag] = s2_c[diag] + (2.0 * t) * s1[axis] + (t * t) * n
    for pidx, comp in cross:
        s2_c[pidx] = s2_c[pidx] + t * s1[comp]
    s1_c = [s1[i] for i in range(3)]
    s1_c[axis] = s1_c[axis] + t * n
    return torch.stack(s1_c, dim=0), torch.stack(s2_c, dim=0)


def _shifted(arr: torch.Tensor, off: int, axis: int) -> torch.Tensor:
    """out[i] = arr[i + off] along `axis` (static off), zero-filled."""
    if off == 0:
        return arr
    out = torch.zeros_like(arr)
    n = arr.shape[axis]
    if off > 0:
        out.narrow(axis, 0, n - off).copy_(arr.narrow(axis, off, n - off))
    else:
        out.narrow(axis, -off, n + off).copy_(arr.narrow(axis, 0, n + off))
    return out


def box_aggregate_moments(cfg: GvomConfig, sums: torch.Tensor) -> torch.Tensor:
    """Aggregate padded own-voxel raw sums [10, Xp, Yp, Zp] over the
    ±xy_eigen_dist/±z_eigen_dist box (gvom.py:1188-1202): target u receives
    source v = u + off translated into u's frame. Crops the padding; returns
    [10, X, Y, Z] in the window layout. Channels 1-9 are read only where
    n > 0."""
    sums = torch.where(sums[:1] > 0, sums, torch.zeros((), dtype=sums.dtype, device=sums.device))
    n, s1, s2 = sums[0], sums[1:4], sums[4:10]
    radii = moment_pad(cfg)
    for ax, r in enumerate(radii):
        if r == 0:
            continue
        acc_n, acc_s1, acc_s2 = n, s1, s2
        for off in range(-r, r + 1):
            if off == 0:
                continue
            sn = _shifted(n, off, ax)
            ts1, ts2 = translate_raw(sn, _shifted(s1, off, ax + 1), _shifted(s2, off, ax + 1), ax, float(off))
            acc_n = acc_n + sn
            acc_s1 = acc_s1 + ts1
            acc_s2 = acc_s2 + ts2
        n, s1, s2 = acc_n, acc_s1, acc_s2
    rx, ry, rz = radii
    X, Y, Z = cfg.grid_shape
    mom = torch.cat([n[None], s1, s2], dim=0)
    return mom[:, rx:rx + X, ry:ry + Y, rz:rz + Z]


def moments_epilogue_plain(cfg: GvomConfig, sums: torch.Tensor, hit: torch.Tensor, origin: torch.Tensor,
                           occupancy_mask: bool = True) -> torch.Tensor:
    """Box-aggregate the padded sums, crop, move them into the torus layout
    and, with occupancy_mask, zero them where `hit` is 0. Returns a fresh
    [10, X, Y, Z] tensor."""
    mom = gridops.window_to_torus(box_aggregate_moments(cfg, sums), origin)
    if occupancy_mask:
        mom = torch.where(hit[None] > 0, mom, torch.zeros((), dtype=mom.dtype, device=mom.device))
    return mom


def point_moments(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, origin: torch.Tensor,
                  occupancy_mask: bool = True, dtype=torch.float32):
    """Endpoint metrics of a flat point set [N,3] (world frame): (hit [X,Y,Z]
    int32, min_height [X,Y,Z] f32, mom [10,X,Y,Z] f32), torus layout; the
    moments computed in `dtype`."""
    bins = binning.bin_points(cfg, points, keep, origin, dtype)
    mom = moments_epilogue_plain(cfg, bins.sums, bins.hit, origin, occupancy_mask)
    return bins.hit, bins.min_height, mom.float()
