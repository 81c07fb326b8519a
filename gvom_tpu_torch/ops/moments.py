"""Moment algebra: raw voxel-local sums and the neighborhood box aggregation
(the reference's neighborhood expansion K8-K11, gvom.py:1170-1299).

State is raw sums in the target voxel's local frame — n, S1 = Σ(p − v),
R2 = Σ(p − v)(p − v)ᵀ — so every merge is a plain masked add and re-origining
needs no mean adjustment. The ±eigen_dist neighborhood is a box filter whose
terms are translated into the target's frame (the parallel-axis update
`translate_raw`).

`box_aggregate_moments` + `ingest_epilogue_plain` are the plain twin of
kernel K3 (ops/kernels.py, csrc/epilogue.cu): box, crop, occupancy pre-mask
and the write into the ring-buffer slot. `moments_epilogue_plain` is the plain
twin of kernel K5 (the same source): the box into a fresh tensor, the mask
optional, the full grid or a y-slab. `point_moments` is K2 then K5.

`mean_local`, `covariance` and `eigenvalues` read the stored moments back
as the voxel's normalized mean, covariance and its sorted eigenvalues (the
debug voxel exporter's eigen features).
"""

from __future__ import annotations

import math

import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import grid as gridops
from gvom_tpu_torch.ops import binning
from gvom_tpu_torch.ops.binning import moment_pad

__all__ = ["raw_merge", "translate_raw", "box_aggregate_moments", "ingest_epilogue_plain", "moments_epilogue_plain",
           "point_moments", "slab_point_moments", "mean_local", "covariance", "eigenvalues"]

# per axis: (diagonal s2 index, [(cross s2 index, S1 component)]), s2 order (xx,xy,xz,yy,yz,zz)
_AX_TERMS = {
    0: (0, ((1, 1), (2, 2))),  # xx; xy += t·S1_y, xz += t·S1_z
    1: (3, ((1, 0), (4, 2))),  # yy; xy += t·S1_x, yz += t·S1_z
    2: (5, ((2, 0), (4, 1))),  # zz; xz += t·S1_x, yz += t·S1_y
}


def raw_merge(a, b):
    """Merge two same-frame raw-moment sets (n, s1, s2): a plain add."""
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


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


def box_aggregate_moments(cfg: GvomConfig, sums: torch.Tensor, y_rows=None) -> torch.Tensor:
    """Aggregate padded own-voxel raw sums [10, Xp, Yp, Zp] over the
    ±xy_eigen_dist/±z_eigen_dist box (gvom.py:1188-1202): target u receives
    source v = u + off translated into u's frame. Crops the padding; returns
    [10, X, Y, Z] in the window layout. With y_rows (an index tensor) the
    sums are a slab scratch (binning.slab_rows) and the y crop takes those
    scratch rows instead: [10, X, len(y_rows), Z]. Channels 1-9 of the sums
    are read only where n > 0 (binning.PointBins): they are taken as zero
    elsewhere, whatever they hold."""
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
    if y_rows is not None:
        return mom[:, rx:rx + X, :, rz:rz + Z].index_select(2, y_rows)
    return mom[:, rx:rx + X, ry:ry + Y, rz:rz + Z]


def moments_epilogue_plain(cfg: GvomConfig, n: torch.Tensor, rest: torch.Tensor, hit: torch.Tensor,
                           origin: torch.Tensor, y_window=None, occupancy_mask: bool = True) -> torch.Tensor:
    """Plain twin of K5: box-aggregate the padded sums (n [1, ...] and
    channels 1-9 [9, ...], binning.PointBins), crop, move them into the
    torus layout and, with occupancy_mask, zero them where `hit` is 0.
    Returns a fresh [10, X, Ys, Z] tensor. With y_window the sums are the
    slab scratch and the result holds the torus rows [ys0, ys0+Ys)."""
    sums = torch.cat([n, rest])
    if not binning.is_slab(cfg, y_window):
        mom = gridops.window_to_torus(box_aggregate_moments(cfg, sums), origin)
    else:
        ry = moment_pad(cfg)[1]
        _, len_a, _ = binning.slab_rows(cfg, origin, y_window)
        j = torch.arange(y_window[1], device=sums.device)
        mom = box_aggregate_moments(cfg, sums, y_rows=j + ry + torch.where(j >= len_a, 2 * ry, 0))
        # x and z from window to torus; the y rows are torus rows already
        for ax, k in ((1, 0), (3, 2)):
            mom = mom.index_select(ax, gridops._roll_index(mom.shape[ax], origin[k], mom.device))
    if occupancy_mask:
        mom = torch.where(hit[None] > 0, mom, torch.zeros((), dtype=mom.dtype, device=mom.device))
    return mom


def ingest_epilogue_plain(cfg: GvomConfig, n: torch.Tensor, rest: torch.Tensor, hit: torch.Tensor,
                          origin: torch.Tensor, out: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Plain twin of K3: box-aggregate the padded sums, move them into the
    torus layout, zero them where the scan has no hit (the occupancy
    pre-mask: consumers read moments only under hit > 0), and write the
    result into out[slot] ([S, 10, X, Y, Z]; slot is a device int tensor).
    Returns out."""
    out.index_copy_(0, slot.reshape(1).long(), moments_epilogue_plain(cfg, n, rest, hit, origin)[None])
    return out


def point_moments(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, origin: torch.Tensor,
                  y_window=None, occupancy_mask: bool = True):
    """Endpoint metrics of a flat point set [N,3] (world frame): (hit [X,Ys,Z]
    int32, min_height [X,Ys,Z] f32, mom [10,X,Ys,Z] f32), torus layout: the
    plain twin of K2 then K5, and the counterpart of the JAX package's
    fused_point_moments. occupancy_mask=False returns the moments raw (the
    batched step masks by the whole batch's occupancy later)."""
    bins = binning.bin_points(cfg, points, keep, origin, y_window)
    mom = moments_epilogue_plain(cfg, bins.n, bins.rest, bins.hit, origin, y_window, occupancy_mask)
    return bins.hit, bins.min_height, mom


def slab_point_moments(cfg: GvomConfig, points, keep, origin, ys0: int, Ys: int, occupancy_mask: bool = True):
    """point_moments for the torus y-slab [ys0, ys0+Ys) only: no array of
    the full y width is made, so memory scales with the slab. Computes what
    the JAX package's binning.slab_point_moments computes. That one expands
    ±ry at scatter time into target rows; this one drops the points whose
    ±ry neighbourhood misses the slab and keeps window coordinates in a
    scratch of Ys + 4·ry rows (binning.slab_rows), as kernel K2 does."""
    return point_moments(cfg, points, keep, origin, (ys0, Ys), occupancy_mask)


def _safe_count(n: torch.Tensor) -> torch.Tensor:
    return torch.where(n > 0, n, torch.ones((), dtype=n.dtype, device=n.device))


def mean_local(n: torch.Tensor, s1: torch.Tensor) -> torch.Tensor:
    """Voxel-local normalized mean S1/n (reference metrics[0:3],
    gvom.py:1222-1230), zeros where empty. n [...], s1 [3, ...]."""
    return torch.where(n[None] > 0, s1 / _safe_count(n)[None], 0.0)


def covariance(n: torch.Tensor, s1: torch.Tensor, s2: torch.Tensor) -> torch.Tensor:
    """Normalized covariance C = R2/n − μμᵀ with μ = S1/n, zeros where empty
    (gvom.py:1287-1299). Returns [6, ...] in (xx,xy,xz,yy,yz,zz) order."""
    safe = _safe_count(n)[None]
    mu = s1 / safe
    cov = s2 / safe - torch.stack([mu[i] * mu[j] for i, j in binning.PAIRS], dim=0)
    return torch.where(n[None] > 0, cov, 0.0)


def eigenvalues(cov: torch.Tensor) -> torch.Tensor:
    """Sorted (λ0 ≥ λ1 ≥ λ2) eigenvalues of the symmetric 3×3 covariance of
    each voxel, closed-form trigonometric method (gvom.py:1345-1378), with
    the diagonal branch (p1 == 0) and the clamps of acos's argument as the
    JAX package writes them. cov [6, ...]; returns [3, ...]."""
    xx, xy, xz, yy, yz, zz = cov.unbind(0)
    p1 = xy * xy + xz * xz + yz * yz
    q = (xx + yy + zz) / 3.0
    e0d = torch.maximum(xx, torch.maximum(yy, zz))
    e2d = torch.minimum(xx, torch.minimum(yy, zz))
    p2 = (xx - q) ** 2 + (yy - q) ** 2 + (zz - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    ps = torch.where(p > 0, p, torch.ones((), dtype=p.dtype, device=p.device))
    b0, b1, b2 = (xx - q) / ps, xy / ps, xz / ps
    b3, b4, b5 = (yy - q) / ps, yz / ps, (zz - q) / ps
    r = (b0 * (b3 * b5 - b4 * b4) - b1 * (b1 * b5 - b4 * b2) + b2 * (b1 * b4 - b3 * b2)) / 2.0
    phi = torch.where(r <= -1.0, math.pi / 3.0,
                      torch.where(r >= 1.0, 0.0, torch.acos(torch.clamp(r, -1.0, 1.0)) / 3.0))
    e0 = q + 2.0 * p * torch.cos(phi)
    e2 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    diag = p1 == 0
    l0 = torch.where(diag, e0d, e0)
    l2 = torch.where(diag, e2d, e2)
    l1 = 3.0 * q - l0 - l2
    return torch.stack([l0, l1, l2], dim=0)
