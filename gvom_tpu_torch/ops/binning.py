"""Point → voxel accumulation (the reference's endpoint binning
gvom.py:1084-1090, min height gvom.py:1301-1329, and the per-voxel raw stage
of the metrics pipeline gvom.py:1170-1299).

`bin_points` is the plain PyTorch twin of kernel K2 (ops/kernels.py,
csrc/binning.cu): endpoint hit counts and min sub-voxel z in the torus
layout, and the ten OWN-voxel raw moment sums on a grid padded by the eigen
support radius in the window layout. The reference expands each point into
neighbors without checking the point's own voxel bounds (gvom.py:1184-1202),
so points just outside the window feed border voxels: hence the padding. The
neighborhood box itself is ops/moments (kernels K3 and K5).

The slab form (`y_window=(ys0, Ys)`, counterpart of the JAX package's
fused_point_moments(y_window=) and binning.slab_point_moments) accumulates
only the torus rows [ys0, ys0+Ys): hit and min_height are [X, Ys, Z], and
the sums live in a scratch of Ys + 4·ry rows that keeps WINDOW coordinates
(`slab_rows`), so memory scales with the slab and the box stays a window
operation across the window seam.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import grid as gridops

__all__ = ["PAIRS", "PointBins", "prepare_points", "bin_points", "moment_pad", "padded_shape", "slab_rows",
           "scratch_pieces", "check_y_window", "is_slab", "sum_sq3"]

# second-moment pairs, in MOMENT_CHANNELS order (xx, xy, xz, yy, yz, zz)
PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def moment_pad(cfg: GvomConfig) -> Tuple[int, int, int]:
    return (cfg.xy_eigen_dist, cfg.xy_eigen_dist, cfg.z_eigen_dist)


def check_y_window(cfg: GvomConfig, y_window) -> Tuple[int, int]:
    """(ys0, Ys) of a slab of torus rows, (0, Y) for None."""
    if y_window is None:
        return 0, cfg.xy_size
    ys0, Ys = int(y_window[0]), int(y_window[1])
    if not (0 <= ys0 and 0 < Ys and ys0 + Ys <= cfg.xy_size):
        raise ValueError(f"y_window {y_window} is not a slab of the {cfg.xy_size} torus rows")
    return ys0, Ys


def is_slab(cfg: GvomConfig, y_window) -> bool:
    """Whether y_window is a proper slab. None and (0, Y) are the full grid:
    the one rule by which the plain versions, the wrappers and the kernels
    (which see only ys0 and Ys) choose the layout of the sums scratch."""
    return check_y_window(cfg, y_window) != (0, cfg.xy_size)


def padded_shape(cfg: GvomConfig, y_window=None) -> Tuple[int, int, int]:
    """Shape of the own-voxel sums scratch: the grid padded by the eigen
    radii, or for a slab (is_slab) the slab scratch of Ys + 4·ry rows."""
    xp, yp, zp = (s + 2 * p for s, p in zip(cfg.grid_shape, moment_pad(cfg)))
    if is_slab(cfg, y_window):
        yp = check_y_window(cfg, y_window)[1] + 4 * moment_pad(cfg)[1]
    return xp, yp, zp


def slab_rows(cfg: GvomConfig, origin: torch.Tensor, y_window):
    """Where a slab's window rows sit in the slab scratch: (w0, lenA, lenB) as
    tensors on origin's device. The slab's torus rows [ys0, ys0+Ys) are the
    window rows [w0, w0+Ys) mod Y. They are one run of window rows, or two
    when the window seam falls inside the slab: lenA rows before the seam and
    lenB after it. The scratch holds
        piece A: padded window rows [w0, w0+lenA+2ry) at scratch rows [0, lenA+2ry)
        piece B: padded window rows [0, lenB+2ry)     at scratch rows [lenA+2ry, Ys+4ry)
    so slab row j has its target at scratch row j + ry (j < lenA) or
    j + 3ry, and its ±ry sources beside it. A torus-indexed scratch would
    merge window row Y (pad) with window row 0 at the seam."""
    ys0, Ys = check_y_window(cfg, y_window)
    Y = cfg.xy_size
    w0 = torch.remainder(ys0 - origin[1], Y)
    len_a = torch.clamp(Y - w0, max=Ys)
    return w0, len_a, Ys - len_a


def scratch_pieces(cfg: GvomConfig, vox: torch.Tensor, keep: torch.Tensor, origin: torch.Tensor, y_window=None):
    """Where each point's own-voxel sums go: a list of (sel [N] bool, flat [N])
    pairs, the kept points that fall into one piece of the sums scratch and
    their flat index there. The padded window is one piece; a slab scratch
    (slab_rows) has two, and a point near both ends of the slab is in both."""
    dev = vox.device
    rx, ry, rz = moment_pad(cfg)
    Xp, Yp, Zp = padded_shape(cfg)
    Ysc = padded_shape(cfg, y_window)[1]
    vp = vox + torch.tensor([rx, ry, rz], dtype=torch.int32, device=dev)[None, :]
    inp = keep & torch.all((vp >= 0) & (vp < torch.tensor([Xp, Yp, Zp], dtype=torch.int32, device=dev)), dim=1)
    q1 = vp[:, 1]
    if not is_slab(cfg, y_window):
        rows = [(inp, q1)]
    else:
        w0, len_a, len_b = slab_rows(cfg, origin, y_window)
        rows = [(inp & (q1 >= w0) & (q1 < w0 + len_a + 2 * ry), q1 - w0),
                (inp & (len_b > 0) & (q1 < len_b + 2 * ry), len_a + 2 * ry + q1)]
    return [(sel, (vp[:, 0] * Ysc + row) * Zp + vp[:, 2]) for sel, row in rows]


class PointBins(NamedTuple):
    """One point set's bins. `sums` holds the own-voxel raw sums (n, S1,
    R2) in the padded window layout, or a slab's scratch. Its count n
    (channel 0) is defined everywhere; channels 1-9 are defined only where
    n > 0, a slab's two pieces each on its own: kernel K2 leaves them unset
    elsewhere, and every consumer (the epilogue, moments.box_aggregate_moments)
    reads them only there. The plain twin writes zeros there."""

    hit: torch.Tensor         # [X,Ys,Z] int32, torus layout
    min_height: torch.Tensor  # [X,Ys,Z] f32, torus layout (1.0 where no point)
    sums: torch.Tensor        # [10, X+2rx, Y+2ry | Ys+4ry, Z+2rz] f32 — own-voxel raw sums, padded window layout


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


def bin_points(cfg: GvomConfig, pn: torch.Tensor, keep: torch.Tensor, origin: torch.Tensor,
               y_window=None) -> PointBins:
    """Dense binning of a point set from its map-local voxel coordinates
    pn = points/res − origin [N,3] (grid.map_local): the plain twin of
    kernel K2. With y_window = (ys0, Ys) only the torus rows [ys0, ys0+Ys):
    hit and min_height [X, Ys, Z], the sums in the slab scratch (slab_rows)."""
    dev = pn.device
    X, Y, Z = cfg.grid_shape
    ys0, Ys = check_y_window(cfg, y_window)
    vox = torch.floor(pn).to(torch.int32)
    local = pn - vox.float()                           # sub-voxel coords in [0,1)

    # ---- endpoint hit counts + min height (in-bounds points; torus layout) ----
    size = gridops.size_vector(cfg, dev)
    vt = torch.remainder(vox + origin[None, :], size[None, :])
    row = vt[:, 1] - ys0
    inb = keep & gridops.in_bounds(cfg, vox) & (row >= 0) & (row < Ys)
    flat = ((vt[:, 0] * Ys + row) * Z + vt[:, 2])[inb].long()
    hit = torch.zeros(X * Ys * Z, dtype=torch.int32, device=dev)
    hit.index_put_((flat,), torch.ones_like(flat, dtype=torch.int32), accumulate=True)
    mh = torch.ones(X * Ys * Z, dtype=torch.float32, device=dev)
    mh.scatter_reduce_(0, flat, local[inb, 2], reduce="amin", include_self=True)

    # ---- own-voxel raw moments on the padded window grid ----
    Xp, Ysc, Zp = padded_shape(cfg, y_window)
    sums = torch.zeros(10, Xp * Ysc * Zp, dtype=torch.float32, device=dev)
    for sel, pflat in scratch_pieces(cfg, vox, keep, origin, y_window):
        lk = local[sel]
        vals = torch.stack([torch.ones_like(lk[:, 0]), lk[:, 0], lk[:, 1], lk[:, 2]]
                           + [lk[:, i] * lk[:, j] for i, j in PAIRS], dim=0)     # [10, n]
        sums.index_add_(1, pflat[sel].long(), vals)
    return PointBins(hit=hit.view(X, Ys, Z), min_height=mh.view(X, Ys, Z), sums=sums.view(10, Xp, Ysc, Zp))
