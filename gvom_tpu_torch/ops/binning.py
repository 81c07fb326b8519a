"""Point → voxel accumulation (the reference's endpoint binning
gvom.py:1084-1090, min height gvom.py:1301-1329, and the per-voxel raw stage
of the metrics pipeline gvom.py:1170-1299).

`prepare_plain` is the plain PyTorch twin of the point-preparation kernel
(ops/kernels.py, csrc/prepare.cu): the transform and min-distance filter of
`prepare_points`, the grid origin, and each scan's scan_ok. `bin_points` is
the plain twin of kernel K2 (csrc/binning.cu): endpoint hit counts and min
sub-voxel z in the torus layout, and the ten OWN-voxel raw moment sums on a
grid padded by the eigen support radius in the window layout. The reference
expands each point into neighbors without checking the point's own voxel
bounds (gvom.py:1184-1202), so points just outside the window feed border
voxels: hence the padding. The neighborhood box itself is ops/moments
(kernels K3 and K5).

The slab form (`y_window=(ys0, Ys)`, counterpart of the JAX package's
fused_point_moments(y_window=) and binning.slab_point_moments) accumulates
only the torus rows [ys0, ys0+Ys): hit and min_height are [X, Ys, Z], and
the sums live in a scratch of Ys + 4·ry rows that keeps WINDOW coordinates
(`slab_rows`), so memory scales with the slab and the box stays a window
operation across the window seam.

Channels 1-9 of the sums live in a `MomentScratch` that the caller keeps
across calls (the batched step, the facade's ring buffer), as K2 keeps them
(csrc/binning.cu): channels 1-8 voxel-major, 32 bytes a voxel, and channel 9
as a plane beside them (`rest_parts`); `rest_channels` gives their logical
[9, ...] view. `bin_stats_plain` counts what K2's blocks do on a point set
(empty blocks, table flushes, global reductions by width, the sectors the
next call's fill clears).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import grid as gridops

__all__ = ["PAIRS", "PointBins", "MomentScratch", "moment_scratch", "rest_parts", "rest_channels", "rest_layout",
           "transform_points",
           "prepare_points", "prepare_plain", "bin_points", "bin_stats_plain", "moment_pad", "padded_shape",
           "slab_rows", "scratch_pieces", "check_y_window", "is_slab", "sum_sq3"]

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
    """One point set's bins. The own-voxel raw sums (n, S1, R2) are in the
    padded window layout, or a slab's scratch: the count `n`, the call's own,
    and channels 1-9 in `rest`, the caller's MomentScratch, which holds them
    where n > 0 and zero elsewhere. Every consumer (the epilogue,
    moments.box_aggregate_moments) reads them only where n > 0."""

    hit: torch.Tensor         # [X,Ys,Z] int32, torus layout
    min_height: torch.Tensor  # [X,Ys,Z] f32, torus layout (1.0 where no point)
    n: torch.Tensor           # [1, X+2rx, Y+2ry | Ys+4ry, Z+2rz] f32 — own-voxel point counts, padded window layout
    rest: torch.Tensor        # [9·P] f32 — channels 1-9 (S1, R2), the scratch's (rest_parts)

    @property
    def sums(self) -> torch.Tensor:
        """The ten channels as one [10, ...] tensor (a copy)."""
        return torch.cat([self.n, rest_channels(self.rest, self.n.shape[1:])])


class MomentScratch(NamedTuple):
    """Channels 1-9 of a caller's own-voxel sums, kept across its calls of
    K2 (made once by moment_scratch): `rest`, 9·P f32 for the P voxels of
    the sums scratch [Xp, Yp | Ys+4ry, Zp], channels 1-8 voxel-major and
    then channel 9 (rest_parts), and `touched` [Xp, Yp | Ys+4ry, Zp] uint8,
    a byte a voxel. Between calls rest is zero wherever touched is 0. A
    call puts rest back to zero where the last call set touched, adds its
    sums where its n > 0 and sets touched to 1 there. Its calls run one
    after another, on one stream."""

    rest: torch.Tensor
    touched: torch.Tensor


def moment_scratch(cfg: GvomConfig, device, y_window=None) -> MomentScratch:
    """A zeroed MomentScratch for the sums scratch of this shape (padded_shape)."""
    shape = padded_shape(cfg, y_window)
    return MomentScratch(rest=torch.zeros(9 * math.prod(shape), dtype=torch.float32, device=device),
                         touched=torch.zeros(shape, dtype=torch.uint8, device=device))


def rest_parts(rest: torch.Tensor, shape) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two parts of a scratch's rest for the sums scratch `shape`, as
    views: channels 1-8 voxel-major [*shape, 8] (a voxel's eight are one
    32-byte sector, which K2 adds as two 16-byte vectors), then channel 9
    [*shape]."""
    P = math.prod(shape)
    return rest[:8 * P].view(*shape, 8), rest[8 * P:].view(*shape)


def rest_channels(rest: torch.Tensor, shape) -> torch.Tensor:
    """The logical view of a scratch's rest: channels 1-9 as [9, *shape]
    (a copy), the order of moments' channels 1-9."""
    first, ninth = rest_parts(rest, shape)
    return torch.cat([first.movedim(-1, 0), ninth[None]])


def rest_layout(channels: torch.Tensor) -> torch.Tensor:
    """Channels 1-9 [9, *shape] in a scratch's rest layout (a fresh tensor):
    the inverse of rest_channels."""
    return torch.cat([channels[:8].movedim(0, -1).reshape(-1), channels[8].reshape(-1)])


def sum_sq3(v: torch.Tensor) -> torch.Tensor:
    """v0² + v1² + v2² per row, rounded as the reference's compiled
    jnp.sum(v*v, axis=1): two fused multiply-adds onto v0²."""
    return gridops.fma32(v[:, 2], v[:, 2], gridops.fma32(v[:, 1], v[:, 1], v[:, 0] * v[:, 0]))


def transform_points(points: torch.Tensor, transform: torch.Tensor) -> torch.Tensor:
    """points [N,3] @ R.T + t of a [4,4] transform, rounded as the JAX
    package's compiled `p @ t[:3, :3].T + t[:3, 3]`: each output coordinate
    is the chain fma(p2, r2, fma(p1, r1, p0·r0)) over its row r of R, then
    + t. Written out, so that it rounds so on every device (a matmul's
    order and fusing are the library's)."""
    t = transform.float()
    p = points.float()
    rows = [gridops.fma32(p[:, 2], t[r, 2], gridops.fma32(p[:, 1], t[r, 1], p[:, 0] * t[r, 0])) + t[r, 3]
            for r in range(3)]
    return torch.stack(rows, dim=1)


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
        p = transform_points(p, transform)
    if cfg.ego_relative_min_distance:
        d2 = sum_sq3(p - ego_position.float())
    else:
        d2 = sum_sq3(p)
    md = torch.tensor(cfg.min_distance, dtype=torch.float32)
    keep = valid & (d2 >= float(md * md))
    return p, keep


def prepare_plain(
    cfg: GvomConfig,
    points: torch.Tensor,
    valid: torch.Tensor,
    egos: torch.Tensor,
    frame_ego: Optional[torch.Tensor] = None,
    origin: Optional[torch.Tensor] = None,
    transform: Optional[torch.Tensor] = None,
    drop_dead: bool = False,
):
    """The plain twin of the point-preparation kernel: S scans (points
    [S,N,3], valid [S,N], each scan's ego [S,3]) → (p [S,N,3] world frame,
    keep [S,N], origin [3] int32, scan_ok [S]).

    prepare_points on every scan (egos serve ego_relative_min_distance);
    the origin is `origin`, or compute_origin(frame_ego); scan_ok[s] is
    whether scan s keeps an endpoint inside that window, floor(p/res −
    origin) in bounds (gvom_tpu/models/pipeline.py:209-213, the dead-scan
    test of gvom_tpu/parallel/sharding.py:193-202). drop_dead also takes a
    dead scan's points out of keep (sharding.py:202)."""
    if (frame_ego is None) == (origin is None):
        raise ValueError("prepare: give the frame's ego or a pinned origin, one of the two")
    S, N = valid.shape
    if origin is None:
        origin = gridops.compute_origin(cfg, frame_ego)
    egos_pt = egos.float()[:, None, :].expand(S, N, 3).reshape(-1, 3)
    p, keep = prepare_points(cfg, points.reshape(-1, 3), valid.reshape(-1), egos_pt, transform)
    vox = gridops.floor_i32(gridops.map_local(cfg, p, origin))
    scan_ok = (keep & gridops.in_bounds(cfg, vox)).view(S, N).any(dim=1)
    keep = keep.view(S, N)
    if drop_dead:
        keep = keep & scan_ok[:, None]
    return p.view(S, N, 3), keep, origin, scan_ok


def bin_points(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, origin: torch.Tensor,
               y_window=None, scratch: Optional[MomentScratch] = None) -> PointBins:
    """Dense binning of a point set [N,3] in the world frame: the plain twin
    of kernel K2. The map-local voxel coordinates pn = points/res − origin
    are grid.map_local's. With y_window = (ys0, Ys) only the torus rows
    [ys0, ys0+Ys): hit and min_height [X, Ys, Z], the sums in the slab
    scratch (slab_rows). Channels 1-9 go into `scratch` (MomentScratch), a
    fresh one where the caller keeps none."""
    pn = gridops.map_local(cfg, points, origin)
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
    if scratch is None:
        scratch = moment_scratch(cfg, dev, y_window)
    first, ninth = rest_parts(scratch.rest, (Xp * Ysc * Zp,))
    was = scratch.touched.view(-1) != 0
    first[was] = 0.0
    ninth[was] = 0.0
    live = sums[0] > 0
    first[live] += sums[1:9, live].T
    ninth[live] += sums[9, live]
    scratch.touched.view(-1).copy_(live)
    return PointBins(hit=hit.view(X, Ys, Z), min_height=mh.view(X, Ys, Z), n=sums[:1].view(1, Xp, Ysc, Zp),
                     rest=scratch.rest)


def bin_stats_plain(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, origin: torch.Tensor,
                    block: int = 256, scans: int = 1, n_scans: int = 1, y_window=None) -> dict:
    """What K2's blocks do on a point set [S·N, 3] of n_scans scans of N
    slots each (the batched step's, in scan order), when a block takes
    `block` consecutive slots of `scans` consecutive scans (block 256,
    scans 1: the kernel's): the slots and kept points; the blocks and the
    empty ones (no point inside the padded window: they leave first); the
    flushes (one a distinct voxel a block: torus voxels for hit and
    min_height, window voxels for n and the nine sums); the global
    reductions by width (a window flush: n and channel 9 scalar, channels
    1-8 two 16-byte vectors; 2 scalar more where its voxel is in the grid)
    and their sum, `atomics` (each window flush also stores a byte of
    touched); and the 32-byte sectors that the next call's fill clears
    (`fill_sectors`: each touched voxel's row of channels 1-8, and channel
    9's sector of each group of eight voxels that holds one)."""
    dev = points.device
    total = points.shape[0]
    if total % n_scans:
        raise ValueError(f"{total} slots are not {n_scans} scans of equal length")
    N = total // n_scans
    X, Y, Z = cfg.grid_shape
    ys0, Ys = check_y_window(cfg, y_window)
    pn = gridops.map_local(cfg, points, origin)
    vox = torch.floor(pn).to(torch.int32)
    size = gridops.size_vector(cfg, dev)
    vt = torch.remainder(vox + origin[None, :], size[None, :])
    row = vt[:, 1] - ys0
    tor = keep & gridops.in_bounds(cfg, vox) & (row >= 0) & (row < Ys)
    tflat = (vt[:, 0].long() * Ys + row) * Z + vt[:, 2]
    slot = torch.arange(total, device=dev)
    per_scan = -(-N // block)
    blk = (slot // N // scans) * per_scan + (slot % N) // block
    n_blocks = -(-n_scans // scans) * per_scan

    def flushes(sel, flat):
        pairs = torch.unique(blk[sel] * (int(flat.max()) + 1 if sel.any() else 1) + flat[sel])
        return int(pairs.numel())

    tfl = flushes(tor, tflat)
    wfl, inside, touched = 0, tor.clone(), []
    for sel, pflat in scratch_pieces(cfg, vox, keep, origin, y_window):   # the pieces are apart in the scratch
        wfl += flushes(sel, pflat.long())
        touched.append(pflat[sel].long())
        inside |= sel
    touched = torch.unique(torch.cat(touched))
    voxels = int(touched.numel())
    empty = n_blocks - int(torch.unique(blk[inside]).numel())
    scalar, vector16 = 2 * tfl + 2 * wfl, 2 * wfl
    return dict(slots=total, kept=int(keep.sum()), blocks=n_blocks, empty_blocks=empty,
                flushes=dict(torus=tfl, window=wfl), window_voxels=voxels,
                reductions=dict(scalar=scalar, vector16=vector16), atomics=scalar + vector16,
                fill_sectors=voxels + int(torch.unique(touched // 8).numel()))
