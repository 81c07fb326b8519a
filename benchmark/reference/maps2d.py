"""The benchmark's frozen copy of the port's plain PyTorch version of this stage, which the
benchmark's comparison holds the port against; it imports nothing of the port.

2D map derivation (the reference's K17-K23, gvom.py:412-734).

3D inputs are torus-layout [X, Y, Z] grids; per-column products come out
torus-layout [X, Y] and are moved to the window layout (torus_to_window) for
the stencils and the user-facing maps, as in gvom_tpu/ops/maps2d.py.

  * height / inferred height: the first occupied (observed-empty) voxel per
    column, bottom-up in window-relative z (gvom.py:536-554). These are the
    plain twins of kernel K4's column products.
  * slope + roughness: the 3×3 least-squares plane fit from 9 shifted adds,
    with coordinates relative to the center cell (gvom.py:663-734); on the
    card the whole fit is the port's plane-fit kernel (csrc/planefit.cu),
    which also moves the height maps to the window layout
    (plane_fit_window_plain is its twin).
  * guess height: the reference's outward search (gvom.py:556-661) as
    nearest-known-index scans (a flip and a cummin) plus
    `guess_search_radius` constant-time steps, with the reference's quirks:
    x_p_done is never tested in the loop condition (G:581) and y_n merges
    under the x_n guard (G:655); on the card the guess-height kernel
    (csrc/guess.cu) runs the reference's per-cell search, and the maps
    after it as its epilogue (guess_products_plain is its twin).
  * positive obstacle: the masked per-column band reduction (gvom.py:487-521,
    including the +1 band-start offset).
"""

from __future__ import annotations

from typing import Tuple

import torch

from benchmark.reference.config import GvomConfig
from benchmark.reference.grid import atan2_32, fma32, log32, sqrt32, torus_to_window, window_to_torus
from benchmark.reference.config import UNKNOWN_HEIGHT

__all__ = [
    "height_map",
    "inferred_height_map",
    "plane_fit_inputs",
    "plane_fit_plain",
    "plane_fit_tail_plain",
    "plane_fit_window_plain",
    "guess_height_plain",
    "guess_products_plain",
    "positive_obstacle_from_band",
    "positive_band_sums",
    "negative_obstacle_map",
    "visibility_map",
    "maps_to_window_plain",
    "map_products_plain",
    "f32_value",
    "f32_square",
]

_BIG = 1 << 20


def f32_value(v: float) -> float:
    """f32(v) as a Python float (exactly), the constant XLA computes with."""
    return float(torch.tensor(v, dtype=torch.float32))


def f32_square(v: float) -> float:
    """f32(v)·f32(v) rounded to f32, as the reference's jnp.float32(v) ** 2."""
    t = torch.tensor(v, dtype=torch.float32)
    return float(t * t)


def _z_priority(cfg: GvomConfig, origin: torch.Tensor) -> torch.Tensor:
    """[Z] window-relative z of each torus z index (bottom of window = 0)."""
    Z = cfg.z_size
    return torch.remainder(torch.arange(Z, dtype=torch.int32, device=origin.device) - origin[2], Z)


def _first_in_column(cfg: GvomConfig, mask: torch.Tensor, origin: torch.Tensor):
    """(any [X,Y], rel_z of first [X,Y], one-hot of first [X,Y,Z]) of a
    bottom-up column scan over a torus-layout [X,Y,Z] mask."""
    Z = cfg.z_size
    pz = _z_priority(cfg, origin)
    score = torch.where(mask, pz, Z)
    zrel = score.amin(dim=-1)
    return zrel < Z, zrel, mask & (score == zrel[..., None])


def _rel_cols(cfg: GvomConfig, origin: torch.Tensor, ax: int) -> torch.Tensor:
    X = cfg.xy_size
    i = torch.arange(X, dtype=torch.int32, device=origin.device)
    return torch.remainder(i - origin[ax], X).float()


def height_map(cfg: GvomConfig, occ, min_height, origin, ego_position) -> torch.Tensor:
    """First-occupied-voxel height per column with the ego-disk pre-seed
    (gvom.py:523-540); torus in, torus out."""
    any_occ, zrel, sel = _first_in_column(cfg, occ, origin)
    mh = torch.where(sel, min_height, torch.zeros((), device=occ.device)).sum(dim=-1)
    col_h = (mh + zrel.float() + origin[2].float()) * cfg.z_resolution
    ego = ego_position.float()
    rel_y = _rel_cols(cfg, origin, 1)
    res = f32_value(cfg.xy_resolution)     # XLA's constant is f32(res), not the decimal
    gx = fma32(origin[0].float() + _rel_cols(cfg, origin, 0), res, -ego[0].expand(cfg.xy_size))
    gy = fma32(origin[1].float() + rel_y, res, -ego[1].expand(rel_y.shape[0]))
    gx2, gy2 = torch.broadcast_tensors(gx[:, None], gy[None, :])
    disk = fma32(gx2, gx2, gy2 * gy2) <= f32_square(cfg.robot_radius)
    seed = torch.where(disk, ego[2] - torch.tensor(cfg.ground_to_lidar_height, dtype=torch.float32),
                       torch.tensor(UNKNOWN_HEIGHT, dtype=torch.float32, device=occ.device))
    return torch.where(any_occ, col_h, seed)


def inferred_height_map(cfg: GvomConfig, occ, evidence, origin) -> torch.Tensor:
    """First observed-empty voxel per column (gvom.py:542-554); torus in/out."""
    any_miss, zrel, _ = _first_in_column(cfg, (~occ) & (evidence > 0), origin)
    ih = (zrel.float() + origin[2].float()) * cfg.z_resolution
    return torch.where(any_miss, ih, torch.tensor(UNKNOWN_HEIGHT, device=occ.device))


def _shift2(arr: torch.Tensor, di: int, dj: int, fill) -> torch.Tensor:
    """out[i,j] = arr[i+di, j+dj], static offsets, fill outside."""
    X, Y = arr.shape
    padi = (max(0, -di), max(0, di))
    padj = (max(0, -dj), max(0, dj))
    out = torch.nn.functional.pad(arr[None], (padj[0], padj[1], padi[0], padi[1]), value=fill)[0]
    return out[padi[0] + di: padi[0] + di + X, padj[0] + dj: padj[0] + dj + Y]


def _fma_sum(terms):
    """Σ a·b over the (a, b) pairs in order, rounded as the reference's
    compiled chain of adds: the first two terms as fma(a0, b0, fl(a1·b1)),
    every later one as fma(a, b, acc)."""
    (a0, b0), (a1, b1) = terms[0], terms[1]
    acc = fma32(a0, b0, a1 * b1)
    for a, b in terms[2:]:
        acc = fma32(a, b, acc)
    return acc


def plane_fit_plain(cfg: GvomConfig, hm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(roughness, slope_x, slope_y) of the 3×3 plane fit of hm [X, Y]: the
    plain twin of the plane-fit kernel, plane_fit_inputs then its tail."""
    return plane_fit_tail_plain(*plane_fit_inputs(cfg, hm))


def plane_fit_inputs(cfg: GvomConfig, hm: torch.Tensor):
    """The 3×3 plane fit of the height map hm [X, Y] up to its tail: (mean
    squared residual err, the fit's `ok` mask, the normalized coefficients
    a0n and a1n, 1/m), each [X, Y].

    The arithmetic is gvom_tpu/ops/maps2d.py's, rounded as its compiled form
    rounds it: each sum of products and each `s − c·m·m'` is a chain of
    fused multiply-adds, and a/m with a = n/det is n/(det·m). So the fit's
    `ok` test and the normalized coefficients are bitwise those of the JAX
    package, and so are the tail's log and atan2 (grid.log32 and
    grid.atan2_32)."""
    dev = hm.device
    res = torch.tensor(cfg.xy_resolution, dtype=torch.float32, device=dev)
    known = hm > UNKNOWN_HEIGHT
    kf = known.float()
    hz = torch.where(known, hm, torch.zeros_like(hm))
    offs = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]
    ks = [_shift2(kf, di, dj, 0.0) for di, dj in offs]
    zs = [_shift2(hz, di, dj, 0.0) for di, dj in offs]
    dxs = [di * res for di, _ in offs]
    dys = [dj * res for _, dj in offs]

    cnt = ks[0]
    sz = zs[0]
    for k, z in zip(ks[1:], zs[1:]):
        cnt = cnt + k
        sz = sz + z
    sx = _fma_sum(list(zip(ks, dxs)))
    sy = _fma_sum(list(zip(ks, dys)))
    sxx = _fma_sum([(k, dx * dx) for k, dx in zip(ks, dxs)])
    sxy = _fma_sum([(k, dx * dy) for k, dx, dy in zip(ks, dxs, dys)])
    syy = _fma_sum([(k, dy * dy) for k, dy in zip(ks, dys)])
    sxz = _fma_sum(list(zip(zs, dxs)))
    syz = _fma_sum(list(zip(zs, dys)))
    szz = _fma_sum(list(zip(zs, zs)))

    ok = cnt >= 3
    c = torch.where(ok, cnt, torch.ones_like(cnt))
    mx, my, mz = sx / c, sy / c, sz / c
    xx = fma32(-(c * mx), mx, sxx)
    xy = fma32(-(c * mx), my, sxy)
    xz = fma32(-(c * mx), mz, sxz)
    yy = fma32(-(c * my), my, syy)
    yz = fma32(-(c * my), mz, syz)
    zz = fma32(-(c * mz), mz, szz)
    det = fma32(xx, yy, -(xy * xy))
    ok = ok & (det != 0)
    dets = torch.where(det != 0, det, torch.ones_like(det))
    n0 = fma32(yy, xz, -(xy * yz))
    n1 = fma32(xx, yz, -(xy * xz))
    a0, a1 = n0 / dets, n1 / dets
    m = sqrt32(fma32(a0, a0, a1 * a1) + 1.0)
    a0n, a1n = n0 / (dets * m), n1 / (dets * m)
    e = zz - 2.0 * fma32(a0n, xz, a1n * yz)
    e = fma32(a0n * a0n, xx, e)
    e = fma32((a0n * 2.0) * a1n, xy, e)
    e = fma32(a1n * a1n, yy, e)
    return e / c, ok, a0n, a1n, 1.0 / m


def plane_fit_tail_plain(err: torch.Tensor, ok: torch.Tensor, a0n: torch.Tensor, a1n: torch.Tensor,
                         inv_m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The plane fit's tail, the plain twin of the tail kernel: (roughness
    = log err where err > 0, else err; slope_x = atan2(a0n, 1/m); slope_y =
    atan2(a1n, 1/m)), −1 and 0 where the fit is not `ok`
    (gvom_tpu/ops/maps2d.py:175-178)."""
    pos = err > 0
    rough = torch.where(ok, torch.where(pos, log32(torch.where(pos, err, torch.ones_like(err))), err),
                        -torch.ones_like(err))
    z0 = torch.zeros_like(err)
    return rough, torch.where(ok, atan2_32(a0n, inv_m), z0), torch.where(ok, atan2_32(a1n, inv_m), z0)


def _nearest_known_with_value(known: torch.Tensor, idx: torch.Tensor, hm: torch.Tensor, dim: int):
    """(nearest index >= i with known[index], its height) along `dim`; _BIG
    where there is none. A suffix minimum: flip, cummin, flip."""
    cand = torch.where(known, idx, torch.full_like(idx, _BIG))
    oi = torch.flip(torch.cummin(torch.flip(cand, (dim,)), dim=dim).values, (dim,))
    n = hm.shape[dim]
    oh = torch.gather(hm, dim, torch.clamp(oi, max=n - 1).long())
    return oi, oh


def guess_height_plain(cfg: GvomConfig, hm: torch.Tensor, ihm: torch.Tensor) -> torch.Tensor:
    """The JAX package's guess_height_delta in PyTorch ops, the plain twin of the
    guess-height kernel."""
    X = cfg.xy_size
    R = cfg.guess_search_radius
    dev = hm.device
    known = hm > UNKNOWN_HEIGHT
    ar = torch.arange(X, dtype=torch.int32, device=dev)
    xidx = ar[:, None].expand(X, X)
    yidx = ar[None, :].expand(X, X)
    ny_idx, ny_val = _nearest_known_with_value(known, yidx, hm, dim=1)  # along y, per row
    nx_idx, nx_val = _nearest_known_with_value(known, xidx, hm, dim=0)  # along x, per column
    x0, y0 = xidx, yidx
    UH = torch.tensor(UNKNOWN_HEIGHT, dtype=torch.float32, device=dev)

    done = {d: torch.zeros((X, X), dtype=torch.bool, device=dev) for d in ("xp", "xn", "yp", "yn")}
    hval = {d: torch.full((X, X), UNKNOWN_HEIGHT, dtype=torch.float32, device=dev) for d in ("xp", "xn", "yp", "yn")}
    running = torch.ones((X, X), dtype=torch.bool, device=dev)

    def row_query(n_idx, n_val, row_shift, lo_shift):
        shifted_i = _shift2(n_idx, row_shift, lo_shift, _BIG)
        shifted_v = _shift2(n_val, row_shift, lo_shift, UNKNOWN_HEIGHT)
        row_i = _shift2(n_idx, row_shift, 0, _BIG)
        row_v = _shift2(n_val, row_shift, 0, UNKNOWN_HEIGHT)
        clamped = y0 + lo_shift < 0
        return (torch.where(clamped, row_i[:, 0:1].expand(X, X), shifted_i),
                torch.where(clamped, row_v[:, 0:1].expand(X, X), shifted_v))

    def col_query(n_idx, n_val, col_shift, lo_shift):
        shifted_i = _shift2(n_idx, lo_shift, col_shift, _BIG)
        shifted_v = _shift2(n_val, lo_shift, col_shift, UNKNOWN_HEIGHT)
        col_i = _shift2(n_idx, 0, col_shift, _BIG)
        col_v = _shift2(n_val, 0, col_shift, UNKNOWN_HEIGHT)
        clamped = x0 + lo_shift < 0
        return (torch.where(clamped, col_i[0:1, :].expand(X, X), shifted_i),
                torch.where(clamped, col_v[0:1, :].expand(X, X), shifted_v))

    def update(d, active, oob, found, val):
        take = active & ~done[d] & ~oob & found
        hval[d] = torch.where(take, val, hval[d])
        done[d] = done[d] | (active & ~done[d] & (oob | found))

    for i in range(1, R + 1):
        active = running
        cand, val = row_query(ny_idx, ny_val, i, -i)          # x_p (gvom.py:588-599)
        update("xp", active, x0 + i >= X, cand <= torch.clamp(y0 + i - 1, max=X - 1), val)
        cand, val = row_query(ny_idx, ny_val, -i, -i + 1)     # x_n (gvom.py:601-612)
        update("xn", active, x0 - i < 0, cand <= torch.clamp(y0 + i, max=X - 1), val)
        cand, val = col_query(nx_idx, nx_val, i, -i + 1)      # y_p (gvom.py:614-625)
        update("yp", active, y0 + i >= X, cand <= torch.clamp(x0 + i, max=X - 1), val)
        cand, val = col_query(nx_idx, nx_val, -i, -i)         # y_n (gvom.py:627-638)
        update("yn", active, y0 - i < 0, cand <= torch.clamp(x0 + i - 1, max=X - 1), val)
        # loop-exit quirk: x_p_done is never tested (gvom.py:581)
        running = running & ~(done["xn"] & done["yp"] & done["yn"])

    min_h = torch.full((X, X), 1000.0, dtype=torch.float32, device=dev)
    max_h = torch.where(ihm != UNKNOWN_HEIGHT, ihm, UH)
    for d, guard in (("xp", "xp"), ("xn", "xn"), ("yp", "yp"), ("yn", "xn")):
        # the y_n merge is guarded by x_n's sentinel — reference quirk (gvom.py:655)
        g = hval[guard] > UNKNOWN_HEIGHT
        v = hval[d]
        min_h = torch.where(g, torch.minimum(v, min_h), min_h)
        max_h = torch.where(g, torch.maximum(v, max_h), max_h)
    dh = max_h - min_h
    return torch.where((~known) & (ihm != UNKNOWN_HEIGHT) & (dh > 0), dh, torch.zeros_like(dh))


def _band_limits(cfg: GvomConfig, hm: torch.Tensor, origin: torch.Tensor):
    """Window-relative z band [lo, hi] above each column's height."""
    o2 = origin[2].float()
    inv_z = float(torch.reciprocal(torch.tensor(cfg.z_resolution, dtype=torch.float32)))
    lo = torch.floor(fma32(hm + cfg.positive_obstacle_threshold, inv_z, -o2.expand_as(hm))).to(torch.int32) + 1
    hi = torch.floor(fma32(hm + cfg.robot_height, inv_z, -o2.expand_as(hm))).to(torch.int32)
    Z = cfg.z_size
    band_ok = (lo >= 0) & (lo < Z) & (hi >= 0) & (hi < Z)
    return lo, hi, band_ok


def positive_obstacle_from_band(cfg: GvomConfig, num, den, band_ok, slope_x, slope_y) -> torch.Tensor:
    """Assemble the positive-obstacle map from per-column band sums
    (integer hit and total sums over strong voxels in the band)."""
    steep = sqrt32(fma32(slope_x, slope_x, slope_y * slope_y)) >= float(
        torch.tensor(cfg.slope_obstacle_threshold, dtype=torch.float32))
    num = num.float()
    den = den.float()
    dens = torch.where(den > 0, num / torch.where(den > 0, den, torch.ones_like(den)), torch.zeros_like(den))
    val = (dens * 100.0).to(torch.int32)
    return torch.where(steep, 100, torch.where(band_ok > 0, val, 0)).to(torch.int32)


def positive_band_sums(cfg: GvomConfig, occ, hit, total, hm, origin):
    """Per column (torus [X,Y]): the hit and total sums over strong occupied
    voxels in the band [height+threshold, height+robot_height], and whether
    the band lies inside the window, all int32 (plain twin of kernel K4's
    band sums)."""
    lo, hi, band_ok = _band_limits(cfg, hm, origin)
    zs = _z_priority(cfg, origin)
    sel = (zs >= lo[..., None]) & (zs <= hi[..., None]) & occ & (hit > cfg.hit_count_threshold)
    num = torch.where(sel, hit, 0).sum(dim=-1).to(torch.int32)
    den = torch.where(sel, total, 0).sum(dim=-1).to(torch.int32)
    return num, den, band_ok.to(torch.int32)


def negative_obstacle_map(cfg: GvomConfig, guessed_delta: torch.Tensor) -> torch.Tensor:
    """gvom.py:477-485."""
    thr = float(torch.tensor(cfg.negative_obstacle_threshold, dtype=torch.float32))
    return torch.where(guessed_delta > thr, 100, 0).to(torch.int32)


def visibility_map(hm: torch.Tensor) -> torch.Tensor:
    """gvom.py:412-422."""
    return (hm > UNKNOWN_HEIGHT).to(torch.int32)


def maps_to_window_plain(hm_t: torch.Tensor, ihm_t: torch.Tensor, origin: torch.Tensor):
    """(height, inferred height) in window layout from the torus-layout
    column maps: the plain twin of the plane-fit kernel's load."""
    return torus_to_window(hm_t, origin, grid_ndim=2), torus_to_window(ihm_t, origin, grid_ndim=2)


def map_products_plain(cfg: GvomConfig, pnum, pden, band_ok, slope_x, slope_y, ghd, hm, origin):
    """(positive_obstacle, negative_obstacle, visibility) in window layout:
    the positive obstacle from the torus-layout band sums (band_ok int32)
    and the window-layout slopes moved onto the torus, as the JAX
    package computes it; the plain twin of the guess kernel's epilogue."""
    sx_t = window_to_torus(slope_x, origin, grid_ndim=2)
    sy_t = window_to_torus(slope_y, origin, grid_ndim=2)
    pos_t = positive_obstacle_from_band(cfg, pnum, pden, band_ok, sx_t, sy_t)
    return (torus_to_window(pos_t, origin, grid_ndim=2), negative_obstacle_map(cfg, ghd), visibility_map(hm))


def plane_fit_window_plain(cfg: GvomConfig, hm_t: torch.Tensor, ihm_t: torch.Tensor, origin: torch.Tensor):
    """(height, inferred height, roughness, slope_x, slope_y) [X, X] in
    window layout from the torus-layout column maps: the plain twin of the
    plane-fit kernel, maps_to_window_plain then plane_fit_plain."""
    hm, ihm = maps_to_window_plain(hm_t, ihm_t, origin)
    return (hm, ihm) + plane_fit_plain(cfg, hm)


def guess_products_plain(cfg: GvomConfig, hm, ihm, slope_x, slope_y, pnum, pden, band_ok, origin):
    """(guessed_height_delta, positive_obstacle, negative_obstacle,
    visibility) [X, X] in window layout: the plain twin of the guess-height
    kernel, guess_height_plain then map_products_plain."""
    ghd = guess_height_plain(cfg, hm, ihm)
    return (ghd,) + map_products_plain(cfg, pnum, pden, band_ok, slope_x, slope_y, ghd, hm, origin)
