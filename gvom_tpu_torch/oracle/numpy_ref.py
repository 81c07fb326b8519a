"""Pure-NumPy golden model of the reference G-VOM semantics.

This is the test oracle (the reference itself needs a CUDA GPU; this runs
anywhere) — a from-scratch NumPy implementation of the *observable semantics*
of the reference's scripts/gvom.py, written against the behavior of its kernels
(file:line cited per stage) rather than translated from them. Vectorized where
that cannot change results (integer scatter-adds are associative; f64 float
sums are tolerance-tested), sequential where the reference order matters
(buffer-slot merge order, gvom.py:198-266).

Replicated quirks (see ARCHITECTURE.md):
  * min_distance filters on the post-transform (world-frame) point norm
    (gvom.py:1064-1068 runs after __transform_pointcloud).
  * __guess_height loop-exit tests x_n_done twice, never x_p_done (gvom.py:581),
    and merges y_nh under the x_nh guard (gvom.py:655-657).
  * positive-obstacle min height index +1 offset (gvom.py:503).
  * previous-map double counting: each combine re-adds buffered scans on top of
    the previous combined map which already contains them (gvom.py:198-266).
  * scans whose points hit zero in-bounds voxels are dropped, even though their
    rays would have contributed free-space evidence (gvom.py:148-150).

Documented divergence: ray positions are evaluated as start + k*step (exact
affine form) rather than the reference's sequentially accumulated f32 adds
(gvom.py:1128-1132) — same math, different last-bit rounding. The engine
uses the same affine form, but rounds it as one fused multiply-add,
fma(k, step, start), as the JAX package's compiled raycast does (XLA:CPU
contracts the product into the add); this oracle rounds the product first.
So the two agree on ray geometry except at FMA knife-edges, where a floor
of the position lands one voxel apart: on the 16×16×32 grid of
tests/test_torch_raycast.py, 2 to 8 voxels' pass counts on 8 of 15 scans.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import numpy as np

from gvom_tpu_torch.config import GvomConfig

__all__ = ["NumpyOracle", "ScanMap", "CombinedMap"]

UNKNOWN = -1000.0


class ScanMap:
    """One scan's dense voxel map (reference buffer entry, gvom.py:163-169)."""

    def __init__(self, origin, hit, passes, min_height, n, mean, cov):
        self.origin = origin          # [3] int64, voxel units
        self.hit = hit                # [X,Y,Z] int64
        self.passes = passes          # [X,Y,Z] int64 (ray pass-throughs; reference total = hit+passes)
        self.min_height = min_height  # [X,Y,Z] f64, init 1.0
        self.n = n                    # [X,Y,Z] f64 — neighborhood point count (metrics[9])
        self.mean = mean              # [X,Y,Z,3] f64 — voxel-local mean (metrics[0:3])
        self.cov = cov                # [X,Y,Z,6] f64 — normalized covariance (metrics[3:9])

    @property
    def occ(self):
        return self.hit > 0


class CombinedMap(ScanMap):
    """Fused map; adds the index-map negative-evidence accumulator
    (reference combined_index_map values < -1, gvom.py:962-968)."""

    def __init__(self, origin, hit, passes, min_height, n, mean, cov, evidence):
        super().__init__(origin, hit, passes, min_height, n, mean, cov)
        self.evidence = evidence      # [X,Y,Z] int64 — accumulated miss evidence while unoccupied


def _shift_to(arr: np.ndarray, d: np.ndarray, fill) -> np.ndarray:
    """aligned[v] = arr[v + d] with `fill` outside — the integer re-origin
    offset used by every combine kernel (gvom.py:829-839)."""
    out = np.full_like(arr, fill)
    src_lo, src_hi, dst_lo, dst_hi = [], [], [], []
    for ax in range(3):
        s = arr.shape[ax]
        lo = max(0, -int(d[ax]))
        hi = min(s, s - int(d[ax]))
        if lo >= hi:
            return out
        dst_lo.append(lo)
        dst_hi.append(hi)
        src_lo.append(lo + int(d[ax]))
        src_hi.append(hi + int(d[ax]))
    dst = tuple(slice(dst_lo[i], dst_hi[i]) for i in range(3))
    src = tuple(slice(src_lo[i], src_hi[i]) for i in range(3))
    out[dst] = arr[src]
    return out


def _shared_ray_geometry(cfg: GvomConfig, pk: np.ndarray, ego: np.ndarray):
    """Engine-identical per-ray march parameters (see gvom_tpu_torch.ops.raycast),
    computed on the CPU."""
    import torch

    from gvom_tpu_torch.ops.raycast import ray_geometry

    pts = torch.from_numpy(pk.astype(np.float32))
    start, step, delta, budget, dom, _ = ray_geometry(
        cfg, pts, torch.ones((pts.shape[0],), dtype=torch.bool), torch.from_numpy(ego.astype(np.float32)))
    return start.numpy(), step.numpy(), delta.numpy(), budget.numpy(), dom.numpy()


class NumpyOracle:
    """Reference-semantics engine. API mirrors the reference class
    (gvom.py:99, gvom.py:177, gvom.py:356-410)."""

    def __init__(self, cfg: GvomConfig):
        self.cfg = cfg
        self.buffer: List[Optional[ScanMap]] = [None] * cfg.buffer_size
        self.cursor = 0
        self.last_slot = 0
        self.combined: Optional[CombinedMap] = None
        self.last_combined: Optional[CombinedMap] = None
        self.ego_position = np.zeros(3)
        # 2D products of the last combine (for debug exporters)
        self.height_map = None
        self.inferred_height_map = None
        self.roughness_map = None
        self.x_slope_map = None
        self.y_slope_map = None
        self.guessed_height_delta = None
        self.positive_obstacle = None
        self.eigenvalues = None       # [X,Y,Z,3]

    # ------------------------------------------------------------------
    # ingest (reference process_pointcloud, gvom.py:99-175)

    def process_pointcloud(self, points: np.ndarray, ego_position, transform: Optional[np.ndarray] = None):
        cfg = self.cfg
        self.ego_position = np.asarray(ego_position, dtype=np.float64)
        if points.shape[0] == 0:
            return None
        pts = np.asarray(points, dtype=np.float64)
        if transform is not None:
            t = np.asarray(transform, dtype=np.float64)
            pts = pts @ t[:3, :3].T + t[:3, 3]

        res = np.array([cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution])
        size = np.array([cfg.xy_size, cfg.xy_size, cfg.z_size])
        # index-space math in f32 to match the engine (and the reference's
        # f32 kernel-local arrays) bit-for-bit; accumulations stay f64
        origin = np.floor(
            self.ego_position.astype(np.float32) / res.astype(np.float32)
            - (size / 2.0).astype(np.float32)
        ).astype(np.int64)

        # world-frame norm filter (reference quirk; gvom.py:1064-1068)
        if cfg.ego_relative_min_distance:
            d2 = np.sum((pts - self.ego_position) ** 2, axis=1)
        else:
            d2 = np.sum(pts * pts, axis=1)
        keep = d2 >= cfg.min_distance ** 2
        pk = pts[keep]

        # --- endpoint binning (gvom.py:1072-1090) ---
        pn32 = pk.astype(np.float32) / res.astype(np.float32) - origin.astype(np.float32)
        vox = np.floor(pn32).astype(np.int64)
        inb = np.all((vox >= 0) & (vox < size), axis=1)
        hit = np.zeros(tuple(size), np.int64)
        np.add.at(hit, tuple(vox[inb].T), 1)

        # --- ray free-space march (gvom.py:1091-1150) ---
        passes = self._raycast(pk, origin)

        if not np.any(hit > 0):
            return None  # reference drops the scan entirely (gvom.py:148-150)

        # --- metrics (gvom.py:1004-1036) ---
        n, mean, cov = self._metrics(pk, origin, hit)
        min_height = self._min_height(pk, vox, inb, origin)

        sm = ScanMap(origin, hit, passes, min_height, n, mean, cov)
        self.buffer[self.cursor] = sm
        self.last_slot = self.cursor
        self.cursor = (self.cursor + 1) % cfg.buffer_size
        return sm

    def _raycast(self, pk: np.ndarray, origin: np.ndarray) -> np.ndarray:
        """Dominant-axis DDA from ego toward each point, counting traversed
        voxels, stopping at the grid boundary or ~1 unit before the endpoint
        (gvom.py:1091-1150). Ray math in f32 like the reference kernel."""
        cfg = self.cfg
        size = np.array([cfg.xy_size, cfg.xy_size, cfg.z_size])
        passes = np.zeros(tuple(size), np.int64)
        if pk.shape[0] == 0:
            return passes
        # Float-sensitive geometry (the sqrt/division chain) comes from the
        # same jitted helper the engine uses: XLA's division/rsqrt are not
        # bit-identical to NumPy's, and a 1-ulp difference flips floor()
        # decisions at voxel boundaries. Sharing the geometry makes
        # oracle↔engine index decisions exact; all DDA accumulation semantics
        # stay here in NumPy.
        start, step, delta, budget, dom = _shared_ray_geometry(cfg, pk, self.ego_position)
        start_rel = start - origin.astype(np.float32)                  # same fold as the engine
        alive = budget >= 0
        n_steps = max(1, cfg.ray_steps)
        nray = pk.shape[0]
        # dominant-axis row in integer arithmetic — floor(start)±k, the exact
        # value of floor(start_dom + k·(±1)); the f32 sum can round a
        # knife-edge start one row off when the add crosses a binade. The
        # engine paths (ops/raycast.py, the Pallas placement) use the same
        # integer convention, so index decisions agree by construction.
        s_dom = step[np.arange(nray), dom]
        sgn = np.where(s_dom < 0, -1, 1).astype(np.int64)
        x0_dom = np.floor(start_rel).astype(np.int64)[dom]
        for k in range(1, n_steps + 1):
            # step k taken iff (k-1)*delta < length-1 (gvom.py:1127,1150)
            cond = alive & (np.float32(k - 1) * delta < budget)
            if not cond.any():
                break
            pos = start_rel[None, :] + np.float32(k) * step            # affine form (see module docstring)
            idx = np.floor(pos).astype(np.int64)
            idx[np.arange(nray), dom] = x0_dom + k * sgn
            inb = np.all((idx >= 0) & (idx < size[None, :]), axis=1)
            alive = alive & (inb | ~cond)                              # OOB while active kills the ray
            act = cond & inb & alive
            np.add.at(passes, tuple(idx[act].T), 1)
        return passes

    def _metrics(self, pk, origin, hit):
        """Neighborhood-expanded mean and covariance (gvom.py:1170-1299):
        every point contributes to all occupied voxels within
        ±xy_eigen_dist/±z_eigen_dist of its own voxel, with coordinates
        local to each receiving voxel. Two passes (mean, then covariance
        against the normalized mean), matching the reference numerics."""
        cfg = self.cfg
        size = np.array([cfg.xy_size, cfg.xy_size, cfg.z_size])
        shape = tuple(size)
        n = np.zeros(shape)
        s1 = np.zeros(shape + (3,))
        res = np.array([cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution])
        pn = pk / res - origin[None, :]                                # normalized, map-local units (f64 values)
        pn32 = pk.astype(np.float32) / res.astype(np.float32) - origin.astype(np.float32)
        base = np.floor(pn32).astype(np.int64)                         # f32 index decisions match the engine
        occ = hit > 0
        offsets = [
            (dx, dy, dz)
            for dx in range(-cfg.xy_eigen_dist, cfg.xy_eigen_dist + 1)
            for dy in range(-cfg.xy_eigen_dist, cfg.xy_eigen_dist + 1)
            for dz in range(-cfg.z_eigen_dist, cfg.z_eigen_dist + 1)
        ]
        contribs = []  # (target voxel idx [M,3], local coords [M,3]) per offset
        for off in offsets:
            tgt = base + np.array(off, np.int64)[None, :]
            ok = np.all((tgt >= 0) & (tgt < size[None, :]), axis=1)
            tgt = tgt[ok]
            ok2 = occ[tuple(tgt.T)]
            tgt = tgt[ok2]
            local = pn[ok][ok2] - tgt                                  # voxel-local coords (gvom.py:1205-1207)
            contribs.append((tgt, local))
            np.add.at(n, tuple(tgt.T), 1.0)
            np.add.at(s1, tuple(tgt.T), local)
        mean = np.zeros(shape + (3,))
        nz = n > 0
        mean[nz] = s1[nz] / n[nz][:, None]
        # second pass: covariance vs normalized means (gvom.py:1232-1299)
        cov = np.zeros(shape + (6,))
        pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
        for tgt, local in contribs:
            if len(tgt) == 0:
                continue
            dm = local - mean[tuple(tgt.T)]
            prods = np.stack([dm[:, i] * dm[:, j] for i, j in pairs], axis=1)
            np.add.at(cov, tuple(tgt.T), prods)
        cov[nz] = cov[nz] / n[nz][:, None]
        cov[~nz] = 0.0
        return n, mean, cov

    def _min_height(self, pk, vox, inb, origin):
        cfg = self.cfg
        mh = np.ones(self.cfg.grid_shape)
        res = np.array([cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution])
        localz = (pk / res - origin[None, :] - vox)[:, 2]
        np.minimum.at(mh, tuple(vox[inb].T), localz[inb])
        return mh

    # ------------------------------------------------------------------
    # fusion + 2D maps (reference combine_maps, gvom.py:177-354)

    def combine_maps(self):
        cfg = self.cfg
        if self.buffer[self.last_slot] is None:
            return None
        origin = self.buffer[self.last_slot].origin.copy()
        shape = cfg.grid_shape

        occ = np.zeros(shape, bool)
        evidence = np.zeros(shape, np.int64)
        # slot-order index fusion (gvom.py:198-208): occupied wins and latches;
        # misses accumulate only while the voxel is still unoccupied.
        slot_maps = []
        for sm in self.buffer:
            if sm is None:
                slot_maps.append(None)
                continue
            d = origin - sm.origin
            a_hit = _shift_to(sm.hit, d, 0)
            a_pass = _shift_to(sm.passes, d, 0)
            slot_maps.append((d, a_hit, a_pass))
            s_occ = a_hit > 0
            s_miss = (a_hit == 0) & (a_pass > 0)
            evidence = np.where(s_miss & ~occ, evidence + a_pass, evidence)
            occ = occ | s_occ
        # previous combined map with staleness veto (gvom.py:210-216, 992-997)
        old_aligned = None
        if self.last_combined is not None:
            lc = self.last_combined
            d = origin - lc.origin
            o_hit = _shift_to(lc.hit, d, 0)
            o_ev = _shift_to(lc.evidence, d, 0)
            o_occ = o_hit > 0
            revive = o_occ & ~occ & (evidence <= cfg.decay_miss_limit)
            occ = occ | revive
            o_miss = ~o_occ & (o_ev > 0)
            evidence = np.where(o_miss & ~occ, evidence + o_ev, evidence)
            old_aligned = d

        # data fusion (gvom.py:238-266): sequential per-slot merge where both occupied
        hit = np.zeros(shape, np.int64)
        passes = np.zeros(shape, np.int64)
        min_height = np.ones(shape)
        n = np.zeros(shape)
        mean = np.zeros(shape + (3,))
        cov = np.zeros(shape + (6,))

        def merge(src: ScanMap, d):
            nonlocal hit, passes, min_height, n, mean, cov
            a_hit = _shift_to(src.hit, d, 0)
            m = occ & (a_hit > 0)
            a_pass = _shift_to(src.passes, d, 0)
            a_mh = _shift_to(src.min_height, d, 1.0)
            a_n = _shift_to(src.n, d, 0.0)
            a_mean = np.stack([_shift_to(src.mean[..., i], d, 0.0) for i in range(3)], axis=-1)
            a_cov = np.stack([_shift_to(src.cov[..., i], d, 0.0) for i in range(6)], axis=-1)
            hit = np.where(m, hit + a_hit, hit)
            passes = np.where(m, passes + a_pass, passes)
            min_height = np.where(m, np.minimum(min_height, a_mh), min_height)
            # parallel-axis covariance merge (gvom.py:853-909)
            n1, n2 = n[m], a_n[m]
            tot = n1 + n2
            safe = np.where(tot > 0, tot, 1.0)
            mu1, mu2 = mean[m], a_mean[m]
            muc = (mu1 * n1[:, None] + mu2 * n2[:, None]) / safe[:, None]
            pairs = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
            c1, c2 = cov[m], a_cov[m]
            newc = np.empty_like(c1)
            for k, (i, j) in enumerate(pairs):
                newc[:, k] = (
                    n1 * c1[:, k] + n2 * c2[:, k]
                    + n1 * (mu1[:, i] - muc[:, i]) * (mu1[:, j] - muc[:, j])
                    + n2 * (mu2[:, i] - muc[:, i]) * (mu2[:, j] - muc[:, j])
                ) / safe
            cov[m] = newc
            mean[m] = muc
            n[m] = tot

        for sm, aligned in zip(self.buffer, slot_maps):
            if sm is not None:
                merge(sm, origin - sm.origin)
        if self.last_combined is not None:
            merge(self.last_combined, old_aligned)

        cm = CombinedMap(origin, hit, passes, min_height, n, mean, cov, evidence)
        # reference reads occupancy from the index map; our dense encoding
        # needs the revive path reflected in `hit` for downstream column scans —
        # vetoed-in voxels have hit>0 via the old-map merge, but a revived voxel
        # whose old hit aligned to 0 cannot exist (revive requires o_hit>0).
        cm.occ_mask = occ
        self.combined = cm
        self.last_combined = cm

        # ---- 2D products ----
        self.eigenvalues = self._eigenvalues(cm)
        self.height_map = self._make_height_map(cm)
        self.inferred_height_map = self._make_inferred_height_map(cm)
        self.x_slope_map, self.y_slope_map, self.roughness_map = self._calculate_slope(self.height_map)
        self.guessed_height_delta = self._guess_height(self.height_map, self.inferred_height_map)
        pos = self._positive_obstacle(cm, self.height_map, self.x_slope_map, self.y_slope_map)
        neg = np.where(self.guessed_height_delta > self.cfg.negative_obstacle_threshold, 100, 0).astype(np.int64)
        vis = (self.height_map > UNKNOWN).astype(np.int64)
        self.positive_obstacle = pos
        res = np.array([cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution])
        origin_world = origin * res
        return origin_world, pos, neg, self.roughness_map.copy(), vis

    # ---- K16: closed-form symmetric 3x3 eigenvalues (gvom.py:1331-1378) ----
    def _eigenvalues(self, cm: CombinedMap):
        xx, xy, xz, yy, yz, zz = [cm.cov[..., i] for i in range(6)]
        p1 = xy * xy + xz * xz + yz * yz
        q = (xx + yy + zz) / 3.0
        ev = np.zeros(cm.cov.shape[:3] + (3,))
        diag = p1 == 0
        e0d = np.maximum(xx, np.maximum(yy, zz))
        e2d = np.minimum(xx, np.minimum(yy, zz))
        p2 = (xx - q) ** 2 + (yy - q) ** 2 + (zz - q) ** 2 + 2.0 * p1
        p = np.sqrt(np.maximum(p2 / 6.0, 0))
        ps = np.where(p > 0, p, 1.0)
        b = [(xx - q) / ps, xy / ps, xz / ps, (yy - q) / ps, yz / ps, (zz - q) / ps]
        r = (
            b[0] * (b[3] * b[5] - b[4] * b[4])
            - b[1] * (b[1] * b[5] - b[4] * b[2])
            + b[2] * (b[1] * b[4] - b[3] * b[2])
        ) / 2.0
        phi = np.where(r <= -1, math.pi / 3.0, np.where(r >= 1, 0.0, np.arccos(np.clip(r, -1, 1)) / 3.0))
        e0 = q + 2.0 * p * np.cos(phi)
        e2 = q + 2.0 * p * np.cos(phi + 2.0 * math.pi / 3.0)
        ev[..., 0] = np.where(diag, e0d, e0)
        ev[..., 2] = np.where(diag, e2d, e2)
        ev[..., 1] = 3.0 * q - ev[..., 0] - ev[..., 2]
        ev[~(cm.occ_mask)] = 0.0
        return ev

    # ---- K17: height map (gvom.py:523-540) ----
    def _make_height_map(self, cm: CombinedMap):
        cfg = self.cfg
        X = cfg.xy_size
        hm = np.full((X, X), UNKNOWN)
        # ego disk pre-seed (gvom.py:531-534)
        gx = (cm.origin[0] + np.arange(X))[:, None] * cfg.xy_resolution - self.ego_position[0]
        gy = (cm.origin[1] + np.arange(X))[None, :] * cfg.xy_resolution - self.ego_position[1]
        disk = gx * gx + gy * gy <= cfg.robot_radius ** 2
        hm[disk] = self.ego_position[2] - cfg.ground_to_lidar_height
        occ = cm.occ_mask
        any_occ = occ.any(axis=2)
        zfirst = np.argmax(occ, axis=2)
        mh = np.take_along_axis(cm.min_height, zfirst[..., None], axis=2)[..., 0]
        col_h = (mh + zfirst + cm.origin[2]) * cfg.z_resolution
        return np.where(any_occ, col_h, hm)

    # ---- K18: inferred height map (gvom.py:542-554) ----
    def _make_inferred_height_map(self, cm: CombinedMap):
        cfg = self.cfg
        miss = (~cm.occ_mask) & (cm.evidence > 0)
        any_miss = miss.any(axis=2)
        zfirst = np.argmax(miss, axis=2)
        ih = (zfirst + cm.origin[2]) * cfg.z_resolution
        return np.where(any_miss, ih, UNKNOWN)

    # ---- K19: 3x3 plane fit slope + roughness (gvom.py:663-734) ----
    def _calculate_slope(self, hm: np.ndarray):
        cfg = self.cfg
        X = cfg.xy_size
        known = hm > UNKNOWN
        xs = np.arange(X)[:, None, None] * cfg.xy_resolution  # world-scaled grid index (gvom.py:687)
        ys = np.arange(X)[None, :, None] * cfg.xy_resolution
        cnt = np.zeros((X, X))
        sx = np.zeros((X, X)); sy = np.zeros((X, X)); sz = np.zeros((X, X))
        sxx = np.zeros((X, X)); sxy = np.zeros((X, X)); sxz = np.zeros((X, X))
        syy = np.zeros((X, X)); syz = np.zeros((X, X)); szz = np.zeros((X, X))
        kz = np.where(known, hm, 0.0)
        kx = np.where(known, np.broadcast_to(xs[..., 0], hm.shape), 0.0)
        ky = np.where(known, np.broadcast_to(ys[..., 0], hm.shape), 0.0)

        def acc(dst, src, di, dj):
            s0 = slice(max(0, -di), min(X, X - di))
            s1 = slice(max(0, -dj), min(X, X - dj))
            t0 = slice(max(0, di), min(X, X + di))
            t1 = slice(max(0, dj), min(X, X + dj))
            dst[s0, s1] += src[t0, t1]

        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                acc(cnt, known.astype(np.float64), di, dj)
                acc(sx, kx, di, dj); acc(sy, ky, di, dj); acc(sz, kz, di, dj)
                acc(sxx, kx * kx, di, dj); acc(sxy, kx * ky, di, dj); acc(sxz, kx * kz, di, dj)
                acc(syy, ky * ky, di, dj); acc(syz, ky * kz, di, dj); acc(szz, kz * kz, di, dj)

        ok = cnt >= 3
        c = np.where(ok, cnt, 1.0)
        mx, my, mz = sx / c, sy / c, sz / c
        xx = sxx - c * mx * mx
        xy = sxy - c * mx * my
        xz = sxz - c * mx * mz
        yy = syy - c * my * my
        yz = syz - c * my * mz
        zz = szz - c * mz * mz
        det = xx * yy - xy * xy
        ok = ok & (det != 0)
        dets = np.where(det != 0, det, 1.0)
        a0 = (yy * xz - xy * yz) / dets
        a1 = (xx * yz - xy * xz) / dets
        m = np.sqrt(a0 * a0 + a1 * a1 + 1.0)
        a0n, a1n = a0 / m, a1 / m
        # plane-fit MSE: mean squared residual of centered heights vs the fit
        err = (zz - 2.0 * (a0n * xz + a1n * yz) + a0n * a0n * xx + 2.0 * a0n * a1n * xy + a1n * a1n * yy) / c
        err = np.where(err > 0, np.log(np.where(err > 0, err, 1.0)), err)
        rough = np.where(ok, err, -1.0)
        slope_x = np.where(ok, np.arctan2(a0n, 1.0 / m), 0.0)
        slope_y = np.where(ok, np.arctan2(a1n, 1.0 / m), 0.0)
        return slope_x, slope_y, rough

    # ---- K20: guessed height delta (gvom.py:556-661), quirks and all ----
    def _guess_height(self, hm: np.ndarray, ihm: np.ndarray):
        cfg = self.cfg
        X = cfg.xy_size
        R = cfg.guess_search_radius
        known = hm > UNKNOWN
        out = np.zeros((X, X))
        work = (~known) & (ihm != UNKNOWN)
        xs, ys = np.nonzero(work)
        for x0, y0 in zip(xs, ys):
            xp_done = xn_done = yp_done = yn_done = False
            xph = xnh = yph = ynh = UNKNOWN
            i = 0
            # loop-exit quirk: x_p_done is never tested (gvom.py:581)
            while i < R and not (xn_done and yp_done and yn_done):
                i += 1
                xp, xn, yp, yn = x0 + i, x0 - i, y0 + i, y0 - i
                if not xp_done:
                    if xp < X:
                        for dy in range(-i, i):           # window [-i, i) (gvom.py:590)
                            yy = y0 + dy
                            if 0 <= yy < X and hm[xp, yy] > UNKNOWN:
                                xph = hm[xp, yy]; xp_done = True; break
                    else:
                        xp_done = True
                if not xn_done:
                    if xn >= 0:
                        for dy in range(-i + 1, i + 1):   # window (-i, i] (gvom.py:603)
                            yy = y0 + dy
                            if 0 <= yy < X and hm[xn, yy] > UNKNOWN:
                                xnh = hm[xn, yy]; xn_done = True; break
                    else:
                        xn_done = True
                if not yp_done:
                    if yp < X:
                        for dx in range(-i + 1, i + 1):
                            xx = x0 + dx
                            if 0 <= xx < X and hm[xx, yp] > UNKNOWN:
                                yph = hm[xx, yp]; yp_done = True; break
                    else:
                        yp_done = True
                if not yn_done:
                    if yn >= 0:
                        for dx in range(-i, i):
                            xx = x0 + dx
                            if 0 <= xx < X and hm[xx, yn] > UNKNOWN:
                                ynh = hm[xx, yn]; yn_done = True; break
                    else:
                        yn_done = True
            min_h, max_h = 1000.0, ihm[x0, y0]
            if xph > UNKNOWN:
                min_h = min(xph, min_h); max_h = max(xph, max_h)
            if xnh > UNKNOWN:
                min_h = min(xnh, min_h); max_h = max(xnh, max_h)
            if yph > UNKNOWN:
                min_h = min(yph, min_h); max_h = max(yph, max_h)
            if xnh > UNKNOWN:  # quirk: y_nh merge guarded by x_nh (gvom.py:655)
                min_h = min(ynh, min_h); max_h = max(ynh, max_h)
            dh = max_h - min_h
            if dh > 0:
                out[x0, y0] = dh
        return out

    # ---- K21: positive obstacle map (gvom.py:487-521) ----
    def _positive_obstacle(self, cm: CombinedMap, hm, slope_x, slope_y):
        cfg = self.cfg
        X, Z = cfg.xy_size, cfg.z_size
        out = np.zeros((X, X), np.int64)
        steep = np.sqrt(slope_x ** 2 + slope_y ** 2) >= cfg.slope_obstacle_threshold
        out[steep] = 100
        # +1 offset quirk on the band start (gvom.py:503)
        lo = np.floor((hm + cfg.positive_obstacle_threshold) / cfg.z_resolution - cm.origin[2]).astype(np.int64) + 1
        hi = np.floor((hm + cfg.robot_height) / cfg.z_resolution - cm.origin[2]).astype(np.int64)
        band_ok = (lo >= 0) & (lo < Z) & (hi >= 0) & (hi < Z)
        zs = np.arange(Z)[None, None, :]
        in_band = (zs >= lo[..., None]) & (zs <= hi[..., None])
        strong = cm.occ_mask & (cm.hit > cfg.hit_count_threshold)
        tot = cm.hit + cm.passes
        num = np.where(in_band & strong, cm.hit, 0).sum(axis=2).astype(np.float64)
        den = np.where(in_band & strong, tot, 0).sum(axis=2).astype(np.float64)
        dens = np.where(den > 0, num / np.where(den > 0, den, 1.0), 0.0)
        val = (dens * 100).astype(np.int64)
        out = np.where(steep, out, np.where(band_ok, val, 0))
        return out

    # ------------------------------------------------------------------
    # exports (gvom.py:356-410)

    def get_map_as_occupancy_grid(self):
        if self.last_combined is None:
            return None
        return self.last_combined.occ_mask.copy()

    def make_debug_voxel_map(self):
        """[K,8] rows: world xyz, hit/total density, hit count, eigen features
        (λ0−λ1, λ1−λ2, λ2) for each occupied voxel (gvom.py:452-475)."""
        cm = self.combined
        if cm is None:
            return None
        cfg = self.cfg
        xs, ys, zs = np.nonzero(cm.occ_mask)
        ev = self.eigenvalues[xs, ys, zs]
        tot = (cm.hit + cm.passes)[xs, ys, zs]
        out = np.zeros((len(xs), 8), np.float32)
        out[:, 0] = (xs + cm.origin[0]) * cfg.xy_resolution
        out[:, 1] = (ys + cm.origin[1]) * cfg.xy_resolution
        out[:, 2] = (zs + cm.origin[2]) * cfg.z_resolution
        out[:, 3] = cm.hit[xs, ys, zs] / np.maximum(tot, 1)
        out[:, 4] = cm.hit[xs, ys, zs]
        out[:, 5] = ev[:, 0] - ev[:, 1]
        out[:, 6] = ev[:, 1] - ev[:, 2]
        out[:, 7] = ev[:, 2]
        return out

    def make_debug_height_map(self):
        """[X*X,7] rows: world xyz (height − z_res), roughness, slope_x,
        slope_y, |slope| (gvom.py:424-438)."""
        if self.height_map is None:
            return None
        cfg = self.cfg
        cm = self.combined
        X = cfg.xy_size
        x, y = np.meshgrid(np.arange(X), np.arange(X), indexing="ij")
        out = np.zeros((X * X, 7), np.float32)
        idx = (x + y * X).ravel()
        out[idx, 0] = ((x + cm.origin[0]) * cfg.xy_resolution).ravel()
        out[idx, 1] = ((y + cm.origin[1]) * cfg.xy_resolution).ravel()
        out[idx, 2] = (self.height_map - cfg.z_resolution).ravel()
        out[idx, 3] = self.roughness_map.ravel()
        out[idx, 4] = self.x_slope_map.ravel()
        out[idx, 5] = self.y_slope_map.ravel()
        out[idx, 6] = np.sqrt(self.x_slope_map ** 2 + self.y_slope_map ** 2).ravel()
        return out

    def make_debug_inferred_height_map(self):
        """[X*X,3] rows: world xy, guessed height delta − z_res (gvom.py:440-450)."""
        if self.guessed_height_delta is None:
            return None
        cfg = self.cfg
        cm = self.combined
        X = cfg.xy_size
        x, y = np.meshgrid(np.arange(X), np.arange(X), indexing="ij")
        out = np.zeros((X * X, 3), np.float32)
        idx = (x + y * X).ravel()
        out[idx, 0] = ((x + cm.origin[0]) * cfg.xy_resolution).ravel()
        out[idx, 1] = ((y + cm.origin[1]) * cfg.xy_resolution).ravel()
        out[idx, 2] = (self.guessed_height_delta - cfg.z_resolution).ravel()
        return out
