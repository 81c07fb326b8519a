"""The drive: a closed lap of lidar scans over seeded off-road terrain.

The terrain and the lidar model are those of the port's io/synthetic.py
(the composite terrain's rolling ground; a spinning lidar's rings ×
azimuth pattern ray-cast against the height field: a coarse march to the
first sample below the surface, then a bisection), rewritten in PyTorch so
that a lap of a thousand scans is made on the card in seconds. A ray with
no return within range is dropped, as a real lidar's no-return. Where the
terrain has a ceiling (a plane it never rises above), a ray leaves the
march once it has risen above it: the samples it skips could never be
below the surface, so the scans are the same, bit for bit.

The lap: `scans` scans on a circle, `spacing` metres apart (speed over
scan rate), the sensor `ground_to_lidar_height` above the ground. Walls,
boulders and trenches, one or none per angular sector of the lap and clear
of the path (so that each height sample looks up only its own sector's
feature), are drawn from the drive's own seed, as a recorded drive is one
drive: a run's seed draws the range noise, so every seed gives the same
work.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

__all__ = ["rolling_ground", "composite_terrain", "COMPOSITE_CEILING", "lap_features", "lap_terrain", "lap_ceiling",
           "simulate_scans", "make_lap"]

Terrain = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
Ceiling = Tuple[float, float, float]   # (a, b, c): the terrain never rises above z = a·x + b·y + c
MARCH_CHUNK = 16       # coarse samples a ray takes at once before the rays that hit or rose above leave the march
SCANS_PER_CALL = 32    # scans simulated together (their noise is drawn together)
COARSE_STEP_M = 0.25   # io/synthetic's march: its coarse step and bisection steps
REFINE_ITERS = 24
CEILING_MARGIN_M = 0.5  # above a ceiling, against the rounding of the height and of the ray in float32
RAMP, BUMP_M = 0.05, 0.15


def rolling_ground(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """io/synthetic.composite_terrain's ground: a 5 % ramp along x and
    bumps of 0.15 m."""
    return RAMP * x + BUMP_M * torch.sin(0.5 * x) * torch.cos(0.4 * y)


def composite_terrain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """io/synthetic.composite_terrain: the ground, a 3 m wall at x = 14 and a
    2 m trench at y = 10."""
    base = rolling_ground(x, y)
    base = torch.where((x - 14.0).abs() < 0.6, base + 3.0, base)
    return torch.where((y - 10.0).abs() < 1.2, base - 2.0, base)


COMPOSITE_CEILING: Ceiling = (RAMP, 0.0, BUMP_M + 3.0)


# a feature's columns: centre angle, centre radius, box half-extents along the
# lap (tangential) and across it (radial), box height (a wall > 0, a trench
# < 0), dome radius and dome height (a boulder)
_THETA, _RADIUS, _HALF_T, _HALF_R, _BOX_H, _DOME_R, _DOME_H = range(7)


def lap_features(radius: float, p: Dict) -> np.ndarray:
    """[sectors, 7] float64 features of the lap, drawn from p["set_seed"]: in
    each sector a wall, a boulder, a trench or nothing, at a radial offset
    from the path of at least `clearance` metres, and inside its sector."""
    rng = np.random.default_rng(int(p["set_seed"]))
    k = int(p["sectors"])
    out = np.zeros((k, 7))
    dth = 2 * math.pi / k
    kinds = ("wall", "boulder", "trench", "none")
    probs = [p["kinds"][n] for n in kinds]
    for i in range(k):
        kind = kinds[rng.choice(4, p=probs)]
        side = 1.0 if rng.random() < 0.5 else -1.0
        out[i, _THETA] = (i + 0.5) * dth
        if kind == "none":
            out[i, _RADIUS] = radius
            continue
        lo, hi = p["offset_m"]
        if kind == "boulder":
            r_d = rng.uniform(*p["boulder_radius_m"])
            out[i, _RADIUS] = radius + side * (p["clearance_m"] + r_d + rng.uniform(0.0, hi - lo))
            out[i, _DOME_R] = min(r_d, 0.8 * 0.5 * dth * (out[i, _RADIUS] - r_d))
            out[i, _DOME_H] = rng.uniform(*p["boulder_height_m"])
            continue
        half_r = 0.5 * rng.uniform(*p[f"{kind}_length_m"])
        out[i, _RADIUS] = radius + side * (p["clearance_m"] + half_r + rng.uniform(0.0, hi - lo))
        half_t = 0.5 * rng.uniform(*p[f"{kind}_width_m"])
        out[i, _HALF_T] = min(half_t, 0.8 * 0.5 * dth * (out[i, _RADIUS] - half_r))
        out[i, _HALF_R] = half_r
        out[i, _BOX_H] = rng.uniform(*p["wall_height_m"]) if kind == "wall" else -rng.uniform(*p["trench_depth_m"])
    return out


def lap_terrain(features: torch.Tensor) -> Terrain:
    """The rolling ground plus each sample's own sector's feature."""
    k = features.shape[0]
    dth = 2 * math.pi / k

    def height(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        f = features.to(x.dtype)
        rho = torch.sqrt(x * x + y * y)
        th = torch.remainder(torch.atan2(y, x), 2 * math.pi)
        sec = torch.clamp((th / dth).long(), max=k - 1)
        g = f[sec]                                           # [..., 7]
        a = (th - g[..., _THETA]) * rho                      # along the lap, metres
        dr = rho - g[..., _RADIUS]
        box = (a.abs() < g[..., _HALF_T]) & (dr.abs() < g[..., _HALF_R])
        h = rolling_ground(x, y) + torch.where(box, g[..., _BOX_H], torch.zeros_like(x))
        r2 = g[..., _DOME_R] ** 2
        q = (a * a + dr * dr) / torch.where(r2 > 0, r2, torch.ones_like(r2))
        dome = (r2 > 0) & (q < 1.0)
        return h + torch.where(dome, g[..., _DOME_H] * torch.sqrt(torch.clamp(1.0 - q, min=0.0)), torch.zeros_like(x))

    return height


def lap_ceiling(features: np.ndarray) -> Ceiling:
    """The plane that lap_terrain(features) never rises above: the ramp,
    its bumps and the tallest wall or boulder."""
    return RAMP, 0.0, BUMP_M + max(0.0, float(features[:, _BOX_H].max())) + max(0.0, float(features[:, _DOME_H].max()))


def _directions(channels: int, azimuth_steps: int, vfov_deg: Tuple[float, float], dtype, device) -> torch.Tensor:
    """[A·C, 3] unit ray directions in io/synthetic's order (azimuth-major)."""
    az = torch.from_numpy(np.linspace(0, 2 * np.pi, azimuth_steps, endpoint=False)).to(device, dtype)
    el = torch.from_numpy(np.deg2rad(np.linspace(vfov_deg[0], vfov_deg[1], channels))).to(device, dtype)
    azg, elg = torch.meshgrid(az, el, indexing="ij")
    return torch.stack([torch.cos(elg) * torch.cos(azg), torch.cos(elg) * torch.sin(azg), torch.sin(elg)],
                       dim=-1).reshape(-1, 3)


def _rise_limit(sp: torch.Tensor, d: torch.Tensor, ceiling: Optional[Ceiling]) -> torch.Tensor:
    """[R] the range past which ray (sp, d) stays above the ceiling (by its
    margin), so that no later sample of it can be below the terrain; inf
    where it never does."""
    if ceiling is None:
        return torch.full(d.shape[:1], float("inf"), dtype=d.dtype, device=d.device)
    a, b, c = ceiling
    head = (c + CEILING_MARGIN_M) + a * sp[:, 0] + b * sp[:, 1] - sp[:, 2]   # the ceiling over the sensor
    rise = d[:, 2] - a * d[:, 0] - b * d[:, 1]                                # the ray's climb over it a metre
    return torch.where(rise > 0, head / torch.where(rise > 0, rise, torch.ones_like(rise)), float("inf"))


def _first_below(terrain: Terrain, sp: torch.Tensor, d: torch.Tensor, ts: torch.Tensor, chunk: int,
                 t_max: torch.Tensor) -> torch.Tensor:
    """[R] the first coarse sample t at which ray (sp, d) is below the
    terrain, NaN where none is. Rays that found theirs, and rays past their
    t_max, leave the march."""
    R = d.shape[0]
    t_hit = torch.full((R,), float("nan"), dtype=d.dtype, device=d.device)
    live = torch.arange(R, device=d.device)
    live = live[t_max >= ts[0]]
    for c0 in range(0, ts.shape[0], chunk):
        if live.numel() == 0:
            break
        tt = ts[c0:c0 + chunk]
        s, dd = sp[live], d[live]
        p = s[:, None, :] + tt[None, :, None] * dd[:, None, :]
        below = p[..., 2] < terrain(p[..., 0], p[..., 1])
        found = below.any(dim=1)
        first = torch.argmax(below.to(torch.uint8), dim=1)
        t_hit[live[found]] = tt[first[found]]
        live = live[~found]
        if c0 + chunk < ts.shape[0]:
            live = live[t_max[live] >= ts[c0 + chunk]]
    return t_hit


def simulate_scans(terrain: Terrain, sensors: torch.Tensor, channels: int, azimuth_steps: int,
                   vfov_deg=(-22.5, 22.5), max_range: float = 80.0, min_range: float = 0.5,
                   noise_std: float = 0.0, generator=None,
                   ceiling: Optional[Ceiling] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scans from each sensor position [S, 3]: (points [S, A·C, 3], hit
    [S, A·C] bool) in the dtype and on the device of `sensors`, rays in
    io/synthetic.simulate_lidar_scan's order. A point is sensor + t·d with t
    the bisected range, plus Gaussian range noise. `ceiling`, where given,
    only saves work: the scans are the same without it."""
    dtype, dev = sensors.dtype, sensors.device
    d1 = _directions(channels, azimuth_steps, vfov_deg, dtype, dev)
    S, R1 = sensors.shape[0], d1.shape[0]
    d = d1.repeat(S, 1)
    sp = sensors.repeat_interleave(R1, dim=0)
    ts = torch.from_numpy(np.arange(min_range, max_range, COARSE_STEP_M)).to(dev, dtype)
    t_hit = _first_below(terrain, sp, d, ts, MARCH_CHUNK, _rise_limit(sp, d, ceiling))
    hit = ~torch.isnan(t_hit)
    lo = torch.clamp(t_hit[hit] - COARSE_STEP_M, min=min_range)
    hi = t_hit[hit]
    dh, sh = d[hit], sp[hit]
    for _ in range(REFINE_ITERS):
        mid = 0.5 * (lo + hi)
        p = sh + mid[:, None] * dh
        below = p[:, 2] < terrain(p[:, 0], p[:, 1])
        hi = torch.where(below, mid, hi)
        lo = torch.where(below, lo, mid)
    if noise_std > 0:
        hi = hi + noise_std * torch.randn(hi.shape, generator=generator, dtype=dtype, device=dev)
    pts = torch.zeros((S * R1, 3), dtype=dtype, device=dev)
    pts[hit] = sh + hi[:, None] * dh
    return pts.view(S, R1, 3), hit.view(S, R1)


def make_lap(sensor: Dict, lap: Dict, lidar_height: float, seed: int, device) -> Dict:
    """The lap of `lap["scans"]` scans (a drive file, benchmark/drives/),
    made on `device` from the seed:
    points [L, N, 3] float32 with each scan's returns first and zeros
    after, valid [L, N], egos [L, 3] float32, counts [L], and the lap's
    radius and features. N = channels · azimuth steps."""
    L = int(lap["scans"])
    spacing = float(lap["speed_m_s"]) / float(sensor["rate_hz"])
    radius = L * spacing / (2 * math.pi)
    feats = lap_features(radius, lap["features"])
    terrain = lap_terrain(torch.from_numpy(feats).to(device))
    phi = torch.arange(L, dtype=torch.float64, device=device) * (2 * math.pi / L)
    ex, ey = radius * torch.cos(phi), radius * torch.sin(phi)
    egos = torch.stack([ex, ey, terrain(ex, ey) + lidar_height], dim=1).float()
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    n_rays = int(sensor["channels"]) * int(sensor["azimuth_steps"])
    points = torch.empty((L, n_rays, 3), dtype=torch.float32, device=device)
    valid = torch.empty((L, n_rays), dtype=torch.bool, device=device)
    per = SCANS_PER_CALL
    for s0 in range(0, L, per):
        pts, hit = simulate_scans(terrain, egos[s0:s0 + per], int(sensor["channels"]),
                                  int(sensor["azimuth_steps"]), tuple(sensor["vertical_fov_deg"]),
                                  float(sensor["max_range_m"]), float(sensor["min_range_m"]),
                                  float(sensor["range_noise_m"]), gen, lap_ceiling(feats))
        order = torch.sort((~hit).to(torch.uint8), dim=1, stable=True).indices
        points[s0:s0 + per] = torch.gather(pts, 1, order[..., None].expand(-1, -1, 3))
        valid[s0:s0 + per] = torch.gather(hit, 1, order)
    points.mul_(valid[..., None])
    return dict(points=points, valid=valid, egos=egos, counts=valid.sum(dim=1), radius=radius, features=feats)
