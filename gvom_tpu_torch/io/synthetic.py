"""Synthetic lidar scans over analytic terrain.

The port's own copy of gvom_tpu/io/synthetic.py (numpy only). The upstream
G-VOM project was validated only empirically on physical vehicles (its
README) and ships no data or tests. This module is the data source for the
test and benchmark strategy: OS1-64/OS1-128-density
scans (spinning lidar: rings × azimuth steps) ray-cast against analytic height
fields with known ground-truth properties (a ramp has a known slope, a trench
is a known negative obstacle, a wall a known positive obstacle, an occlusion a
known visibility hole).

Everything is NumPy on the host — scan generation is input production, not
part of the engine.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np

__all__ = [
    "Terrain",
    "flat_terrain",
    "ramp_terrain",
    "trench_terrain",
    "wall_terrain",
    "bumpy_terrain",
    "composite_terrain",
    "simulate_lidar_scan",
    "pad_scan",
    "nudge_off_grid",
    "STENCIL_PATTERNS",
    "stencil_maps",
    "edge_points",
]


@dataclasses.dataclass
class Terrain:
    """An analytic surface z = height(x, y) (vectorized over numpy arrays)."""

    height: Callable[[np.ndarray, np.ndarray], np.ndarray]
    name: str = "terrain"


def flat_terrain(z: float = 0.0) -> Terrain:
    return Terrain(lambda x, y: np.full_like(np.asarray(x, float), z), "flat")


def ramp_terrain(slope_x: float = 0.2, slope_y: float = 0.0, z0: float = 0.0) -> Terrain:
    return Terrain(lambda x, y: z0 + slope_x * x + slope_y * y, "ramp")


def trench_terrain(x_center: float = 8.0, width: float = 2.0, depth: float = 2.0) -> Terrain:
    def h(x, y):
        x = np.asarray(x, float)
        inside = np.abs(x - x_center) < width / 2
        return np.where(inside, -depth, 0.0)

    return Terrain(h, "trench")


def wall_terrain(x_wall: float = 10.0, height: float = 3.0, thickness: float = 0.8) -> Terrain:
    def h(x, y):
        x = np.asarray(x, float)
        inside = np.abs(x - x_wall) < thickness / 2
        return np.where(inside, height, 0.0)

    return Terrain(h, "wall")


def bumpy_terrain(amplitude: float = 0.3, wavelength: float = 4.0) -> Terrain:
    k = 2 * np.pi / wavelength

    def h(x, y):
        return amplitude * (np.sin(k * np.asarray(x, float)) + np.cos(k * np.asarray(y, float) * 0.7))

    return Terrain(h, "bumpy")


def composite_terrain() -> Terrain:
    """A RELLIS-flavored scene: gentle ramp + bumps + a wall + a trench."""

    def h(x, y):
        x = np.asarray(x, float)
        y = np.asarray(y, float)
        base = 0.05 * x + 0.15 * np.sin(0.5 * x) * np.cos(0.4 * y)
        base = np.where(np.abs(x - 14.0) < 0.6, base + 3.0, base)     # wall
        base = np.where(np.abs(y - 10.0) < 1.2, base - 2.0, base)     # trench
        return base

    return Terrain(h, "composite")


def simulate_lidar_scan(
    terrain: Terrain,
    sensor_position,
    channels: int = 64,
    azimuth_steps: int = 1024,
    vertical_fov_deg: Tuple[float, float] = (-22.5, 22.5),
    max_range: float = 80.0,
    min_range: float = 0.5,
    noise_std: float = 0.0,
    seed: int = 0,
    coarse_step: float = 0.25,
    refine_iters: int = 24,
) -> np.ndarray:
    """Ray-cast a spinning-lidar pattern against the terrain.

    Returns [N,3] float64 points in the world frame (sensor-frame output is
    just `points - sensor_position`); rays with no terrain return are dropped,
    like a real lidar's no-return. OS1-64 ≈ (64, 1024); OS1-128 ≈ (128, 2048)
    (the upstream project's sensor suite, its README).
    """
    sp = np.asarray(sensor_position, dtype=np.float64)
    rng = np.random.default_rng(seed)
    az = np.linspace(0, 2 * np.pi, azimuth_steps, endpoint=False)
    el = np.deg2rad(np.linspace(vertical_fov_deg[0], vertical_fov_deg[1], channels))
    azg, elg = np.meshgrid(az, el, indexing="ij")
    d = np.stack(
        [np.cos(elg) * np.cos(azg), np.cos(elg) * np.sin(azg), np.sin(elg)], axis=-1
    ).reshape(-1, 3)

    # coarse march: first sample below the surface
    ts = np.arange(min_range, max_range, coarse_step)
    below_prev = np.zeros(len(d), bool)
    t_hit = np.full(len(d), np.nan)
    t_prev = np.full(len(d), min_range)
    for t in ts:
        p = sp[None, :] + t * d
        below = p[:, 2] < terrain.height(p[:, 0], p[:, 1])
        newly = below & ~below_prev & np.isnan(t_hit)
        t_hit[newly] = t
        t_prev = np.where(np.isnan(t_hit), t, t_prev)
        below_prev = below
    hit = ~np.isnan(t_hit)
    if not hit.any():
        return np.zeros((0, 3))

    # bisection refine between t_hit - coarse_step and t_hit
    lo = np.maximum(t_hit[hit] - coarse_step, min_range)
    hi = t_hit[hit]
    dh = d[hit]
    for _ in range(refine_iters):
        mid = 0.5 * (lo + hi)
        p = sp[None, :] + mid[:, None] * dh
        below = p[:, 2] < terrain.height(p[:, 0], p[:, 1])
        hi = np.where(below, mid, hi)
        lo = np.where(below, lo, mid)
    pts = sp[None, :] + hi[:, None] * dh
    if noise_std > 0:
        pts = pts + rng.normal(scale=noise_std, size=pts.shape)
    return pts


def pad_scan(points: np.ndarray, max_points: int) -> Tuple[np.ndarray, np.ndarray]:
    """Pad/truncate to the engine's static point capacity; returns
    (points [max,3] f32, valid mask [max] bool)."""
    n = min(len(points), max_points)
    out = np.zeros((max_points, 3), np.float32)
    mask = np.zeros((max_points,), bool)
    out[:n] = points[:n]
    mask[:n] = True
    return out, mask


def nudge_off_grid(points: np.ndarray, xy_resolution: float, z_resolution: float, eps: float = 1e-3) -> np.ndarray:
    """Shift coordinates that sit within eps·res of a voxel boundary.

    f32 (engine) and f64 (oracle) floor() can disagree for points straddling a
    boundary at the last bit; test fixtures nudge such points so parity tests
    compare algorithms, not float rounding.
    """
    out = np.array(points, dtype=np.float64)
    for axis, res in ((0, xy_resolution), (1, xy_resolution), (2, z_resolution)):
        frac = out[:, axis] / res
        rem = frac - np.round(frac)
        close = np.abs(rem) < eps
        out[close, axis] += np.where(rem[close] >= 0, eps, -eps) * res * 2
    return out


UNKNOWN_HEIGHT = -1000.0   # types.UNKNOWN_HEIGHT, the 2-D maps' "no height"

STENCIL_PATTERNS = ("all_known", "all_unknown", "checkerboard", "border_only", "collinear_triples",
                    "count_three", "near_1e4", "sparse", "terrain_holes")


def stencil_maps(pattern: str, X: int, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """(height map, inferred-height map), each [X, X] float32 in the window
    layout, for holding the 2-D maps' stencils (the plane fit and the
    guess-height search) against each other on the cases that their edges
    live in. Unknown cells hold UNKNOWN_HEIGHT. The patterns:

    all_known / all_unknown; checkerboard (known where x + y is even);
    border_only (known on the map's outer ring); collinear_triples (three
    known cells in a row, a column or a diagonal, isolated, so that a 3×3
    window sees a count of 3 and det = 0); count_three (three known cells in
    an L, a count of exactly 3 with det != 0); near_1e4 (heights 1e4 plus
    centimetres on half the map, for cancellation, and −1e4 on the other
    half, which lies below UNKNOWN_HEIGHT and so is unknown); sparse (2 % known, for
    long guess searches); terrain_holes (a smooth surface with 30 % holes).
    The inferred heights are known on 80 % of the cells; the search's output
    is positive where one lies above the heights found."""
    rng = np.random.default_rng([seed, STENCIL_PATTERNS.index(pattern)])
    x, y = np.meshgrid(np.arange(X), np.arange(X), indexing="ij")
    heights = rng.normal(0.0, 2.0, (X, X))
    known = np.zeros((X, X), bool)
    if pattern == "all_known":
        known[:] = True
    elif pattern == "checkerboard":
        known = (x + y) % 2 == 0
    elif pattern == "border_only":
        known = (x == 0) | (y == 0) | (x == X - 1) | (y == X - 1)
    elif pattern in ("collinear_triples", "count_three"):
        shapes = ([((0, 0), (0, 1), (0, 2)), ((0, 0), (1, 0), (2, 0)), ((0, 0), (1, 1), (2, 2))]
                  if pattern == "collinear_triples" else [((0, 0), (0, 1), (1, 0)), ((0, 0), (1, 1), (0, 2))])
        for i, cx in enumerate(range(1, X - 3, 6)):
            for j, cy in enumerate(range(1, X - 3, 6)):
                for dx, dy in shapes[(i + j) % len(shapes)]:
                    known[cx + dx, cy + dy] = True
    elif pattern == "near_1e4":
        known[:] = True
        heights = np.where(x < X // 2, 1e4, -1e4) + rng.normal(0.0, 0.05, (X, X))
    elif pattern == "sparse":
        known = rng.random((X, X)) < 0.02
    elif pattern == "terrain_holes":
        heights = 0.3 * np.sin(0.2 * x) + 0.05 * y + rng.normal(0.0, 0.02, (X, X))
        known = rng.random((X, X)) >= 0.3
    elif pattern != "all_unknown":
        raise ValueError(f"unknown stencil pattern {pattern!r}")
    hm = np.where(known, heights, UNKNOWN_HEIGHT).astype(np.float32)
    inferred = rng.random((X, X)) < 0.8
    ihm = np.where(inferred, rng.normal(0.5, 2.0, (X, X)), UNKNOWN_HEIGHT).astype(np.float32)
    return hm, ihm


def edge_points(resolution, grid_shape, origin, min_distance: float) -> np.ndarray:
    """[K, 3] float32 world points on the edges of the point preparation, for
    a window of `grid_shape` voxels of `resolution` (x, y, z) metres at the
    voxel `origin`: on voxel faces (the window's first and last faces and
    one past them, in float32 world coordinates), at and one float32 step
    either side of `min_distance` from the world origin, and at ±1e9, ±inf
    and NaN in one coordinate with the others inside the window."""
    res = np.asarray(resolution, np.float32)
    origin = np.asarray(origin, np.int64)
    size = np.asarray(grid_shape, np.int64)
    inside = ((origin + size // 2) * res).astype(np.float32)
    out = []
    for k in (-1, 0, 1, 5):
        for face in (np.float32(origin + k) * res, np.float32(origin + size - k) * res):
            for a in range(3):
                q = inside.copy()
                q[a] = face[a]
                out.append(q)
    md = np.float32(min_distance)
    for d in (md, np.nextafter(md, np.float32(0)), np.nextafter(md, np.float32(np.inf))):
        out += [np.array([d, 0, 0], np.float32), np.array([0, 0, -d], np.float32)]
    for v in (1e9, -1e9, np.inf, -np.inf, np.nan):
        for a in range(3):
            q = inside.copy()
            q[a] = v
            out.append(q)
    return np.stack(out).astype(np.float32)
