"""The JAX package's semantic tests on analytic terrain (tests/test_semantics.py),
through the port on the CPU: a wall is a positive obstacle, a trench a
negative one, a ramp has its slope and a wall's shadow is a visibility hole.
Each case drives the port's Gvom facade and the JAX facade with the same
scans, asserts the ground truth on the port's maps and holds every map
bitwise against the JAX facade's. Then non-finite points and a zero-length
ray through the port's ingest_scan."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gvom_tpu_torch
from gvom_tpu.config import GvomConfig
from gvom_tpu.io import synthetic
from gvom_tpu.models import pipeline as jpipeline

from gvom_tpu_torch.models import pipeline as tpipeline

from conftest import make_scan
from torch_helpers import assert_state_equal, convert, jax_facade, jax_numpy, t, tcfg

# tests/test_semantics.py's make_engine()
CFG = GvomConfig(xy_resolution=0.4, z_resolution=0.4, xy_size=64, z_size=32, buffer_size=2, min_distance=1.0,
                 positive_obstacle_threshold=0.5, negative_obstacle_threshold=0.5, slope_obstacle_threshold=0.3,
                 robot_height=2.0, robot_radius=1.2, ground_to_lidar_height=1.5, xy_eigen_dist=1, z_eigen_dist=1,
                 max_points=32768)
WALL_EGOS = [np.array([0.1, 0.05, 1.5]), np.array([0.4, 0.15, 1.5])]


def world_to_cell(cfg, origin, x, y):
    """World metres → window-relative 2-D map cell (origin in metres)."""
    res = cfg.xy_resolution
    return int(np.floor((x - origin[0]) / res)), int(np.floor((y - origin[1]) / res))


def drive(terrain, egos, channels=48, n_az=128, max_range=24.0):
    """The same scans through both facades; every map of every combine
    bitwise. Returns the port's facade and its last 5-tuple."""
    jg, tg = jax_facade(CFG), gvom_tpu_torch.Gvom(config=tcfg(CFG), device="cpu")
    out = None
    for i, ego in enumerate(egos):
        pts = make_scan(terrain, ego, n_az=n_az, channels=channels, seed=i, cfg=CFG, max_range=max_range)
        jg.process_pointcloud(pts, ego)
        tg.process_pointcloud(pts, ego)
        ref, out = jg.combine_maps(), tg.combine_maps()
        for name, a, b in zip(("origin", "positive", "negative", "roughness", "visibility"), out, ref):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"scan {i}: {name}")
        for name in ("height", "slope_x", "slope_y", "guessed_height_delta"):
            np.testing.assert_array_equal(getattr(tg.products, name).numpy(), np.asarray(getattr(jg.products, name)),
                                          err_msg=f"scan {i}: {name}")
    return tg, out


def test_wall_is_positive_obstacle():
    terrain = synthetic.wall_terrain(x_wall=6.0, height=3.0, thickness=0.8)
    # dense scan: the density path counts only voxels with more than
    # hit_count_threshold hits, so the wall face needs lidar-like density
    _, (origin, pos, neg, rough, vis) = drive(terrain, WALL_EGOS, channels=96, n_az=256)
    cx, cy = world_to_cell(CFG, origin, 6.0, 0.0)
    band = pos[cx - 1:cx + 2, cy - 6:cy + 7]
    assert band.max() > 50, f"wall not flagged: band max {band.max()}"
    # observed open ground short of the wall is not an obstacle
    ox, oy = world_to_cell(CFG, origin, 4.5, 0.0)
    assert pos[ox, oy] == 0


def test_trench_is_negative_obstacle():
    terrain = synthetic.trench_terrain(x_center=7.0, width=4.0, depth=3.0)
    egos = [np.array([0.1, 0.05, 1.5]), np.array([0.45, 0.2, 1.5])]
    _, (origin, pos, neg, rough, vis) = drive(terrain, egos)
    lo, _ = world_to_cell(CFG, origin, 5.0, 0.0)
    hi, _ = world_to_cell(CFG, origin, 9.0, 0.0)
    _, cy = world_to_cell(CFG, origin, 0.0, 0.0)
    band = neg[lo:hi + 1, cy - 8:cy + 9]
    assert band.max() == 100, f"trench not flagged: band max {band.max()}"
    ox, oy = world_to_cell(CFG, origin, 2.5, 0.0)
    assert neg[ox, oy] == 0


def test_ramp_slope_angle():
    grade = 0.3   # rise over run: |slope| = atan(0.3)
    terrain = synthetic.ramp_terrain(slope_x=grade)
    g, _ = drive(terrain, [np.array([0.1, 0.05, 1.6]), np.array([0.5, 0.2, 1.7])], channels=64)
    pr = g.products
    slope = np.hypot(pr.slope_x.numpy(), pr.slope_y.numpy())
    known = (pr.visibility.numpy() > 0) & (pr.height.numpy() > -999)
    interior = known & np.roll(known, 1, 0) & np.roll(known, -1, 0) & np.roll(known, 1, 1) & np.roll(known, -1, 1)
    vals = slope[interior]
    assert len(vals) > 50
    med = float(np.median(vals))
    assert abs(med - np.arctan(grade)) < 0.05, f"median slope {med} vs {np.arctan(grade)}"


def test_wall_shadow_visibility_hole():
    terrain = synthetic.wall_terrain(x_wall=6.0, height=3.0, thickness=0.8)
    _, (origin, pos, neg, rough, vis) = drive(terrain, WALL_EGOS)
    _, cy = world_to_cell(CFG, origin, 0.0, 0.0)
    ax, _ = world_to_cell(CFG, origin, 4.5, 0.0)
    assert vis[ax, cy] == 1                      # ground ahead of the wall is seen
    sx, _ = world_to_cell(CFG, origin, 9.0, 0.0)
    shadow = vis[sx:sx + 4, cy - 2:cy + 3]
    assert shadow.max() == 0, f"shadow unexpectedly visible: {shadow}"


def test_nonfinite_points_are_dropped(small_cfg):
    """NaN and ±inf points are dropped by the world-frame distance filter and
    leave the grid as it is without them; a point at the ego (a zero-length
    ray) is kept, bins as a hit and casts no pass. The grid is bitwise the
    JAX package's."""
    cfg = small_cfg
    c = tcfg(cfg)
    ego = np.array([0.3, -0.2, 1.5], np.float32)
    good = ego + np.array([[3.0, 0.5, -1.0], [2.0, -1.5, -0.8]], np.float32)
    bad = np.array([[np.nan, 1.0, 1.0], [np.inf, 2.0, 0.0], [-np.inf, np.nan, np.inf], ego], np.float32)
    pad, mask = synthetic.pad_scan(np.concatenate([good, bad], axis=0), cfg.max_points)
    grid, ok = tpipeline.ingest_scan(c, t(pad), t(mask), t(ego))
    hit, miss = grid.hit.numpy(), grid.miss.numpy()
    assert bool(ok)
    assert np.isfinite(grid.min_height.numpy()).all() and np.isfinite(grid.mom.numpy()).all()
    assert hit.sum() == 3
    assert (hit >= 0).all() and (miss >= 0).all()

    kp, km = synthetic.pad_scan(np.concatenate([good, ego[None, :]], axis=0), cfg.max_points)
    ref, _ = tpipeline.ingest_scan(c, t(kp), t(km), t(ego))
    np.testing.assert_array_equal(hit, ref.hit.numpy())    # the non-finite points change nothing
    np.testing.assert_array_equal(miss, ref.miss.numpy())

    jgrid, jok = jax.jit(lambda p, v, e: jpipeline.ingest_scan(cfg, p, v, e))(
        jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(ego))
    assert bool(jok)
    assert_state_equal(convert.to_numpy(grid), convert.logical_from_jax_numpy(jax_numpy(jgrid)), "non-finite scan")


@pytest.mark.parametrize("where", ["ego", "origin"])
def test_zero_length_ray_casts_no_pass(small_cfg, where):
    """A scan of one point exactly at the ego: one hit, no pass anywhere, and
    JAX's grid bitwise; at the world origin (inside min_distance of the
    world-frame filter) the point is dropped and the scan is degenerate."""
    cfg = small_cfg
    c = tcfg(cfg)
    ego = np.array([0.3, -0.2, 1.5], np.float32)
    p = ego if where == "ego" else np.zeros(3, np.float32)
    pad, mask = synthetic.pad_scan(p[None, :], cfg.max_points)
    grid, ok = tpipeline.ingest_scan(c, t(pad), t(mask), t(ego))
    assert int(grid.miss.sum()) == 0
    assert int(grid.hit.sum()) == (1 if where == "ego" else 0) and bool(ok) == (where == "ego")
    jgrid, jok = jax.jit(lambda p, v, e: jpipeline.ingest_scan(cfg, p, v, e))(
        jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(ego))
    assert bool(jok) == bool(ok)
    assert_state_equal(convert.to_numpy(grid), convert.logical_from_jax_numpy(jax_numpy(jgrid)), where)
