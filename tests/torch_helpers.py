"""Shared utilities of the tests that hold gvom_tpu_torch against gvom_tpu.

Inputs are made with numpy and handed to both packages; JAX state is turned
into numpy arrays and read through gvom_tpu_torch.utils.convert."""

import functools

import jax
import numpy as np
import torch

from gvom_tpu.config import GvomConfig
from gvom_tpu.io import synthetic
from gvom_tpu.models import pipeline as jpipeline

from gvom_tpu_torch import config as tconfig
from gvom_tpu_torch.utils import convert

from conftest import make_scan

# The suite runs in several processes that share the machine's cores
# (pytest-xdist); one intra-op thread per process keeps the port's tests
# from slowing the JAX tests running beside them.
torch.set_num_threads(1)

# The nine moment channels other than n are f32 sums taken in another order
# than the JAX package's separable box (the box adds the 27 neighbours one
# axis at a time, and the kernels add with atomics in any order), so they
# agree to rounding only. n sums integers and is exact.
MOM_RTOL = 1e-5
MOM_ATOL = 2e-3

# MapProducts: every field bitwise, slope_x, slope_y and roughness too: the
# port's log and atan2 (gvom_tpu_torch.ops.grid.log32 / atan2_32) are XLA's
# compiled log and glibc's atan2f, rounding for rounding. No field is held
# within a tolerance (PRODUCTS_CLOSE is empty).
PRODUCTS_BITWISE = ("origin", "height", "inferred_height", "slope_x", "slope_y", "roughness",
                    "guessed_height_delta", "positive_obstacle", "negative_obstacle", "visibility")
PRODUCTS_CLOSE = ()

EGOS = [
    np.array([0.3, -0.2, 1.5]),
    np.array([1.1, 0.4, 1.55]),
    np.array([2.2, 1.0, 1.6]),
    np.array([3.5, 1.8, 1.62]),
    np.array([4.9, 2.9, 1.7]),
]


def tcfg(cfg: GvomConfig) -> tconfig.GvomConfig:
    return tconfig.GvomConfig.from_dict(cfg.to_dict())


def t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))   # a writable copy


def jax_numpy(state):
    return jax.tree_util.tree_map(np.asarray, state)


def scan(cfg, i, ego, kind="normal"):
    """(padded points, mask) of the i-th scan of a drive; kind 'empty' masks
    every point out, 'near' puts every point inside min_distance of the
    world origin (dropped by the world-frame min-distance filter)."""
    pts = make_scan(synthetic.composite_terrain(), ego, seed=i, cfg=cfg)
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    if kind == "empty":
        mask = np.zeros_like(mask)
    elif kind == "near":
        rng = np.random.default_rng(100 + i)
        pad = np.zeros_like(pad)
        pad[:512] = rng.uniform(-0.5, 0.5, (512, 3)).astype(np.float32)
        mask = np.zeros_like(mask)
        mask[:512] = True
    return pad, mask


@functools.lru_cache(maxsize=None)
def jax_ingest(cfg):
    return jax.jit(lambda b, p, v, e: jpipeline.ingest_and_insert(cfg, b, p, v, e))


@functools.lru_cache(maxsize=None)
def jax_combine(cfg):
    return jax.jit(lambda b, w, e: jpipeline.combine(cfg, b, w, e, impl="xla"))


def assert_state_equal(port: dict, ref: dict, what: str):
    """Every channel bitwise except the nine non-n moments (tolerance)."""
    for k, v in ref.items():
        if k == "mom":
            np.testing.assert_array_equal(port[k][..., 0, :, :, :], v[..., 0, :, :, :], err_msg=f"{what}: mom n")
            np.testing.assert_allclose(port[k], v, rtol=MOM_RTOL, atol=MOM_ATOL, err_msg=f"{what}: mom")
        else:
            np.testing.assert_array_equal(port[k], v, err_msg=f"{what}: {k}")



def products_numpy(p) -> dict:
    """The fields of a MapProducts of either package as numpy arrays."""
    return {k: np.asarray(getattr(p, k)) for k in PRODUCTS_BITWISE + tuple(k for k, _ in PRODUCTS_CLOSE)}


def assert_products_equal(port: dict, ref: dict, what: str = "products"):
    for k in PRODUCTS_BITWISE:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=f"{what}: {k}")
    for k, atol in PRODUCTS_CLOSE:
        np.testing.assert_allclose(port[k], ref[k], rtol=0, atol=atol, err_msg=f"{what}: {k}")


def combine_drive(cfg: GvomConfig):
    """A drive of 3 scans at cfg with a moving ego, each ingested by both
    packages: after each, the port's combine against gvom_tpu's
    combine(impl="xla") (the world as assert_state_equal holds it, the
    products bitwise) and fuse_plain's world channels bitwise the
    combine's. Returns the JAX world's last state (logical numpy) and the
    port's last MapProducts."""
    import jax.numpy as jnp

    from gvom_tpu.types import empty_buffer_state as jempty_buffer
    from gvom_tpu.types import empty_world_state as jempty_world
    from gvom_tpu_torch.models import pipeline as tpipeline
    from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

    c = tcfg(cfg)
    what = f"B={cfg.buffer_size}, {cfg.xy_size}x{cfg.xy_size}x{cfg.z_size}"
    ingest, combine = jax_ingest(cfg), jax_combine(cfg)
    jbuf, jworld = jempty_buffer(cfg), jempty_world(cfg)
    tbuf, tworld = empty_buffer_state(c, "cpu"), empty_world_state(c, "cpu")
    for i in range(3):
        ego = np.array([0.3, -0.2, 1.5]) + i * np.array([0.9, 0.6, 0.02])
        pad, mask = scan(cfg, i, ego)
        e = np.float32(ego)
        jbuf, _ = ingest(jbuf, jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(e))
        jworld, jprod, _ = combine(jbuf, jworld, jnp.asarray(e))
        tpipeline.ingest_and_insert(c, tbuf, t(pad), t(mask), t(e))
        target = tbuf.grids.origin[int(tbuf.last_slot)]
        fused = tpipeline.fuse_plain(c, tbuf, tworld, target, t(e))
        tworld, tprod, _ = tpipeline.combine(c, tbuf, tworld, t(e))
        ref = convert.logical_from_jax_numpy(jax_numpy(jworld))
        assert_state_equal(convert.to_numpy(tworld), ref, f"{what}, world after scan {i}")
        for name, a in zip(("hit", "miss", "min_height", "evidence", "mom"), fused[:5]):
            np.testing.assert_array_equal(a.numpy(), convert.to_numpy(tworld)[name], err_msg=name)
        assert_products_equal(products_numpy(tprod), products_numpy(jprod), f"{what}, scan {i}")
    assert (ref["hit"] > 0).sum() > 50
    return ref, tprod


@functools.lru_cache(maxsize=None)
def _jax_facade_compiled(cfg):
    import gvom_tpu

    return gvom_tpu.Gvom(config=cfg)


def jax_facade(cfg):
    """A fresh gvom_tpu.Gvom for cfg that shares the jitted ingest and combine
    of the first one made for cfg in this process: a facade compiles its own
    otherwise, which takes seconds each time."""
    import gvom_tpu

    g, done = gvom_tpu.Gvom(config=cfg), _jax_facade_compiled(cfg)
    g._ingest_tf, g._ingest_no_tf, g._combine = done._ingest_tf, done._ingest_no_tf, done._combine
    return g


# ----------------------------------------------------------------------
# The configuration sweep: F1-F3 are the JAX package's fuzz configurations
# (tests/test_fuzz_parity.py, CASES), F4 moves every threshold, the guess
# radius and the distance filter off their defaults. Each is (seed of its
# drive, the fields that differ from GvomConfig()). chip_smoke.py holds the
# same table (SWEEP_CONFIGS) for the card, with F5, the upstream grid at F4's
# thresholds.
SWEEP = {
    "F1": (11, dict(xy_size=40, z_size=24, xy_resolution=0.35, z_resolution=0.25, buffer_size=3,
                    xy_eigen_dist=1, z_eigen_dist=0)),
    "F2": (23, dict(xy_size=48, z_size=16, xy_resolution=0.5, z_resolution=0.5, buffer_size=2,
                    xy_eigen_dist=2, z_eigen_dist=1, decay_miss_limit=4)),
    "F3": (37, dict(xy_size=32, z_size=32, xy_resolution=0.4, z_resolution=0.2, buffer_size=5,
                    xy_eigen_dist=0, z_eigen_dist=0, robot_radius=0.8)),
    "F4": (5, dict(xy_size=48, z_size=24, xy_resolution=0.3, z_resolution=0.15, buffer_size=4,
                   xy_eigen_dist=2, z_eigen_dist=2, hit_count_threshold=3, decay_miss_limit=2, robot_height=1.2,
                   robot_radius=2.5, ground_to_lidar_height=1.7, positive_obstacle_threshold=0.3,
                   negative_obstacle_threshold=0.8, slope_obstacle_threshold=0.15, density_threshold=7,
                   guess_search_radius=6, min_distance=2.5, ego_relative_min_distance=True)),
}
SWEEP_MAX_POINTS = 16384     # the facade drive's point capacity (the JAX fuzz suite's)
SWEEP_BATCH_MAX_POINTS = 4096
SWEEP_SCANS = 4              # scans of the facade drive
SWEEP_STEPS, SWEEP_BATCH = 2, 8


def sweep_cfg(name: str, max_points: int = SWEEP_MAX_POINTS) -> GvomConfig:
    return GvomConfig(max_points=max_points, **SWEEP[name][1])


def random_terrain(rng):
    """A random mix of bumps, a wall segment and a trench (the JAX fuzz
    suite's terrain, drawn from rng in the same order)."""
    amp = rng.uniform(0.1, 0.5)
    wl = rng.uniform(3.0, 8.0)
    xw = rng.uniform(5.0, 9.0)
    wh = rng.uniform(1.0, 3.0)
    xc = rng.uniform(-9.0, -5.0)
    wd = rng.uniform(1.0, 3.0)
    tw = rng.uniform(1.5, 4.0)
    gx = rng.uniform(-0.15, 0.15)
    gy = rng.uniform(-0.15, 0.15)

    def h(x, y):
        base = gx * x + gy * y + amp * np.sin(2 * np.pi * x / wl) * np.cos(2 * np.pi * y / wl)
        wall = np.where((x > xw) & (x < xw + 0.8) & (np.abs(y) < 6.0), wh, 0.0)
        trench = np.where(np.abs(x - xc) < tw / 2, -wd, 0.0)
        return base + wall + trench

    return synthetic.Terrain(h, "fuzz")


def sweep_drive(cfg: GvomConfig, seed: int):
    """[(points [n,3] f32, ego [3] f64)] of the facade drive: SWEEP_SCANS
    scans of a random terrain with a moving ego."""
    rng = np.random.default_rng(seed)
    terrain = random_terrain(rng)
    ego = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), 1.4 + rng.uniform(0, 0.4)])
    out = []
    for step in range(SWEEP_SCANS):
        ego = ego + np.array([rng.uniform(0.1, 1.2), rng.uniform(-0.6, 0.6), rng.uniform(-0.05, 0.05)])
        pts = synthetic.simulate_lidar_scan(terrain, ego, channels=24, azimuth_steps=96,
                                            max_range=0.5 * cfg.xy_size * cfg.xy_resolution, seed=seed * 10 + step)
        out.append((synthetic.nudge_off_grid(pts, cfg.xy_resolution, cfg.z_resolution), ego.copy()))
    return out


def sweep_batches(cfg: GvomConfig, seed: int):
    """[(scans [S,N,3], masks [S,N], egos [S,3] f32)] of the batched drive:
    SWEEP_STEPS steps of SWEEP_BATCH scans, strides long enough that the
    second step's origin moves several voxels."""
    rng = np.random.default_rng(seed + 1000)
    terrain = random_terrain(rng)
    batches = []
    ego = np.array([rng.uniform(-1, 1), rng.uniform(-1, 1), 1.5])
    for b in range(SWEEP_STEPS):
        scans, masks, egos = [], [], []
        for i in range(SWEEP_BATCH):
            ego = ego + np.array([rng.uniform(0.3, 0.9), rng.uniform(-0.4, 0.4), 0.0])
            pts = synthetic.simulate_lidar_scan(terrain, ego, channels=8, azimuth_steps=32,
                                                max_range=0.4 * cfg.xy_size * cfg.xy_resolution,
                                                seed=seed * 100 + b * 10 + i)
            pts = synthetic.nudge_off_grid(pts, cfg.xy_resolution, cfg.z_resolution)
            pad, mask = synthetic.pad_scan(pts, cfg.max_points)
            scans.append(pad)
            masks.append(mask)
            egos.append(ego.astype(np.float32))
        batches.append((np.stack(scans), np.stack(masks), np.stack(egos)))
    return batches
