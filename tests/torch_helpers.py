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
