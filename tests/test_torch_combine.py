"""The port's combine (gvom_tpu_torch.models.pipeline.combine, whose fusion
and column products are the plain twin of kernel K4) against gvom_tpu's
combine(impl="xla"), on the CPU, over the moving-ego drive of
tests/test_parity_combine.py: re-origin shifts, slot-order fusion and the
previous-map decay veto.

Bitwise: every world channel but the moments, and every MapProducts field.
slope_x, slope_y and roughness go through atan2 and log: the port's are
XLA's compiled log and glibc's atan2f (gvom_tpu_torch.ops.grid.log32 and
atan2_32), rounding for rounding. The moments are held as in
torch_helpers."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvom_tpu.types import empty_buffer_state as jempty_buffer
from gvom_tpu.types import empty_world_state as jempty_world

from gvom_tpu_torch.models import pipeline as tpipeline
from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

from torch_helpers import (EGOS, PRODUCTS_BITWISE as BITWISE, assert_products_equal, assert_state_equal,
                           combine_drive, convert, jax_combine, jax_ingest, jax_numpy, products_numpy, scan, t, tcfg)


@pytest.fixture(scope="module")
def drive(small_cfg):
    cfg = small_cfg
    c = tcfg(cfg)
    ingest, combine = jax_ingest(cfg), jax_combine(cfg)
    jbuf, jworld = jempty_buffer(cfg), jempty_world(cfg)
    tbuf, tworld = empty_buffer_state(c, "cpu"), empty_world_state(c, "cpu")
    out = []
    for i, ego in enumerate(EGOS):
        pad, mask = scan(cfg, i, ego)
        e = np.float32(ego)
        jbuf, _ = ingest(jbuf, jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(e))
        jworld_before = jax_numpy(jworld)
        jworld, jprod, jok = combine(jbuf, jworld, jnp.asarray(e))
        tpipeline.ingest_and_insert(c, tbuf, t(pad), t(mask), t(e))
        tworld, tprod, tok = tpipeline.combine(c, tbuf, tworld, t(e))
        out.append(dict(ok=(bool(jok), bool(tok)), ego=e,
                        jax_state=(jax_numpy(jbuf), jworld_before, jax_numpy(jworld)),
                        world=(convert.logical_from_jax_numpy(jax_numpy(jworld)), convert.to_numpy(tworld)),
                        products=(products_numpy(jprod), products_numpy(tprod))))
    return out


@pytest.mark.parametrize("step", range(len(EGOS)))
def test_world_channels(drive, step):
    r = drive[step]
    assert r["ok"] == (True, True)
    ref, port = r["world"]
    assert_state_equal(port, ref, f"world after scan {step}")
    assert (port["hit"] > 0).sum() > 100


@pytest.mark.parametrize("step", range(len(EGOS)))
def test_map_products(drive, step):
    ref, port = drive[step]["products"]
    assert_products_equal(port, ref)
    assert (port["positive_obstacle"] > 0).any() and (port["visibility"] > 0).any()


def test_combine_from_jax_state_and_empty_buffer(drive, small_cfg):
    """State carried across: the JAX buffer and world of the drive's third
    scan, converted with from_jax_numpy, combine in the port to JAX's
    result. A buffer with no valid slot leaves the world as it was and
    reports combine_ok False."""
    c = tcfg(small_cfg)
    r = drive[2]
    jbuf, jworld_before, jworld = r["jax_state"]
    tbuf = convert.from_jax_numpy(jbuf, "cpu")
    tworld = convert.from_jax_numpy(jworld_before, "cpu")
    tw2, tprod, tok = tpipeline.combine(c, tbuf, tworld, t(r["ego"]))
    assert bool(tok)
    assert_state_equal(convert.to_numpy(tw2), convert.logical_from_jax_numpy(jworld), "world")
    ref, port = r["products"][0], products_numpy(tprod)
    for k in BITWISE:
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)

    empty = empty_buffer_state(c, "cpu")
    tw3, _, ok3 = tpipeline.combine(c, empty, tw2, t(r["ego"]))
    assert not bool(ok3)
    w2, w3 = convert.to_numpy(tw2), convert.to_numpy(tw3)
    for k in w2:
        np.testing.assert_array_equal(w3[k], w2[k], err_msg=k)


def test_state_round_trip(drive, small_cfg):
    """from_jax_numpy → to_numpy returns the JAX state's logical arrays, for a
    buffer and a world that hold real scans."""
    jbuf, _, jworld = drive[1]["jax_state"]
    for state in (jbuf, jworld, jbuf.grids):
        ref = convert.logical_from_jax_numpy(state)
        port = convert.to_numpy(convert.from_jax_numpy(state, "cpu"))
        assert ref.keys() == port.keys()
        for k in ref:
            np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    # the moment unpacking follows gvom_tpu.ops.moments.unpack_moments
    from gvom_tpu.ops import moments as jmoments

    n, s1, s2 = (np.asarray(a) for a in jmoments.unpack_moments(jnp.asarray(jworld.grid.mom), small_cfg.z_size))
    mom = convert.to_numpy(convert.from_jax_numpy(jworld, "cpu"))["mom"]
    np.testing.assert_array_equal(mom, np.concatenate([n[None], s1, s2], axis=0))
    assert (n > 0).any()


@pytest.mark.parametrize("seed", [0, 1])
def test_column_products_random(small_cfg, seed):
    """maps2d's per-column products (the plain twins of K4's height,
    inferred height and positive-obstacle band sums, the latter through
    positive_obstacle_from_band as the maps' tail assembles them) against
    gvom_tpu's on random torus grids at a random origin, bitwise."""
    from gvom_tpu.ops import maps2d as jmaps2d

    from gvom_tpu_torch.ops import maps2d as tmaps2d

    cfg = small_cfg
    c = tcfg(cfg)
    X, Y, Z = cfg.grid_shape
    rng = np.random.default_rng(seed)
    occ = rng.random((X, Y, Z)) < 0.05
    minh = np.where(occ, rng.random((X, Y, Z)), 1.0).astype(np.float32)
    hit = np.where(occ, rng.integers(1, 40, (X, Y, Z)), 0).astype(np.int32)
    total = (hit + rng.integers(0, 40, (X, Y, Z))).astype(np.int32)
    evidence = np.where(~occ & (rng.random((X, Y, Z)) < 0.3), rng.integers(1, 9, (X, Y, Z)), 0).astype(np.int32)
    origin = rng.integers(-300, 300, 3).astype(np.int32)
    ego = ((origin + np.array([X, Y, Z]) / 2) * cfg.xy_resolution + rng.normal(0, 0.3, 3)).astype(np.float32)
    sx = rng.normal(0, 0.2, (X, Y)).astype(np.float32)
    sy = rng.normal(0, 0.2, (X, Y)).astype(np.float32)

    def pk(a):
        return jnp.asarray(a.reshape(X, Y // 2, 2 * Z))

    jo, je = jnp.asarray(origin), jnp.asarray(ego)
    hm = np.asarray(jmaps2d.height_map(cfg, pk(occ), pk(minh), jo, je))
    ihm = np.asarray(jmaps2d.inferred_height_map(cfg, pk(occ), pk(evidence), jo))
    pos = np.asarray(jmaps2d.positive_obstacle_map(cfg, pk(occ), pk(hit), pk(total), jnp.asarray(hm),
                                                   jnp.asarray(sx), jnp.asarray(sy), jo))
    to = t(origin)
    np.testing.assert_array_equal(tmaps2d.height_map(c, t(occ), t(minh), to, t(ego)).numpy(), hm)
    np.testing.assert_array_equal(tmaps2d.inferred_height_map(c, t(occ), t(evidence), to).numpy(), ihm)
    num, den, band_ok = tmaps2d.positive_band_sums(c, t(occ), t(hit), t(total), t(hm), to)
    assert band_ok.dtype == torch.int32
    np.testing.assert_array_equal(
        tmaps2d.positive_obstacle_from_band(c, num, den, band_ok, t(sx), t(sy)).numpy(), pos)
    assert (hm > -1000).any() and (ihm > -1000).any() and ((pos > 0) & (pos < 100)).any()


@pytest.mark.parametrize("buffer_size", [1, 5, 17])
def test_fuse_plain_at_other_buffer_depths(buffer_size):
    """fuse_plain (the plain twin of K4, which the kernel instantiates once per
    ring-buffer depth B up to 16 and takes in slot groups past it) against
    gvom_tpu's combine(impl="xla") at B = 1, 5 and 17 on a small grid, over
    a drive of 3 scans with a moving ego (torch_helpers.combine_drive): B =
    1 replaces its one slot every scan, B = 5 and 17 never wrap. The world
    channels are held as torch_helpers states, the products bitwise but for
    the slopes and roughness."""
    from gvom_tpu.config import GvomConfig

    combine_drive(GvomConfig(xy_size=32, z_size=16, max_points=1024, buffer_size=buffer_size))


def test_fuse_plain_past_256_z():
    """fuse_plain and the combine at 16×16×320 (past 256 z the kernel takes
    its grouped form, 8-byte accesses) against gvom_tpu's
    combine(impl="xla"), over a drive of 3 scans, each ingested by both
    packages (torch_helpers.combine_drive). The raycast rounds its positions
    as one FMA, as the JAX path does (fault C4, closed:
    test_torch_raycast.py::test_raycast_c4_sweep_equals_jax), so the port's
    own ingest fills the ring buffer."""
    from gvom_tpu.config import GvomConfig

    ref, tprod = combine_drive(GvomConfig(xy_size=16, z_size=320, max_points=1024, buffer_size=4))
    # the window's occupied voxels reach past z = 256
    assert (ref["hit"][:, :, 256:] > 0).any() or (ref["miss"][:, :, 256:] > 0).any()
    assert (tprod.height.numpy() > -1000).any() and (tprod.inferred_height.numpy() > -1000).any()
