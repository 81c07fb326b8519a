"""The port's binning and moments (the plain twins of kernels K2 and K3)
against gvom_tpu's XLA path (bin_points + box_aggregate_moments, which
tests/test_pallas_kernels.py pins to the Pallas kernels), on the CPU.

hit and min_height are bitwise, n is exact, and the other nine moment
channels agree within torch_helpers.MOM_RTOL / MOM_ATOL (f32 sums taken in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvom_tpu.config import GvomConfig
from gvom_tpu.io import synthetic
from gvom_tpu.models import pipeline as jpipeline
from gvom_tpu.ops import binning as jbinning
from gvom_tpu.ops import grid as jgrid
from gvom_tpu.ops import moments as jmoments

from gvom_tpu_torch.models import pipeline as tpipeline
from gvom_tpu_torch.ops import binning as tbinning
from gvom_tpu_torch.ops import grid as tgrid
from gvom_tpu_torch.ops import kernels as tkernels
from gvom_tpu_torch.ops import moments as tmoments
from gvom_tpu_torch.types import empty_buffer_state

from conftest import make_scan
from torch_helpers import MOM_ATOL, MOM_RTOL, convert, jax_numpy, t, tcfg


@pytest.mark.parametrize("xye,ze", [(1, 1), (2, 1), (0, 0)])
def test_binning_and_box_moments(xye, ze):
    cfg = GvomConfig(xy_size=32, z_size=16, max_points=2048, xy_eigen_dist=xye, z_eigen_dist=ze)
    ego = np.array([0.3, -0.2, 1.5])
    pts = make_scan(synthetic.composite_terrain(), ego, n_az=48, channels=16, cfg=cfg, max_range=10.0)
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    e = np.float32(ego)
    pw, keep = jbinning.prepare_points(cfg, jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(e))
    origin = jgrid.compute_origin(cfg, jnp.asarray(e))
    bins = jax.jit(lambda *a: jbinning.bin_points(cfg, *a))(pw, keep, origin)
    n0, s1, s2 = (np.asarray(a) for a in jax.jit(lambda b: jmoments.box_aggregate_moments(cfg, b))(bins))

    c = tcfg(cfg)
    tp, tk = tbinning.prepare_points(c, t(pad), t(mask), t(e))
    to = tgrid.compute_origin(c, t(e))
    pn = tgrid.map_local(c, tp, to)
    launches = tkernels.BIN.launches
    tb = tkernels.bin_points(c, pn, tk, to)
    assert tkernels.BIN.launches == launches  # CPU tensors take the plain version
    np.testing.assert_array_equal(tb.hit.numpy(), np.asarray(bins.hit))
    np.testing.assert_array_equal(tb.min_height.numpy(), np.asarray(bins.min_height))
    assert tb.hit.sum() > 0

    mom = tmoments.box_aggregate_moments(c, tb.sums).numpy()   # window layout
    np.testing.assert_array_equal(mom[0], n0)
    np.testing.assert_allclose(mom[1:4], s1, rtol=MOM_RTOL, atol=MOM_ATOL)
    np.testing.assert_allclose(mom[4:10], s2, rtol=MOM_RTOL, atol=MOM_ATOL)


def port_ingest(cfg, pad, mask, e, tf=None):
    """The slot 0 that the port's ingest_and_insert writes into an empty
    buffer, as logical numpy arrays, and scan_ok."""
    c = tcfg(cfg)
    buf = empty_buffer_state(c, "cpu")
    _, ok = tpipeline.ingest_and_insert(c, buf, t(pad), t(mask), t(e), None if tf is None else t(tf))
    state = convert.to_numpy(buf)
    return {k: state[k][0] for k in ("hit", "miss", "min_height", "mom", "origin")}, ok


def test_ingest_scan_matches_jax(small_cfg):
    """One scan through the whole ingest: every channel of the buffer slot
    that the port's ingest_and_insert writes against gvom_tpu's ingest_scan
    (torus layout, moments occupancy-masked)."""
    cfg = small_cfg
    ego = np.array([1.1, 0.4, 1.55])
    pts = make_scan(synthetic.composite_terrain(), ego, seed=1, cfg=cfg)
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    e = np.float32(ego)
    jg, jok = jax.jit(lambda *a: jpipeline.ingest_scan(cfg, *a))(jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(e))
    ref = convert.logical_from_jax_numpy(jax_numpy(jg))
    port, tok = port_ingest(cfg, pad, mask, e)
    assert bool(tok) == bool(jok) is True
    for k in ("hit", "miss", "min_height", "origin"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    np.testing.assert_array_equal(port["mom"][0], ref["mom"][0])
    np.testing.assert_allclose(port["mom"], ref["mom"], rtol=MOM_RTOL, atol=MOM_ATOL)
    # the occupancy pre-mask: moments are zero wherever the scan has no hit
    assert not port["mom"][:, port["hit"] == 0].any()
    assert (port["mom"][0][port["hit"] > 0] > 0).all()


def test_border_points_feed_border_voxels(small_cfg):
    """Points just outside the grid still feed border voxels' moments
    (gvom.py:1184-1202 has no base bounds check): the padded scratch."""
    c = tcfg(small_cfg)
    res = np.array([c.xy_resolution, c.xy_resolution, c.z_resolution], np.float32)
    pts = np.array([[0.5, 0.5, 0.5], [-0.5, 0.5, 0.5]], np.float32) * res
    origin = t(np.zeros(3, np.int32))
    pn = tgrid.map_local(c, t(pts), origin)
    tb = tkernels.bin_points(c, pn, t(np.ones(2, bool)), origin)
    assert int(tb.hit.sum()) == 1
    mom = tmoments.box_aggregate_moments(c, tb.sums)
    assert float(mom[0, 0, 0, 0]) == 2.0


def test_ingest_scan_with_transform_matches_jax(small_cfg):
    """The sensor→world transform (gvom.py:1038-1056, applied before the
    world-frame min-distance filter), with 0/±1 rotation entries and dyadic
    translations so that the product is exact in both packages."""
    cfg = small_cfg
    ego = np.array([0.3, -0.2, 1.5])
    pts_world = make_scan(synthetic.composite_terrain(), ego, cfg=cfg)
    R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    tr = np.array([2.25, -1.5, 0.5])
    tf = np.eye(4, dtype=np.float32)
    tf[:3, :3] = R
    tf[:3, 3] = tr
    pad, mask = synthetic.pad_scan((pts_world - tr) @ R, cfg.max_points)
    e = np.float32(ego)
    jg, _ = jax.jit(lambda *a: jpipeline.ingest_scan(cfg, *a))(jnp.asarray(pad), jnp.asarray(mask),
                                                               jnp.asarray(e), jnp.asarray(tf))
    ref = convert.logical_from_jax_numpy(jax_numpy(jg))
    port, ok = port_ingest(cfg, pad, mask, e, tf)
    assert bool(ok)
    for k in ("hit", "miss", "min_height", "origin"):
        np.testing.assert_array_equal(port[k], ref[k], err_msg=k)
    np.testing.assert_allclose(port["mom"], ref["mom"], rtol=MOM_RTOL, atol=MOM_ATOL)


@pytest.mark.parametrize("form", ["ingest", "mask_on", "mask_off", "slab_mask_on", "slab_mask_off"])
def test_epilogue_twins_read_the_sums_only_where_n_is_positive(form):
    """Kernel K2 defines channels 1-9 of its sums scratch only where n > 0
    (binning.PointBins): the plain epilogue twins (K3's, K5's with the mask on
    and off, the slab's) give the same, finite output when those channels
    hold NaN everywhere else."""
    c = tcfg(GvomConfig(xy_size=32, z_size=16, max_points=2048))
    rng = np.random.default_rng(7)
    pn = t((rng.uniform(-1.5, 33.5, (3000, 3)) * np.array([1.0, 1.0, 0.5])).astype(np.float32))
    keep = t(rng.uniform(size=3000) > 0.2)
    origin = t(np.array([5, 27, -3], np.int32))        # the window seam at torus row 27, inside the slab
    y_window = (16, 16) if form.startswith("slab") else None
    bins = tbinning.bin_points(c, pn, keep, origin, y_window)
    poisoned = bins.sums.clone()
    poisoned[1:, bins.sums[0] == 0] = float("nan")
    if form == "ingest":
        def run(sums):
            out = torch.zeros((2, 10) + c.grid_shape)
            return tmoments.ingest_epilogue_plain(c, sums, bins.hit, origin, out, t(np.array([1], np.int32)))
    else:
        def run(sums):
            return tmoments.moments_epilogue_plain(c, sums, bins.hit, origin, y_window, form.endswith("mask_on"))
    ref, got = run(bins.sums), run(poisoned)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert bool((ref[..., 1:4, :, :, :] != 0).any() if form == "ingest" else (ref[1:4] != 0).any())
