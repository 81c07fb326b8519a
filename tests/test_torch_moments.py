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
from gvom_tpu_torch.ros.node import _quat_to_mat
from gvom_tpu_torch.types import empty_buffer_state

from conftest import make_scan
from torch_helpers import MOM_ATOL, MOM_RTOL, convert, jax_numpy, t, tcfg


@pytest.mark.parametrize("xye,ze", [(1, 1), (2, 1), (0, 0), (1, 9), (8, 1)])
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
    launches = tkernels.BIN.launches
    tb = tkernels.bin_points(c, tp, tk, to)
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
    tb = tkernels.bin_points(c, t(pts), t(np.ones(2, bool)), origin)
    assert int(tb.hit.sum()) == 1
    mom = tmoments.box_aggregate_moments(c, tb.sums)
    assert float(mom[0, 0, 0, 0]) == 2.0


@pytest.mark.parametrize("rotation", ["exact", "quaternion"])
def test_ingest_scan_with_transform_matches_jax(small_cfg, rotation):
    """The sensor→world transform (gvom.py:1038-1056, applied before the
    world-frame min-distance filter): with 0/±1 rotation entries and dyadic
    translations, so that the product is exact in both packages; and a
    general rotation from a quaternion as the ROS node builds it
    (ros/node.py::_quat_to_mat), whose products round as the JAX package's
    compiled dot rounds them."""
    cfg = small_cfg
    ego = np.array([0.3, -0.2, 1.5])
    pts_world = make_scan(synthetic.composite_terrain(), ego, cfg=cfg)
    if rotation == "exact":
        R = np.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
        tr = np.array([2.25, -1.5, 0.5])
        tf = np.eye(4, dtype=np.float32)
        tf[:3, :3] = R
        tf[:3, 3] = tr
    else:
        tf = _quat_to_mat(1.7, -0.9, 0.35, 0.12, -0.31, 0.87, 0.36).astype(np.float32)
        R, tr = tf[:3, :3].astype(np.float64), tf[:3, 3].astype(np.float64)
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
    """The epilogues read channels 1-9 of K2's sums only where n > 0
    (binning.PointBins): the plain epilogue twins (K3's, K5's with the mask on
    and off, the slab's) give the same, finite output when those channels
    hold NaN everywhere else."""
    c = tcfg(GvomConfig(xy_size=32, z_size=16, max_points=2048))
    rng = np.random.default_rng(7)
    pn = rng.uniform(-1.5, 33.5, (3000, 3)) * np.array([1.0, 1.0, 0.5])     # map-local voxel coordinates
    keep = t(rng.uniform(size=3000) > 0.2)
    o = np.array([5, 27, -3], np.int32)                 # the window seam at torus row 27, inside the slab
    res = np.array([c.xy_resolution, c.xy_resolution, c.z_resolution])
    points, origin = t(((pn + o) * res).astype(np.float32)), t(o)
    y_window = (16, 16) if form.startswith("slab") else None
    bins = tbinning.bin_points(c, points, keep, origin, y_window)
    poisoned = bins.rest.clone()
    poisoned[:, bins.n[0] == 0] = float("nan")
    if form == "ingest":
        def run(rest):
            out = torch.zeros((2, 10) + c.grid_shape)
            return tmoments.ingest_epilogue_plain(c, bins.n, rest, bins.hit, origin, out, t(np.array([1], np.int32)))
    else:
        def run(rest):
            return tmoments.moments_epilogue_plain(c, bins.n, rest, bins.hit, origin, y_window,
                                                   form.endswith("mask_on"))
    ref, got = run(bins.rest), run(poisoned)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_array_equal(got.numpy(), ref.numpy())
    assert bool((ref[..., 1:4, :, :, :] != 0).any() if form == "ingest" else (ref[1:4] != 0).any())


# per axis: (diagonal R2 index, ((cross R2 index, S1 component), ...)), R2 order (xx, xy, xz, yy, yz, zz)
_AX_TERMS = {0: (0, ((1, 1), (2, 2))), 1: (3, ((1, 0), (4, 2))), 2: (5, ((2, 0), (4, 1)))}


def _axis_term(v, axis, off):
    """One neighbour's moments [10, ...] translated by off along axis, as
    csrc/epilogue.cu's add_axis_term computes them in float32."""
    t, t2, tt = np.float32(off), np.float32(2 * off), np.float32(off * off)
    n = v[0]
    out = v.copy()
    out[1 + axis] = v[1 + axis] + t * n
    diag, cross = _AX_TERMS[axis]
    out[4 + diag] = (v[4 + diag] + t2 * v[1 + axis]) + tt * n
    for pair, comp in cross:
        out[4 + pair] = v[4 + pair] + t * v[1 + comp]
    return out


def _line_pass(src, axis, r, count, last):
    """One separable pass as the kernel's box_pass (x, y) and box_pass_z
    take it, step by step in float32: the targets centred at [r, r + count)
    along array axis 1 + axis start from their centre (zero where its n is
    not > 0) and add each neighbour whose n > 0 in offset order (-r .. -1,
    +1 .. +r), its channels read only there; a target that skipped a
    neighbour adds +0 once. Unless last, channels 1-9 are left NaN where the
    result's n is not > 0: the kernel writes them only where it is."""
    def take(off):
        return np.take(src, np.arange(r + off, r + off + count), axis=1 + axis)

    c = take(0)
    acc = np.where(c[:1] > 0, c, np.float32(0))
    skipped = np.zeros(acc.shape[1:], bool)
    with np.errstate(invalid="ignore"):
        for off in [*range(-r, 0), *range(1, r + 1)]:
            v = take(off)
            live = v[0] > 0
            acc = np.where(live, acc + _axis_term(v, axis, off), acc)
            skipped |= ~live
    acc = np.where(skipped, acc + np.float32(0), acc)
    if not last:
        acc[1:, ~(acc[0] > 0)] = np.nan
    return acc


@pytest.mark.parametrize("grid", ["full", "slab"])
@pytest.mark.parametrize("xye,ze", [(1, 9), (8, 1), (5, 8)])
def test_separable_recurrence_is_the_twin_bitwise(xye, ze, grid):
    """The recurrence of the epilogue's separable passes (csrc/epilogue.cu:
    pass x into W1, pass y into W2, pass z into the output), emulated in
    NumPy float32 on sums whose channels 1-9 are NaN where n == 0, is
    bitwise box_aggregate_moments at the eigen distances that take it, on
    the full grid and on a slab scratch whose window seam falls inside the
    slab: the order the card's bitwise check of those passes relies on."""
    c = tcfg(GvomConfig(xy_size=32, z_size=16, max_points=2048, xy_eigen_dist=xye, z_eigen_dist=ze))
    rng = np.random.default_rng(11)
    pn = rng.uniform(-1.5, 33.5, (3000, 3)) * np.array([1.0, 1.0, 0.5])     # map-local voxel coordinates
    keep = t(rng.uniform(size=3000) > 0.2)
    o = np.array([5, 27, -3], np.int32)                 # the window seam at torus row 27, inside the slab
    res = np.array([c.xy_resolution, c.xy_resolution, c.z_resolution])
    points, origin = t(((pn + o) * res).astype(np.float32)), t(o)
    y_window = (16, 16) if grid == "slab" else None
    bins = tbinning.bin_points(c, points, keep, origin, y_window)
    rx, ry, rz = tbinning.moment_pad(c)
    X, Y, Z = c.grid_shape
    if y_window is None:
        y_rows = torch.arange(Y) + ry
    else:
        _, len_a, _ = tbinning.slab_rows(c, origin, y_window)
        j = torch.arange(y_window[1])
        y_rows = j + ry + torch.where(j >= len_a, 2 * ry, 0)
    twin = tmoments.box_aggregate_moments(c, bins.sums, y_rows=None if y_window is None else y_rows).numpy()

    sums = bins.sums.numpy().copy()
    sums[1:, sums[0] == 0] = np.nan
    w1 = _line_pass(sums, 0, rx, X, False)
    w2 = _line_pass(w1, 1, ry, w1.shape[2] - 2 * ry, False)
    emulated = _line_pass(w2, 2, rz, Z, True)[:, :, y_rows.numpy() - ry]
    assert emulated.dtype == twin.dtype == np.float32
    np.testing.assert_array_equal(emulated.view(np.int32), twin.view(np.int32))
    assert (twin[0] > 0).any() and (twin[1:4] != 0).any()
