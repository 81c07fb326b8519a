"""The plain twins of kernels K5 and K6 and the K7 pin, on the CPU, against
the JAX package:

  * point_moments (K2 then K5) against fused_point_moments(interpret=True),
    with the occupancy mask on and off;
  * the slab forms (y_window): slab_point_moments and
    ray_pass_counts_plain(y_window=) against gvom_tpu's slab forms AND against
    the rows [ys0, ys0+Ys) of the full grid, at two origins that put the
    window seam inside a slab;
  * ingest_scan: with buffer_insert it equals ingest_and_insert, a foreign
    origin agrees with gvom_tpu, and four slabs side by side are the full grid;
  * the JAX step-pair raycast route (_run_hist_steppair) agrees bitwise with
    the port's raycast twin: its counterpart on the card is kernel K1.

hit, min_height, pass counts and the moment count n are bitwise; the nine
other moment channels are held as torch_helpers states (f32 sums taken in
another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gvom_tpu.config import GvomConfig
from gvom_tpu.io import synthetic
from gvom_tpu.models import pipeline as jpipeline
from gvom_tpu.ops import binning as jbinning
from gvom_tpu.ops import grid as jgridops
from gvom_tpu.ops import pallas_kernels as pk
from gvom_tpu.ops import raycast as jraycast

from gvom_tpu_torch.models import pipeline as tpipeline
from gvom_tpu_torch.ops import binning, kernels, moments, raycast
from gvom_tpu_torch.ops import grid as gridops
from gvom_tpu_torch.types import empty_buffer_state

from conftest import make_scan
from torch_helpers import MOM_ATOL, MOM_RTOL, assert_state_equal, convert, jax_numpy, scan, t, tcfg

# origin_y mod 64 is 31 for the first ego and 55 for the second: the window
# seam lies inside the slab [16, 32) and inside [48, 64)
SEAM_EGOS = (np.array([0.3, -0.2, 1.5]), np.array([1.7, 9.4, 1.6]))
YS0_FRACS = (0, 1, 3)


def assert_moments(port, ref, what):
    """port, ref: [10, X, Ys, Z]; n bitwise, the rest within tolerance."""
    np.testing.assert_array_equal(port[0], ref[0], err_msg=f"{what}: n")
    np.testing.assert_allclose(port, ref, rtol=MOM_RTOL, atol=MOM_ATOL, err_msg=f"{what}: moments")


@pytest.fixture(scope="module", params=range(len(SEAM_EGOS)))
def scene(request, small_cfg):
    """Prepared points of one scan, for both packages, and the full-grid
    results of both."""
    cfg = small_cfg
    c = tcfg(cfg)
    ego = SEAM_EGOS[request.param]
    pad, mask = scan(cfg, request.param, ego)
    e = np.float32(ego)
    pw, keep, origin = jax.jit(lambda p, v, e: jbinning.prepare_points(cfg, p, v, e)
                               + (jgridops.compute_origin(cfg, e),))(jnp.asarray(pad), jnp.asarray(mask),
                                                                     jnp.asarray(e))
    tp, tkeep = binning.prepare_points(c, t(pad), t(mask), t(e))
    torigin = gridops.compute_origin(c, t(e))
    np.testing.assert_array_equal(torigin.numpy(), np.asarray(origin))
    assert int(origin[1]) % cfg.xy_size in (31, 55)
    full = moments.point_moments(c, tp, tkeep, torigin, occupancy_mask=False)
    full_passes = raycast.ray_pass_counts(c, tp, tkeep, t(e), torigin)
    return dict(cfg=cfg, c=c, e=e, jax=(pw, keep, origin), port=(tp, tkeep, torigin),
                full=tuple(a.numpy() for a in full), full_passes=full_passes.numpy())


@pytest.mark.parametrize("mask", [True, False])
def test_point_moments_matches_fused_point_moments(scene, mask):
    cfg, c = scene["cfg"], scene["c"]
    hit, minh, mom = jax.jit(lambda p, k, o: pk.fused_point_moments(cfg, p, k, o, interpret=True,
                                                                    occupancy_mask=mask))(*scene["jax"])
    thit, tminh, tmom = moments.point_moments(c, *scene["port"], occupancy_mask=mask)
    np.testing.assert_array_equal(thit.numpy(), np.asarray(hit))
    np.testing.assert_array_equal(tminh.numpy(), np.asarray(minh))
    assert_moments(tmom.numpy(), convert._unpack_moments(np.asarray(mom), cfg.z_size), f"mask={mask}")
    empty = thit.numpy() == 0
    assert bool((tmom.numpy()[:, empty] != 0).any()) == (not mask)   # raw moments reach empty voxels
    # the wrapper of K2 then K5 takes the same plain path for CPU tensors
    khit, _, kmom = kernels.point_moments(c, *scene["port"], occupancy_mask=mask)
    np.testing.assert_array_equal(khit.numpy(), thit.numpy())
    np.testing.assert_array_equal(kmom.numpy(), tmom.numpy())


@pytest.mark.parametrize("mask", [True, False])
@pytest.mark.parametrize("ys0_frac", YS0_FRACS)
def test_slab_point_moments(scene, ys0_frac, mask):
    cfg, c = scene["cfg"], scene["c"]
    Ys = cfg.xy_size // 4
    ys0 = ys0_frac * Ys
    hit, minh, mom = jax.jit(lambda p, k, o: jbinning.slab_point_moments(cfg, p, k, o, ys0, Ys,
                                                                         occupancy_mask=mask))(*scene["jax"])
    thit, tminh, tmom = moments.slab_point_moments(c, *scene["port"], ys0, Ys, occupancy_mask=mask)
    assert thit.shape == (cfg.xy_size, Ys, cfg.z_size) and tmom.shape == (10, cfg.xy_size, Ys, cfg.z_size)
    np.testing.assert_array_equal(thit.numpy(), np.asarray(hit))
    np.testing.assert_array_equal(tminh.numpy(), np.asarray(minh))
    assert_moments(tmom.numpy(), convert._unpack_moments(np.asarray(mom), cfg.z_size), "vs the JAX slab form")
    # and the rows of the full grid
    fhit, fminh, fmom = scene["full"]
    rows = slice(ys0, ys0 + Ys)
    np.testing.assert_array_equal(thit.numpy(), fhit[:, rows])
    np.testing.assert_array_equal(tminh.numpy(), fminh[:, rows])
    ref = fmom[:, :, rows] * (fhit[None, :, rows] > 0) if mask else fmom[:, :, rows]
    assert_moments(tmom.numpy(), ref, "vs the full grid's rows")


def test_slab_scratch_scales_with_the_slab(scene):
    """The slab's own-voxel sums live in Ys + 4·ry rows, not the padded
    window's Y + 2·ry, and the points whose ±ry rows miss the slab are not
    binned at all."""
    c = scene["c"]
    tp, tkeep, torigin = scene["port"]
    Ys = c.xy_size // 4
    full = binning.bin_points(c, tp, tkeep, torigin)
    slab = binning.bin_points(c, tp, tkeep, torigin, (Ys, Ys))
    ry = binning.moment_pad(c)[1]
    assert slab.sums.shape[2] == Ys + 4 * ry and full.sums.shape[2] == c.xy_size + 2 * ry
    assert 0 < float(slab.sums[0].sum()) < 0.6 * float(full.sums[0].sum())
    with pytest.raises(ValueError, match="y_window"):
        binning.bin_points(c, tp, tkeep, torigin, (3 * Ys, 2 * Ys))


def test_window_of_every_row_is_the_full_grid(scene):
    """y_window = (0, Y) is no slab: the sums keep the padded window's layout
    (what the kernels infer from ys0 and Ys alone) and the results are the
    full grid's."""
    c = scene["c"]
    tp, tkeep, torigin = scene["port"]
    whole = (0, c.xy_size)
    assert not binning.is_slab(c, whole) and not binning.is_slab(c, None) and binning.is_slab(c, (0, c.xy_size // 2))
    assert binning.padded_shape(c, whole) == binning.padded_shape(c)
    for got, ref in zip(moments.point_moments(c, tp, tkeep, torigin, whole, occupancy_mask=False), scene["full"]):
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("ys0_frac", YS0_FRACS)
def test_slab_ray_pass_counts(scene, ys0_frac):
    cfg, c, e = scene["cfg"], scene["c"], scene["e"]
    Ys = cfg.xy_size // 4
    ys0 = ys0_frac * Ys
    pw, keep, origin = scene["jax"]
    ref = np.asarray(jax.jit(lambda p, k, e, o: jraycast.ray_pass_counts_xla(cfg, p, k, e, o, y_window=(ys0, Ys)))(
        pw, keep, jnp.asarray(e), origin))
    tp, tkeep, torigin = scene["port"]
    got = raycast.ray_pass_counts(c, tp, tkeep, t(e), torigin, y_window=(ys0, Ys))
    assert got.shape == (cfg.xy_size, Ys, cfg.z_size)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy(), scene["full_passes"][:, ys0:ys0 + Ys])
    # out=: a second call adds into the same grid
    again = raycast.ray_pass_counts(c, tp, tkeep, t(e), torigin, y_window=(ys0, Ys), out=got)
    assert again is got
    np.testing.assert_array_equal(got.numpy(), 2 * ref)


def test_ingest_scan_then_buffer_insert_equals_ingest_and_insert(small_cfg):
    """Mirror of gvom_tpu's test_fused_ingest_insert_matches_plain: every
    buffer channel bitwise, the degenerate scan's write-off slot included."""
    c = tcfg(small_cfg)
    a, b = empty_buffer_state(c, "cpu"), empty_buffer_state(c, "cpu")
    ego = np.array([0.3, -0.2, 1.5])
    for i, kind in enumerate(["normal", "empty", "normal", "near", "normal"]):
        ego = ego + np.array([0.4, 0.2, 0.0])
        pad, mask = scan(small_cfg, i, ego, kind)
        grid, ok_a = tpipeline.ingest_scan(c, t(pad), t(mask), t(np.float32(ego)))
        tpipeline.buffer_insert(c, a, grid, ok_a)
        _, ok_b = tpipeline.ingest_and_insert(c, b, t(pad), t(mask), t(np.float32(ego)))
        assert bool(ok_a) == bool(ok_b) == (kind == "normal")
    sa, sb = convert.to_numpy(a), convert.to_numpy(b)
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)
    assert sa["slot_valid"].all() and (sa["mom"][:3, 0] > 0).any()


@pytest.mark.parametrize("with_transform", [False, True])
def test_ingest_scan_foreign_origin_matches_jax(small_cfg, with_transform):
    """A scan rasterized into another scan's frame (the pinned origin of a
    batched replay), with and without a sensor transform."""
    cfg = small_cfg
    c = tcfg(cfg)
    ego, other = np.float32([0.3, -0.2, 1.5]), np.float32([2.9, 1.7, 1.6])
    pad, mask = scan(cfg, 0, ego)
    tf = None
    if with_transform:
        a = 0.1
        tf = np.array([[np.cos(a), -np.sin(a), 0, 0.2], [np.sin(a), np.cos(a), 0, -0.1], [0, 0, 1, 0.05],
                       [0, 0, 0, 1]], np.float32)
    origin = np.asarray(jgridops.compute_origin(cfg, jnp.asarray(other)))
    jtf = None if tf is None else jnp.asarray(tf)
    grid, ok = jax.jit(lambda p, v, e, o: jpipeline.ingest_scan(cfg, p, v, e, jtf, origin=o))(
        jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(ego), jnp.asarray(origin))
    tgrid, tok = tpipeline.ingest_scan(c, t(pad), t(mask), t(ego), None if tf is None else t(tf), origin=t(origin))
    assert bool(ok) and bool(tok)
    assert_state_equal(convert.to_numpy(tgrid), convert.logical_from_jax_numpy(jax_numpy(grid)), "foreign origin")


def test_ingest_scan_slabs_side_by_side_are_the_full_grid(small_cfg):
    """ingest_scan(y_window=) over the four slabs of the grid, concatenated
    along y, is ingest_scan(); scan_ok refers to the slab."""
    import torch

    c = tcfg(small_cfg)
    ego = np.float32(SEAM_EGOS[0])
    pad, mask = scan(small_cfg, 0, ego)
    full, ok = tpipeline.ingest_scan(c, t(pad), t(mask), t(ego))
    Ys = c.xy_size // 4
    slabs = [tpipeline.ingest_scan(c, t(pad), t(mask), t(ego), y_window=(k * Ys, Ys)) for k in range(4)]
    for name, axis in (("hit", 1), ("miss", 1), ("min_height", 1)):
        got = torch.cat([getattr(g, name) for g, _ in slabs], dim=axis)
        np.testing.assert_array_equal(got.numpy(), getattr(full, name).numpy(), err_msg=name)
    mom = torch.cat([g.mom for g, _ in slabs], dim=2).numpy()
    assert_moments(mom, full.mom.numpy(), "slabs side by side")
    for k, (g, sok) in enumerate(slabs):
        assert bool(sok) == bool((full.hit[:, k * Ys:(k + 1) * Ys] > 0).any())
        np.testing.assert_array_equal(g.origin.numpy(), full.origin.numpy())
    assert bool(ok)


def test_steppair_route_matches_the_raycast_twin(monkeypatch):
    """_run_hist_steppair (two steps packed per matmul row, off by default
    in gvom_tpu) computes kernel K1's function: on the 256-wide scene of
    gvom_tpu's own tier test its counts equal the port's raycast twin
    bitwise, so csrc/raycast.cu is its counterpart on the card."""
    cfg = GvomConfig(xy_size=256, z_size=32, max_points=4096)
    c = tcfg(cfg)
    ego = np.array([0.3, -0.2, 1.5])
    pts = make_scan(synthetic.composite_terrain(), ego, n_az=64, channels=16, cfg=cfg, max_range=45.0)
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    e = np.float32(ego)
    monkeypatch.setattr(pk, "_RAY_STEPPAIR", True)
    monkeypatch.setattr(pk, "_RAY_TIER64", False)
    pw, keep = jbinning.prepare_points(cfg, jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(e))
    origin = jgridops.compute_origin(cfg, jnp.asarray(e))
    mm = np.asarray(pk.ray_pass_counts_matmul(cfg, pw, keep, jnp.asarray(e), origin, interpret=True))
    tp, tkeep = binning.prepare_points(c, t(pad), t(mask), t(e))
    m = raycast.march_inputs(c, tp, tkeep, t(e), t(np.asarray(origin)))
    twin = raycast.ray_pass_counts_plain(c, m, t(np.asarray(origin)))
    np.testing.assert_array_equal(twin.numpy(), mm)
    # the scene reaches the tier the step-pair kernel covers (steps 1..30) and beyond it
    assert mm.sum() > 30 * int(np.asarray(keep).sum()) // 2
    assert kernels.RAY.replaces.count("pallas_kernels.py:") == 2 and ":478" in kernels.RAY.replaces
