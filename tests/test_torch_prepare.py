"""The port's point preparation (binning.prepare_plain, the plain twin of
the prepare kernel csrc/prepare.cu, reached through kernels.prepare_points
on the CPU) against the JAX package on the CPU, bit for bit: gvom_tpu's
prepare_points (the transform and the min-distance filter), compute_origin,
and the scan_ok of an ingest (gvom_tpu/models/pipeline.py:209-213) or of
each scan of a batched step with the dead scans dropped
(gvom_tpu/parallel/sharding.py:193-202). Every JAX function is jitted with
its inputs as arguments."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvom_tpu.io import synthetic
from gvom_tpu.ops import binning as jbinning
from gvom_tpu.ops import grid as jgrid

from gvom_tpu_torch.io import synthetic as tsynthetic
from gvom_tpu_torch.ops import grid as tgrid
from gvom_tpu_torch.ops import kernels as tkernels
from gvom_tpu_torch.parallel import sharding as tsharding
from gvom_tpu_torch.ros.node import _quat_to_mat

from conftest import make_scan
from torch_helpers import EGOS, t, tcfg


def _scan_ok(cfg, p, keep, origin, axis=None):
    """scan_ok as the JAX package computes it: any kept endpoint whose voxel
    floor(p/res − origin) is in the grid."""
    vox = jnp.floor(p / jgrid.resolution_vector(cfg) - origin.astype(jnp.float32)).astype(jnp.int32)
    return jnp.any(keep & jgrid.in_bounds(cfg, vox), axis=axis)


def jax_prepare(cfg, pad, mask, ego, tf=None):
    """One scan through the JAX package: (p, keep, origin, scan_ok), the
    origin the ego's."""
    def fn(pts, valid, e, *tf_arg):
        p, keep = jbinning.prepare_points(cfg, pts, valid, e, *tf_arg)
        origin = jgrid.compute_origin(cfg, e)
        return p, keep, origin, _scan_ok(cfg, p, keep, origin)

    args = (jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(ego)) + (() if tf is None else (jnp.asarray(tf),))
    return tuple(np.asarray(a) for a in jax.jit(fn)(*args))


def jax_batch(cfg, scans, valid, egos):
    """A batch through the JAX package's batched step: each scan prepared
    (vmap), the common origin the last ego's, the dead scans dropped."""
    def fn(scans, valid, egos):
        origin = jgrid.compute_origin(cfg, egos[-1])
        pw, keep = jax.vmap(lambda pts, vm, e: jbinning.prepare_points(cfg, pts, vm, e, None))(scans, valid, egos)
        oks = _scan_ok(cfg, pw, keep, origin, axis=1)
        return pw, keep & oks[:, None], origin, oks

    return tuple(np.asarray(a) for a in jax.jit(fn)(jnp.asarray(scans), jnp.asarray(valid), jnp.asarray(egos)))


def port_prepare(cfg, pad, mask, ego, tf=None):
    """One scan through kernels.prepare_points on the CPU (the plain twin),
    as numpy (p [N,3], keep [N], origin, scan_ok)."""
    e = t(ego)
    launches = tkernels.PREP.launches
    p, keep, origin, ok = tkernels.prepare_points(tcfg(cfg), t(pad)[None], t(mask)[None], e[None], frame_ego=e,
                                                  transform=None if tf is None else t(tf))
    assert tkernels.PREP.launches == launches     # CPU tensors take the plain twin
    return p[0].numpy(), keep[0].numpy(), origin.numpy(), ok[0].numpy()


def assert_same_bits(port, ref, what):
    """float32 bit for bit (−0.0 is not 0.0); NaN only where the reference
    has NaN (its payload is the compiler's)."""
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(port), nan, err_msg=f"{what}: NaN")
    np.testing.assert_array_equal(port.view(np.int32)[~nan], ref.view(np.int32)[~nan], err_msg=what)


def assert_prepared_equal(port, ref):
    assert port[0].dtype == np.float32 and port[1].dtype == bool and port[2].dtype == np.int32
    assert_same_bits(port[0], ref[0], "p")
    for name, a, b in zip(("keep", "origin", "scan_ok"), port[1:], ref[1:]):
        np.testing.assert_array_equal(a, b, err_msg=name)


def quaternion_transform(seed):
    """A general sensor→world transform as the ROS node builds it from a
    quaternion and a translation (ros/node.py::_quat_to_mat), in float32."""
    rng = np.random.default_rng(seed)
    return _quat_to_mat(*rng.uniform(-3.0, 3.0, 3), *rng.standard_normal(4)).astype(np.float32)


EXACT = np.array([[0.0, -1.0, 0.0, 2.25], [1.0, 0.0, 0.0, -1.5], [0.0, 0.0, 1.0, 0.5], [0.0, 0.0, 0.0, 1.0]],
                 np.float32)


@pytest.mark.parametrize("case", ["no_transform", "exact_rotation", "quaternion", "ego_relative",
                                  "quaternion_ego_relative"])
def test_prepare_matches_jax(small_cfg, case):
    """One scan: world points, keep, origin and scan_ok bitwise. The scan is
    given in the sensor frame where a transform maps it back: a 0/±1
    rotation with dyadic shifts (exact products), or a general rotation
    from a quaternion (the ROS node's path), whose products round."""
    # a min_distance wide enough that the filter drops some of the scan's points
    cfg = small_cfg.replace(ego_relative_min_distance=case.endswith("ego_relative"), min_distance=3.5)
    ego = EGOS[1]
    pts = make_scan(synthetic.composite_terrain(), ego, seed=3, cfg=cfg)
    tf = {"exact_rotation": EXACT, "quaternion": quaternion_transform(0),
          "quaternion_ego_relative": quaternion_transform(1)}.get(case)
    if tf is not None:   # the sensor frame: the transform maps the points back near the terrain
        r, tr = tf[:3, :3].astype(np.float64), tf[:3, 3].astype(np.float64)
        pts = (pts - tr) @ r
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    mask[::7] = False
    e = np.float32(ego)
    ref = jax_prepare(cfg, pad, mask, e, tf)
    port = port_prepare(cfg, pad, mask, e, tf)
    assert_prepared_equal(port, ref)
    assert ref[3] and 0 < ref[1].sum() < mask.sum()       # the min-distance filter drops some points
    if tf is not None and case.startswith("quaternion"):
        # the rotation rounds: an exact float64 product would differ from the JAX package's
        exact = (pad.astype(np.float64) @ tf[:3, :3].T.astype(np.float64) + tf[:3, 3]).astype(np.float32)
        assert (exact != ref[0]).any()


@pytest.mark.parametrize("ego_relative", [False, True])
def test_batched_prepare_drops_dead_scans_as_jax(small_cfg, ego_relative):
    """A batch of four scans at the last scan's origin; scan 1 is moved out
    of the grid, so it is dead and its points leave keep. The port's
    kernels.prepare_points(drop_dead=True) and sharding.prepare_batch (its
    flat form) against the JAX package's vmapped preparation."""
    cfg = small_cfg.replace(ego_relative_min_distance=ego_relative)
    scans, valid, egos = [], [], []
    for i, ego in enumerate(EGOS[:4]):
        pts = make_scan(synthetic.composite_terrain(), ego, seed=i, n_az=32, channels=16, cfg=cfg)
        if i == 1:
            pts = pts + np.array([0.0, 3.0 * cfg.xy_size * cfg.xy_resolution, 0.0])
        pad, mask = synthetic.pad_scan(pts, cfg.max_points)
        scans.append(pad)
        valid.append(mask)
        egos.append(np.float32(ego))
    scans, valid, egos = np.stack(scans), np.stack(valid), np.stack(egos)
    ref = jax_batch(cfg, scans, valid, egos)
    assert list(ref[3]) == [True, False, True, True]
    c = tcfg(cfg)
    port = tkernels.prepare_points(c, t(scans), t(valid), t(egos), frame_ego=t(egos[-1]), drop_dead=True)
    assert_prepared_equal(tuple(a.numpy() for a in port), ref)
    origin, pw, keep = tsharding.prepare_batch(c, t(scans), t(valid), t(egos))
    np.testing.assert_array_equal(origin.numpy(), ref[2])
    assert_same_bits(pw.numpy(), ref[0].reshape(-1, 3), "prepare_batch points")
    np.testing.assert_array_equal(keep.numpy(), ref[1].reshape(-1))
    # without drop_dead the dead scan keeps its points, and scan_ok is the same
    kept = tkernels.prepare_points(c, t(scans), t(valid), t(egos), frame_ego=t(egos[-1]))
    np.testing.assert_array_equal(kept[3].numpy(), ref[3])
    assert bool(kept[1][1].any()) and not ref[1][1].any()


@pytest.mark.parametrize("valid", ["all_valid", "none_valid", "alternate"])
@pytest.mark.parametrize("transform", ["none", "quaternion"])
def test_edge_points_match_jax(small_cfg, valid, transform):
    """Voxel faces, min_distance exactly, ±1e9, ±inf and NaN, with valid on,
    off and alternating: every output bitwise the JAX package's (float to
    int conversion saturates, NaN to 0, as XLA converts). A point that is
    not valid never makes a scan ok."""
    cfg = small_cfg
    ego = np.float32(EGOS[0])
    origin = np.asarray(jgrid.compute_origin(cfg, jnp.asarray(ego)))
    res = (cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution)
    pad = tsynthetic.edge_points(res, cfg.grid_shape, origin, cfg.min_distance)
    mask = {"all_valid": np.ones(len(pad), bool), "none_valid": np.zeros(len(pad), bool),
            "alternate": np.arange(len(pad)) % 2 == 0}[valid]
    tf = quaternion_transform(2) if transform == "quaternion" else None
    ref = jax_prepare(cfg, pad, mask, ego, tf)
    port = port_prepare(cfg, pad, mask, ego, tf)
    assert_prepared_equal(port, ref)
    if valid == "none_valid":
        assert not ref[1].any() and not ref[3]
    if transform == "none" and valid == "all_valid":
        assert ref[3] and not ref[1].all()
    # each point alone: its scan_ok bitwise, so that no point's verdict hides behind another's
    for i in range(0, len(pad), 3):
        one = jax_prepare(cfg, pad[i:i + 1], mask[i:i + 1], ego, tf)
        assert_prepared_equal(port_prepare(cfg, pad[i:i + 1], mask[i:i + 1], ego, tf), one)


def test_origin_of_any_ego_matches_jax(small_cfg):
    """compute_origin bitwise on egos at voxel boundaries, far away and not
    finite (XLA saturates the conversion and gives 0 for NaN)."""
    cfg = small_cfg
    res = np.float32(cfg.xy_resolution)
    egos = np.array([[0.0, 0.0, 0.0], [res * 3, -res * 7, np.float32(cfg.z_resolution) * 5],
                     [1e9, -1e9, 3e38], [np.inf, -np.inf, np.nan], [-0.0, np.nextafter(res, 0), 1e-40]],
                    np.float32)
    ref = np.asarray(jax.jit(jax.vmap(lambda e: jgrid.compute_origin(cfg, e)))(jnp.asarray(egos)))
    c = tcfg(cfg)
    got = np.stack([tgrid.compute_origin(c, t(e)).numpy() for e in egos])
    np.testing.assert_array_equal(got, ref)
    assert ref[3].tolist() == [2 ** 31 - 1, -2 ** 31, 0]


def test_pinned_origin_and_argument_checks(small_cfg):
    """A pinned origin is the frame as it is given; the wrapper wants the
    frame's ego or a pinned origin, not both or neither, and float32 points,
    bool valid and a [4, 4] transform."""
    c = tcfg(small_cfg)
    ego = EGOS[2]
    pts = make_scan(synthetic.composite_terrain(), ego, seed=5, n_az=32, channels=16, cfg=small_cfg)
    pad, mask = synthetic.pad_scan(pts, small_cfg.max_points)
    e = t(np.float32(ego))
    pinned = tgrid.compute_origin(c, e) + torch.tensor([200, 0, 0], dtype=torch.int32)
    p, keep, origin, ok = tkernels.prepare_points(c, t(pad)[None], t(mask)[None], e[None], origin=pinned)
    assert torch.equal(origin, pinned) and not bool(ok[0])    # the scan lies outside the pinned window
    assert torch.equal(keep, tkernels.prepare_points(c, t(pad)[None], t(mask)[None], e[None], frame_ego=e)[1])
    args = (c, t(pad)[None], t(mask)[None], e[None])
    with pytest.raises(ValueError, match="one of the two"):
        tkernels.prepare_points(*args)
    with pytest.raises(ValueError, match="one of the two"):
        tkernels.prepare_points(*args, frame_ego=e, origin=pinned)
    with pytest.raises(ValueError, match="valid: dtype"):
        tkernels.prepare_points(c, t(pad)[None], t(mask)[None].int(), e[None], frame_ego=e)
    with pytest.raises(ValueError, match="transform: shape"):
        tkernels.prepare_points(*args, frame_ego=e, transform=torch.eye(3))
    with pytest.raises(ValueError, match="expected \\[S, N, 3\\]"):
        tkernels.prepare_points(c, t(pad), t(mask), e[None], frame_ego=e)
