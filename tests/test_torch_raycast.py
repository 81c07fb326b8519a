"""The port's raycast (gvom_tpu_torch.ops.raycast, the plain twin of kernel
K1) against gvom_tpu's XLA raycast, bitwise, on the CPU.

The inputs are made once with numpy and fed to both packages. The JAX side
is ray_pass_counts_xla, which tests/test_pallas_kernels.py pins bitwise to
the Pallas kernel; the numpy oracle is a second witness."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvom_tpu.config import GvomConfig
from gvom_tpu.io import synthetic
from gvom_tpu.ops import binning as jbinning
from gvom_tpu.ops import grid as jgrid
from gvom_tpu.ops import raycast as jraycast
from gvom_tpu.oracle import NumpyOracle

from gvom_tpu_torch.ops import binning as tbinning
from gvom_tpu_torch.ops import grid as tgrid
from gvom_tpu_torch.ops import kernels as tkernels
from gvom_tpu_torch.ops import raycast as traycast

from conftest import make_scan
from helpers import canonical
from torch_helpers import tcfg


def both_raycasts(cfg, pad, mask, ego, origin=None):
    """(jax passes, port passes, port origin) for one numpy scan."""
    e = np.float32(ego)
    pw, keep = jbinning.prepare_points(cfg, jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(e))
    jo = jgrid.compute_origin(cfg, jnp.asarray(e)) if origin is None else jnp.asarray(origin)
    ref = np.asarray(jax.jit(lambda *a: jraycast.ray_pass_counts_xla(cfg, *a))(pw, keep, jnp.asarray(e), jo))

    c = tcfg(cfg)
    te = torch.from_numpy(e.copy())
    tp, tk = tbinning.prepare_points(c, torch.from_numpy(pad), torch.from_numpy(mask), te)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(pw))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(keep))
    to = tgrid.compute_origin(c, te) if origin is None else torch.from_numpy(np.array(origin, np.int32))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    out = traycast.ray_pass_counts(c, tp, tk, te, to)
    return ref, out.numpy(), to.numpy()


@pytest.fixture(scope="module")
def scene(small_cfg):
    ego = np.array([0.3, -0.2, 1.5])
    pts = make_scan(synthetic.composite_terrain(), ego, cfg=small_cfg)
    pad, mask = synthetic.pad_scan(pts, small_cfg.max_points)
    return small_cfg, pts, pad, mask, ego


def test_raycast_scene_bitwise_and_oracle(scene):
    cfg, pts, pad, mask, ego = scene
    launches = tkernels.RAY.launches
    ref, out, origin = both_raycasts(cfg, pad, mask, ego)
    np.testing.assert_array_equal(out, ref)
    assert ref.sum() > 0
    # second witness: the numpy oracle's pass counts (window layout)
    sm = NumpyOracle(cfg).process_pointcloud(pts, ego)
    np.testing.assert_array_equal(canonical(out, origin), sm.passes)
    # a CPU tensor takes the plain version: no kernel launch is counted
    assert tkernels.RAY.launches == launches


@pytest.mark.parametrize("kind", ["z_dominant", "empty", "moving_ego"])
def test_raycast_variants_bitwise(scene, kind):
    cfg, _, pad, mask, ego = scene
    if kind == "z_dominant":
        # endpoints mostly straight down/up from the ego (kernel groups 4/5)
        rng = np.random.default_rng(7)
        n = 256
        d = np.stack([rng.uniform(-0.3, 0.3, n), rng.uniform(-0.3, 0.3, n),
                      np.where(rng.random(n) < 0.5, -1.0, 1.0) * rng.uniform(2.0, 5.0, n)], axis=1)
        pad = np.zeros((cfg.max_points, 3), np.float32)
        pad[:n] = np.float32(ego)[None, :] + d
        mask = np.zeros((cfg.max_points,), bool)
        mask[:n] = True
    elif kind == "empty":
        mask = np.zeros_like(mask)
    else:
        ego = ego + np.array([3.3, -2.1, 0.15])
        pts = make_scan(synthetic.composite_terrain(), ego, seed=4, cfg=cfg)
        pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    ref, out, _ = both_raycasts(cfg, pad, mask, ego)
    np.testing.assert_array_equal(out, ref)
    assert (ref.sum() == 0) == (kind == "empty")


def test_raycast_knife_edge_dominant_row_exact():
    """The knife-edge input of test_raycast_knife_edge_dominant_row_exact:
    start_x = fl32(5 − 2⁻²⁰), so at step 27 the f32 sum start+27 rounds up
    to 32.0 while the true row is 31. The integer row convention keeps both
    packages on row 31."""
    cfg = GvomConfig(xy_size=64, z_size=32, max_points=256, xy_resolution=1.0, z_resolution=1.0)
    ex = np.float32(5.0) - np.float32(2.0 ** -20)
    ego = np.array([ex, 10.0, 5.0], np.float32)
    pts = np.zeros((cfg.max_points, 3), np.float32)
    pts[0] = ego + np.array([50.0, 2.0, 1.0], np.float32)
    keep = np.zeros((cfg.max_points,), bool)
    keep[0] = True
    ref, out, _ = both_raycasts(cfg, pts, keep, ego, origin=np.zeros(3, np.int32))
    np.testing.assert_array_equal(out, ref)
    assert out[4 + 27].sum() == 1 and out[4 + 28].sum() == 1


C4_CFG = GvomConfig(xy_size=16, z_size=32, max_points=1024, buffer_size=4)


def c4_scan(s):
    """(padded points, mask, ego, the jitted JAX origin) of scan s of the
    16×16×32 drive: ego (0.3, −0.2, 1.5) + s·(0.9, 0.6, 0.02). The origin is
    compute_origin jitted, as the JAX package's pipelines run it (the eager
    function rounds differently and gives another origin at s = 5)."""
    from torch_helpers import scan

    ego = np.array([0.3, -0.2, 1.5]) + s * np.array([0.9, 0.6, 0.02])
    pad, mask = scan(C4_CFG, s, ego)
    jo = np.asarray(jax.jit(lambda e: jgrid.compute_origin(C4_CFG, e))(jnp.asarray(np.float32(ego))))
    return pad, mask, ego, jo


def test_raycast_knife_edge_follows_the_oracle():
    """Fault C4's pin (ROADMAP §C, closed; the name is from when the port
    followed the oracle here). On the 16×16×32 grid, scan 1 (ego at
    (1.2, 0.4, 1.52)) has two diagonal rays (step_y = 1 − 2⁻²³) that reach
    y = 13 − 5·2⁻²³ at step 5. The JAX package barriers the product
    (start_rel + optimization_barrier(k·step)), but the jitted XLA:CPU path
    contracts it into one FMA anyway and gives 13 − 2⁻²⁰; so does the Pallas
    K1 in interpret mode. The port computes the same FMA and equals the JAX
    path bit for bit; the NumPy oracle rounds the product first, gives 13.0,
    and differs from both at those four voxels."""
    pad, mask, ego, jo = c4_scan(1)
    ref, out, origin = both_raycasts(C4_CFG, pad, mask, ego, origin=jo)
    np.testing.assert_array_equal(out, ref)
    orc = NumpyOracle(C4_CFG).process_pointcloud(pad[mask], ego)
    np.testing.assert_array_equal(orc.origin, origin)
    assert (canonical(out, origin) != orc.passes).sum() == 4
    assert canonical(out, origin).sum() == orc.passes.sum()


@pytest.mark.parametrize("s", range(1, 16))
def test_raycast_c4_sweep_equals_jax(s):
    """Scans 1..15 of the 16×16×32 drive: the port's raycast equals the
    jitted ray_pass_counts_xla bit for bit. Before fault C4 was closed the
    port rounded k·step before the add and differed on the odd scans
    (s = 1, 3, ..., 15, by 2 to 8 voxels). The Pallas K1 in interpret mode
    (ray_pass_counts_matmul(..., interpret=True)) gave exactly the XLA
    path's counts at s = 1 and s = 5 when checked once (0 voxels apart;
    7,487 and 7,462 passes); it is not run here, since interpret mode is
    slow."""
    pad, mask, ego, jo = c4_scan(s)
    te = torch.from_numpy(np.float32(ego).copy())
    np.testing.assert_array_equal(tgrid.compute_origin(tcfg(C4_CFG), te).numpy(), jo)
    ref, out, _ = both_raycasts(C4_CFG, pad, mask, ego, origin=jo)
    np.testing.assert_array_equal(out, ref)
    assert ref.sum() > 1000


@pytest.mark.parametrize("egoi", [0, 1, 2])
def test_ray_geometry_length_and_budget_bitwise(scene, egoi):
    """length and budget (the liveness bound of every step) round exactly
    as the JAX package's compiled ray_geometry, including the 3-term sum of
    squares; so do step, delta and the dominant axis."""
    cfg, _, _, _, ego0 = scene
    ego = ego0 + np.array([[0.0, 0.0, 0.0], [1.37, -0.91, 0.05], [-2.2, 3.3, -0.4]])[egoi]
    pts = make_scan(synthetic.composite_terrain(), ego, seed=egoi, cfg=cfg)
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    e = np.float32(ego)
    pw, keep = jbinning.prepare_points(cfg, jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(e))
    j_start, j_step, j_delta, j_budget, j_dom = (np.asarray(a) for a in jax.jit(
        lambda *a: jraycast.ray_geometry(cfg, *a))(pw, keep, jnp.asarray(e)))
    c = tcfg(cfg)
    tp, tk = tbinning.prepare_points(c, torch.from_numpy(pad), torch.from_numpy(mask), torch.from_numpy(e.copy()))
    start, step, delta, budget, dom, length = (a.numpy() for a in traycast.ray_geometry(
        c, tp, tk, torch.from_numpy(e.copy())))
    live = j_budget > -1.0
    assert live.sum() > 500
    np.testing.assert_array_equal(start, j_start)
    np.testing.assert_array_equal(length[live], j_budget[live] + np.float32(1.0))
    np.testing.assert_array_equal(budget, j_budget)
    np.testing.assert_array_equal(step[live], j_step[live])
    np.testing.assert_array_equal(delta[live], j_delta[live])
    np.testing.assert_array_equal(dom[live], j_dom[live])


@pytest.fixture(scope="module")
def three_scans(small_cfg):
    """Three scans at three egos, prepared by both packages, and one origin
    (the first ego's): the inputs of K1's many-scan signature."""
    cfg = small_cfg
    c = tcfg(cfg)
    ego0 = np.array([0.3, -0.2, 1.5])
    jax_in, pts, keeps, egos = [], [], [], []
    for i, d in enumerate(([0.0, 0.0, 0.0], [1.37, -0.91, 0.05], [-2.2, 3.3, -0.4])):
        e = np.float32(ego0 + np.array(d))
        pad, mask = synthetic.pad_scan(make_scan(synthetic.composite_terrain(), e, seed=10 + i, cfg=cfg),
                                       cfg.max_points)
        pw, keep = jbinning.prepare_points(cfg, jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(e))
        jax_in.append((pw, keep, jnp.asarray(e)))
        tp, tk = tbinning.prepare_points(c, torch.from_numpy(pad), torch.from_numpy(mask), torch.from_numpy(e.copy()))
        pts.append(tp)
        keeps.append(tk)
        egos.append(torch.from_numpy(e.copy()))
    origin = np.asarray(jgrid.compute_origin(cfg, jnp.asarray(np.float32(ego0))))
    return dict(cfg=cfg, c=c, jax=jax_in, origin=origin,
                port=(torch.stack(pts), torch.stack(keeps), torch.stack(egos), torch.from_numpy(origin.copy())))


@pytest.mark.parametrize("y_window", [None, (16, 16)])
def test_many_scan_wrapper_equals_sum_of_jax_scans(three_scans, y_window):
    """kernels.ray_pass_counts on CPU tensors of S = 3 scans (points, keep,
    one ego each, one origin) runs its plain twin, and equals the sum of the
    JAX package's ray_pass_counts_xla over the scans, bit for bit; so does
    the slab form. No kernel launch is counted."""
    cfg, c = three_scans["cfg"], three_scans["c"]
    jitted = jax.jit(lambda p, k, e, o: jraycast.ray_pass_counts_xla(cfg, p, k, e, o, y_window=y_window))
    ref = sum(np.asarray(jitted(p, k, e, jnp.asarray(three_scans["origin"]))) for p, k, e in three_scans["jax"])
    launches = (tkernels.RAY.launches, tkernels.RAY_SLAB.launches)
    out = tkernels.ray_pass_counts(c, *three_scans["port"], y_window=y_window)
    np.testing.assert_array_equal(out.numpy(), ref)
    assert out.shape == (cfg.xy_size, cfg.xy_size if y_window is None else y_window[1], cfg.z_size)
    assert ref.sum() > 1000
    assert (tkernels.RAY.launches, tkernels.RAY_SLAB.launches) == launches
