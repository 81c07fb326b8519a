"""The port against the JAX package on the configuration sweep (F1-F4 of
torch_helpers.SWEEP), on the CPU: configurations whose every field the
kernels take as a constant (resolutions whose float32 reciprocals are
inexact, eigen distances 0 and 2, ring buffers of 2 to 5 scans, decay limits
2 and 4, the occupancy gate at 3, the ego disk, the obstacle thresholds, the
guess radius, the sensor-relative distance filter) differs from the default.

  * the Gvom facade: after each scan of the drive, the 5-tuple of
    combine_maps and the occupancy grid;
  * pipeline.ingest_and_insert then pipeline.combine: the world and every
    MapProducts field after each scan, against the jitted JAX functions;
  * the batched step, two steps of 8 scans, against the JAX package's on a
    mesh of one device;
  * ingest_scan(y_window=) on the quarter slab that holds the window seam
    against the JAX package's slab form.

Every channel bitwise except the nine non-n moments (MOM_RTOL / MOM_ATOL).
On the card, chip_smoke.py's phase1_config_sweep holds the kernels against
these plain versions on the same configurations."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import gvom_tpu_torch
from gvom_tpu.io import synthetic
from gvom_tpu.models import pipeline as jpipeline
from gvom_tpu.parallel.mesh import make_mesh
from gvom_tpu.parallel.sharding import make_batched_step as jmake_batched_step
from gvom_tpu.types import empty_buffer_state as jempty_buffer
from gvom_tpu.types import empty_world_state as jempty_world

from gvom_tpu_torch.models import pipeline as tpipeline
from gvom_tpu_torch.ops import grid as gridops
from gvom_tpu_torch.parallel import make_batched_step
from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

from torch_helpers import (SWEEP, SWEEP_BATCH_MAX_POINTS, assert_products_equal, assert_state_equal, convert,
                           jax_combine, jax_facade, jax_ingest, jax_numpy, products_numpy, sweep_batches, sweep_cfg,
                           sweep_drive, t, tcfg)

NAMES = sorted(SWEEP)


@pytest.fixture(scope="module", params=NAMES)
def sweep(request):
    name = request.param
    cfg = sweep_cfg(name)
    return dict(name=name, cfg=cfg, c=tcfg(cfg), drive=sweep_drive(cfg, SWEEP[name][0]))


def test_facade(sweep):
    cfg, c = sweep["cfg"], sweep["c"]
    jg, tg = jax_facade(cfg), gvom_tpu_torch.Gvom(config=c, device="cpu")
    # the facade's jitted ingest and combine are these on the CPU (its
    # combine's "auto" is "xla" off a TPU): test_pipeline reuses the compiles
    jg._ingest_no_tf, jg._combine = jax_ingest(cfg), jax_combine(cfg)
    visible = 0
    for i, (pts, ego) in enumerate(sweep["drive"]):
        assert bool(jg.process_pointcloud(pts, ego)) and bool(tg.process_pointcloud(pts, ego))
        ref, out = jg.combine_maps(), tg.combine_maps()
        for name, a, b in zip(("origin", "positive", "negative", "roughness", "visibility"), out, ref):
            assert a.dtype == b.dtype and a.shape == b.shape, f"{sweep['name']} scan {i}: {name}"
            np.testing.assert_array_equal(a, b, err_msg=f"{sweep['name']} scan {i}: {name}")
        np.testing.assert_array_equal(tg.get_map_as_occupancy_grid(), jg.get_map_as_occupancy_grid(),
                                      err_msg=f"{sweep['name']} scan {i}: occupancy")
        visible = int(out[4].sum())
    assert visible > 0


def test_pipeline(sweep):
    """ingest_and_insert then combine after each scan: the world and every
    product. The ego moves every scan, so each combine merges the live
    world at a moved origin."""
    cfg, c = sweep["cfg"], sweep["c"]
    ingest, combine = jax_ingest(cfg), jax_combine(cfg)
    jbuf, jworld = jempty_buffer(cfg), jempty_world(cfg)
    tbuf, tworld = empty_buffer_state(c, "cpu"), empty_world_state(c, "cpu")
    for i, (pts, ego) in enumerate(sweep["drive"]):
        pad, mask = synthetic.pad_scan(pts, cfg.max_points)
        e = np.float32(ego)
        jbuf, jok = ingest(jbuf, jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(e))
        _, tok = tpipeline.ingest_and_insert(c, tbuf, t(pad), t(mask), t(e))
        assert bool(jok) == bool(tok)
        jworld, jprod, jcok = combine(jbuf, jworld, jnp.asarray(e))
        tworld, tprod, tcok = tpipeline.combine(c, tbuf, tworld, t(e))
        assert bool(jcok) == bool(tcok)
        what = f"{sweep['name']} scan {i}"
        assert_state_equal(convert.to_numpy(tworld), convert.logical_from_jax_numpy(jax_numpy(jworld)),
                           f"{what}: world")
        assert_products_equal(products_numpy(tprod), products_numpy(jprod), f"{what}: products")
    assert (convert.to_numpy(tworld)["hit"] > 0).sum() > 50


def test_batched_step(sweep):
    name = sweep["name"]
    cfg = sweep_cfg(name, SWEEP_BATCH_MAX_POINTS)
    c = tcfg(cfg)
    jstep = jmake_batched_step(cfg, make_mesh(jax.devices()[:1]), raycast_impl="xla")
    tstep = make_batched_step(c, "cpu")
    jworld, tworld = jempty_world(cfg), empty_world_state(c, "cpu")
    origins = []
    for step, (scans, masks, egos) in enumerate(sweep_batches(cfg, SWEEP[name][0])):
        jworld, jprod = jstep(jworld, jnp.asarray(scans), jnp.asarray(masks), jnp.asarray(egos))
        tworld, tprod = tstep(tworld, t(scans), t(masks), t(egos))
        port = convert.to_numpy(tworld)
        assert_state_equal(port, convert.logical_from_jax_numpy(jax_numpy(jworld)), f"{name} step {step}: world")
        assert_products_equal(products_numpy(tprod), products_numpy(jprod), f"{name} step {step}: products")
        origins.append(port["origin"])
    assert not np.array_equal(*origins), "the second step did not move the origin"


def test_slab_ingest(sweep):
    """ingest_scan(y_window=) on the quarter slab that holds the window's
    seam (the torus row of the origin), against the JAX slab form."""
    cfg, c = sweep["cfg"], sweep["c"]
    pts, ego = sweep["drive"][-1]
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)
    e = np.float32(ego)
    Ys = cfg.xy_size // 4
    origin = gridops.compute_origin(c, t(e))
    ys0 = int(origin[1]) % cfg.xy_size // Ys * Ys
    grid, ok = jax.jit(lambda p, v, e: jpipeline.ingest_scan(cfg, p, v, e, y_window=(ys0, Ys)))(
        jnp.asarray(pad), jnp.asarray(mask), jnp.asarray(e))
    tgrid, tok = tpipeline.ingest_scan(c, t(pad), t(mask), t(e), y_window=(ys0, Ys))
    assert bool(ok) and bool(tok)
    assert tgrid.hit.shape == (cfg.xy_size, Ys, cfg.z_size)
    assert_state_equal(convert.to_numpy(tgrid), convert.logical_from_jax_numpy(jax_numpy(grid)),
                       f"{sweep['name']} slab ({ys0}, {Ys})")
