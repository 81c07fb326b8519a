"""The last public helpers of the JAX package's ops and the subpackages'
exports, on the CPU: grid.voxel_indices, grid.rel_coords and
moments.raw_merge bitwise against the JAX functions on inputs from
numpy.random.default_rng(seed); the names the port's packages re-export as
the JAX package's do; and batched_step(..., mesh=, ingest=) bitwise
make_batched_step's step.

voxel_indices is held against the jitted JAX function: XLA compiles p/res −
origin as one FMA with f32(1/res), which the port computes. The JAX
function run eagerly divides and differs at voxel boundaries
(scripts/voxel_indices_rounding.py counts those rows); nothing here depends
on that form."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvom_tpu.ops import grid as jgrid
from gvom_tpu.ops import moments as jmoments

import gvom_tpu_torch
from gvom_tpu_torch.ops import grid, moments
from gvom_tpu_torch.parallel import batched_step, make_batched_step, make_mesh
from gvom_tpu_torch.types import empty_world_state

from torch_helpers import assert_products_equal, convert, products_numpy, scan, tcfg

RESOLUTIONS = ((0.4, 0.2), (0.3, 0.15))
ORIGINS = ((-37, 12, -5), (1024, -2048, 7))
I32 = np.iinfo(np.int32)


def index_points(rng, res_xy: float, res_z: float, n: int = 4096) -> np.ndarray:
    """[k·n, 3] float32 points: Gaussian (σ = 60 m), exact multiples of the
    resolution (k·f32(res) rounded in float32, and f32(k·res)), those ±1 ulp,
    and points at |p| between 5e8 and 1.5e9, where p/res passes INT32_MAX at
    either resolution (saturation)."""
    res = np.array([res_xy, res_xy, res_z], np.float32)
    gauss = rng.normal(0.0, 60.0, (n, 3))
    k = rng.integers(-3000, 3000, (n, 3)).astype(np.float32)
    on_f32 = (k * res).astype(np.float32)
    on_f64 = (k.astype(np.float64) * np.array([res_xy, res_xy, res_z])).astype(np.float32)
    faces = np.concatenate([on_f32, on_f64])
    ulps = np.concatenate([np.nextafter(faces, np.float32(np.inf)), np.nextafter(faces, np.float32(-np.inf))])
    far = rng.uniform(5e8, 1.5e9, (n, 3)) * rng.choice([-1.0, 1.0], (n, 3))
    return np.concatenate([gauss.astype(np.float32), faces, ulps, far.astype(np.float32)])


@pytest.mark.parametrize("res_xy,res_z", RESOLUTIONS)
def test_voxel_indices_is_the_jitted_jax_function(small_cfg, res_xy, res_z):
    cfg = dataclasses.replace(small_cfg, xy_resolution=res_xy, z_resolution=res_z)
    jfn = jax.jit(jgrid.voxel_indices, static_argnums=0)
    pts = index_points(np.random.default_rng(16), res_xy, res_z)
    for origin in ORIGINS:
        o = np.array(origin, np.int32)
        want = np.asarray(jfn(cfg, jnp.asarray(pts), jnp.asarray(o)))
        got = grid.voxel_indices(tcfg(cfg), torch.from_numpy(pts), torch.from_numpy(o))
        assert got.dtype == torch.int32 and got.shape == pts.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"origin {origin}")
        assert (want == I32.max).any() and (want == I32.min).any()    # the far points saturate
    # points of another float type are cast to float32 first, as the JAX function casts them
    p64 = np.random.default_rng(17).normal(0.0, 60.0, (4096, 3))
    o = np.array(ORIGINS[0], np.int32)
    want = np.asarray(jfn(cfg, jnp.asarray(p64.astype(np.float32)), jnp.asarray(o)))
    np.testing.assert_array_equal(grid.voxel_indices(tcfg(cfg), torch.from_numpy(p64), torch.from_numpy(o)).numpy(),
                                  want)


@pytest.mark.parametrize("origin", [(-5, -70, -33), (0, 0, 0), (64, 64, 32), (131, 200, 97),
                                    (2 ** 30, -2 ** 30, 2 ** 30 + 3), (-2 ** 30, 2 ** 30 - 1, -2 ** 30 - 7)])
def test_rel_coords_equals_jax(small_cfg, origin):
    o = np.array(origin, np.int32)
    want = jgrid.rel_coords(small_cfg, jnp.asarray(o))
    got = grid.rel_coords(tcfg(small_cfg), torch.from_numpy(o))
    assert len(got) == 3
    for ax, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == torch.int32 and g.shape == (small_cfg.grid_shape[ax],)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_raw_merge_equals_jax():
    rng = np.random.default_rng(18)

    def moments_set():
        n = rng.integers(0, 50, (8, 8, 4)).astype(np.float32)
        return n, rng.normal(0, 3, (3, 8, 8, 4)).astype(np.float32), rng.normal(0, 9, (6, 8, 8, 4)).astype(np.float32)

    a, b = moments_set(), moments_set()
    want = jmoments.raw_merge(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    got = moments.raw_merge(tuple(map(torch.from_numpy, a)), tuple(map(torch.from_numpy, b)))
    assert len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_the_subpackages_export_what_the_jax_packages_do():
    import gvom_tpu_torch.pipelines as pipelines

    assert pipelines is gvom_tpu_torch.pipelines is gvom_tpu_torch.models
    assert gvom_tpu_torch.pipeline.full_step is pipelines.full_step
    assert gvom_tpu_torch.__version__ == "0.1.0"
    from gvom_tpu_torch.engine import Gvom
    from gvom_tpu_torch.io import composite_terrain, nudge_off_grid
    from gvom_tpu_torch.models import buffer_insert, combine, full_step, ingest_and_insert, ingest_scan
    from gvom_tpu_torch.utils import StepMetrics, annotate, load_world, profile_trace, save_world

    assert Gvom is gvom_tpu_torch.Gvom and full_step is gvom_tpu_torch.models.pipeline.full_step
    assert composite_terrain is gvom_tpu_torch.io.synthetic.composite_terrain
    assert nudge_off_grid is gvom_tpu_torch.io.synthetic.nudge_off_grid
    assert (buffer_insert, combine, ingest_and_insert, ingest_scan) == tuple(
        getattr(gvom_tpu_torch.models.pipeline, n) for n in ("buffer_insert", "combine", "ingest_and_insert",
                                                             "ingest_scan"))
    assert save_world is gvom_tpu_torch.utils.checkpoint.save_world and load_world.__module__.endswith("checkpoint")
    assert StepMetrics.__module__.endswith("metrics") and callable(annotate) and callable(profile_trace)
    for sub in ("binning", "grid", "maps2d", "moments", "raycast"):
        assert getattr(gvom_tpu_torch.ops, sub).__name__ == f"gvom_tpu_torch.ops.{sub}"


def test_batched_step_takes_a_mesh_and_an_ingest(small_cfg):
    c = tcfg(small_cfg)
    egos = [np.array([0.3, -0.2, 1.5]) + k * np.array([0.4, 0.25, 0.0]) for k in range(2)]
    pts, masks = zip(*(scan(small_cfg, k, ego) for k, ego in enumerate(egos)))
    args = [torch.from_numpy(np.stack(x)) for x in (pts, masks)] + [torch.from_numpy(np.stack(egos).astype(np.float32))]
    mesh = make_mesh(1, "cpu")
    want = make_batched_step(c, "cpu", mesh, "slab")(empty_world_state(c, "cpu"), *args)
    got = batched_step(c, empty_world_state(c, "cpu"), *args, device="cpu", mesh=mesh, ingest="slab")
    got_w, want_w = convert.to_numpy(got[0]), convert.to_numpy(want[0])
    assert got_w.keys() == want_w.keys() and want_w["hit"].sum() > 0
    for k, v in want_w.items():    # every channel bitwise, the moments too: the same plain step on the CPU
        np.testing.assert_array_equal(got_w[k], v, err_msg=k)
    assert_products_equal(products_numpy(got[1]), products_numpy(want[1]))
    # the earlier positional form still runs
    again = batched_step(c, empty_world_state(c, "cpu"), *args, "cpu")
    assert_products_equal(products_numpy(again[1]), products_numpy(want[1]))
