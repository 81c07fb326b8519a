"""The batched step's merge kernel and the 2-D maps' tail: their plain twins
against the JAX package, bitwise, on the CPU.

`kernels.merge_batch` (csrc/merge.cu on the card) merges a batch's
contribution with the old world and takes the merged world's column maps;
its twin is `parallel/sharding.py::merge_and_columns_plain`. Here the twin
goes through seeded 64×64×32 worlds with a moved origin (also an invalid
world, a far origin, a z shift) and contributions whose raw moments are
nonzero around their hits; its height, inferred height and band sums meet
`gvom_tpu/ops/maps2d.py`'s height_map, inferred_height_map and
positive_obstacle_map, jitted, fed the twin's occ2 and merged channels
through `pack_yz`; a slab (y0 = 16, Ys = 16) meets the rows of the full
result. The maps' tail, which the plane-fit kernel takes as its load and
the guess-height kernel as its epilogue (`kernels.plane_fit`,
`kernels.guess_height`), has the twins `ops/maps2d.py::maps_to_window_plain`
and `map_products_plain`, held against the JAX package's own maps' tail (`gvom_tpu/models/pipeline.py::
_combine_fused` from its kernel's column products on) on
`io.synthetic.map_tail_inputs` (cells at the slope and negative thresholds,
den = 0, UNKNOWN_HEIGHT, band cells on the window's edges). Every JAX input is a jit argument. On the card,
chip_smoke.py holds the kernels bitwise against the same twins."""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gvom_tpu.config import GvomConfig as JaxConfig
from gvom_tpu.ops import grid as jgrid
from gvom_tpu.ops import maps2d as jmaps2d
from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.io.synthetic import map_tail_inputs
from gvom_tpu_torch.ops import kernels, maps2d
from gvom_tpu_torch.parallel.sharding import merge_and_columns_plain, merge_batch_plain
from gvom_tpu_torch.types import VoxelGrid, WorldState

X, Z = 64, 32
CFG = GvomConfig(xy_size=X, z_size=Z, max_points=4096, buffer_size=3)
JCFG = JaxConfig(xy_size=X, z_size=Z, max_points=4096, buffer_size=3)
OLD_ORIGIN = (5, -7, 2)
MERGE_CASES = {"moved": ((3, -2, 1), True), "invalid world": ((3, -2, 1), False),
               "far": ((200, 0, 0), True), "z shift": ((0, 1, -9), True)}
TAIL_ORIGINS = ((5, -7, 2), (0, 0, 0), (-300, 1000, 0), (63, 1, -5))


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _same(what, got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape and got.dtype == ref.dtype, f"{what}: {got.shape} {got.dtype}, {ref.shape}"
    np.testing.assert_array_equal(_bits(got), _bits(ref), err_msg=what)


def _merge_inputs(case, seed=0, shape=(X, X, Z), zlo=0):
    """(world, contrib, ego) in numpy on a grid of `shape`: an old world at
    OLD_ORIGIN with its moments masked by its occupancy, and a batch
    contribution at the moved origin whose raw moments are nonzero within a
    voxel of its hits; hits only at torus z >= zlo."""
    d_origin, valid = MERGE_CASES[case]
    rng = np.random.default_rng([seed, list(MERGE_CASES).index(case)])
    high = np.arange(shape[2]) >= zlo

    def channels(p):
        hit = np.where((rng.random(shape) < p) & high, rng.integers(1, 30, shape), 0).astype(np.int32)
        return hit, rng.integers(0, 25, shape).astype(np.int32), rng.random(shape).astype(np.float32)

    hit, miss, minh = channels(0.06)
    mom = (rng.normal(size=(10,) + shape) * (hit > 0)).astype(np.float32)
    evidence = np.where(hit == 0, rng.integers(0, 4, shape), 0).astype(np.int32)
    world = dict(hit=hit, miss=miss, min_height=minh, mom=mom, origin=np.array(OLD_ORIGIN, np.int32),
                 evidence=evidence, valid=np.array(valid))
    chit, cmiss, cminh = channels(0.04)
    near = np.zeros(shape, bool)
    for axis in range(3):
        for s in (-1, 0, 1):
            near |= np.roll(chit > 0, s, axis)
    origin = np.array(OLD_ORIGIN, np.int32) + np.array(d_origin, np.int32)
    cmom = (rng.normal(size=(10,) + shape) * near).astype(np.float32)
    contrib = dict(hit=chit, miss=cmiss, min_height=cminh, mom=cmom, origin=origin)
    n, _, nz = shape
    ego = ((origin + np.array([n / 2 + 0.3, n / 2 - 0.6, nz / 2], np.float32)) * np.float32(0.4)).astype(np.float32)
    return world, contrib, ego


def _torch_state(world, contrib, rows=slice(None)):
    t = lambda a, d=0: torch.from_numpy(np.ascontiguousarray(a[(slice(None),) * d + (rows,)]))
    w = WorldState(grid=VoxelGrid(hit=t(world["hit"], 1), miss=t(world["miss"], 1),
                                  min_height=t(world["min_height"], 1), mom=t(world["mom"], 2),
                                  origin=torch.from_numpy(world["origin"])),
                   evidence=t(world["evidence"], 1), valid=torch.from_numpy(world["valid"]))
    c = VoxelGrid(hit=t(contrib["hit"], 1), miss=t(contrib["miss"], 1), min_height=t(contrib["min_height"], 1),
                  mom=t(contrib["mom"], 2), origin=torch.from_numpy(contrib["origin"]))
    return w, c


@functools.lru_cache(maxsize=None)
def _jax_columns(jcfg=JCFG):
    def f(occ2, minh, ev, hit, total, origin, ego, ys, sx_t, sy_t):
        p = jgrid.pack_yz
        hm = jmaps2d.height_map(jcfg, p(occ2), p(minh), origin, ego, y_coords=ys)
        ihm = jmaps2d.inferred_height_map(jcfg, p(occ2), p(ev), origin)
        pos = jmaps2d.positive_obstacle_map(jcfg, p(occ2), p(hit), p(total), hm, sx_t, sy_t, origin)
        return hm, ihm, pos

    return jax.jit(f)


def _slopes(seed, n=X):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(0.0, 0.2, (n, n)).astype(np.float32) for _ in range(2))


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_twin_column_maps_against_jax(case):
    """The twin's merged channels are merge_batch_plain's; its height,
    inferred height and, through the maps' tail, positive obstacle are the
    JAX package's functions of the same merged world, bitwise."""
    _merge_twin_against_jax(case, CFG, JCFG)


def test_merge_twin_past_256_z():
    """The same at 16×16×320, where the merge kernel takes its form past
    256 z, with hits only at torus z >= 270: the heights and the band sums
    come from voxels past z = 256 of the window."""
    n, nz = 16, 320
    cols = _merge_twin_against_jax("moved", GvomConfig(xy_size=n, z_size=nz, max_points=4096, buffer_size=3),
                                   JaxConfig(xy_size=n, z_size=nz, max_points=4096, buffer_size=3), zlo=270)
    lowest = (cols[0].numpy() / np.float32(0.4)).max() - (OLD_ORIGIN[2] + MERGE_CASES["moved"][0][2])
    assert lowest > 256


def test_merge_twin_past_768_z():
    """The same at 16×16×800, past the z size (768) beyond which the merge
    kernel's band inputs no longer fit in shared memory and its band sums
    read back the merged column, with hits only at torus z >= 780."""
    n, nz = 16, 800
    cols = _merge_twin_against_jax("moved", GvomConfig(xy_size=n, z_size=nz, max_points=4096, buffer_size=3),
                                   JaxConfig(xy_size=n, z_size=nz, max_points=4096, buffer_size=3), zlo=780)
    lowest = (cols[0].numpy() / np.float32(0.4)).max() - (OLD_ORIGIN[2] + MERGE_CASES["moved"][0][2])
    assert lowest > 768


def _merge_twin_against_jax(case, cfg, jcfg, zlo=0):
    """Returns the twin's column maps."""
    X, _, Z = cfg.grid_shape
    world, contrib, ego = _merge_inputs(case, shape=cfg.grid_shape, zlo=zlo)
    w, c = _torch_state(world, contrib)
    merged, evidence, cols, bands = merge_and_columns_plain(cfg, w, c, torch.from_numpy(ego), 0)
    ref_merged, ref_ev, occ2 = merge_batch_plain(cfg, w, c)
    for name in ("hit", "miss", "min_height", "mom", "origin"):
        _same(f"{case}: {name}", getattr(merged, name), getattr(ref_merged, name))
    _same(f"{case}: evidence", evidence, ref_ev)
    assert cols.shape == (2, X, X) and bands.shape == (3, X, X) and bands.dtype == torch.int32
    sx, sy = _slopes(1, X)
    origin = contrib["origin"]
    sx_t, sy_t = (np.asarray(jgrid.window_to_torus(jnp.asarray(s), origin, grid_ndim=2)) for s in (sx, sy))
    hit, miss = merged.hit.numpy(), merged.miss.numpy()
    hm, ihm, pos_t = _jax_columns(jcfg)(occ2.numpy(), merged.min_height.numpy(), evidence.numpy(), hit,
                                        hit + miss, origin, ego, np.arange(X, dtype=np.int32), sx_t, sy_t)
    _same(f"{case}: height", cols[0], hm)
    _same(f"{case}: inferred height", cols[1], ihm)
    hm_w, _ = maps2d.maps_to_window_plain(cols[0], cols[1], c.origin)
    pos, _, _ = maps2d.map_products_plain(cfg, bands[0], bands[1], bands[2], torch.from_numpy(sx),
                                          torch.from_numpy(sy), torch.zeros((X, X)), hm_w, c.origin)
    _same(f"{case}: positive obstacle", pos, jgrid.torus_to_window(pos_t, origin, grid_ndim=2))
    occupied = occ2.numpy().any(-1)
    assert occupied.mean() > 0.5 and (bands[2].numpy() > 0).any() and (bands[0].numpy() > 0).any()
    # old voxels join the merge where the windows overlap and the old world is valid
    assert bool((merged.hit > c.hit).any()) == (case in ("moved", "z shift"))
    return cols


@pytest.mark.parametrize("case", ["moved", "z shift"])
def test_merge_twin_on_a_slab_is_the_full_rows(case):
    """The slab y0 = 16, Ys = 16 (the world's and the contribution's rows)
    gives, bitwise, the rows of the full result, and its height map is the
    JAX package's with the slab's y_coords."""
    world, contrib, ego = _merge_inputs(case)
    y0, Ys = 16, 16
    rows = slice(y0, y0 + Ys)
    full = merge_and_columns_plain(CFG, *_torch_state(world, contrib), torch.from_numpy(ego), 0)
    slab = merge_and_columns_plain(CFG, *_torch_state(world, contrib, rows), torch.from_numpy(ego), y0)
    for name in ("hit", "miss", "min_height"):
        _same(f"slab {name}", getattr(slab[0], name), getattr(full[0], name)[:, rows])
    _same("slab mom", slab[0].mom, full[0].mom[:, :, rows])
    _same("slab evidence", slab[1], full[1][:, rows])
    _same("slab cols", slab[2], full[2][:, :, rows])
    _same("slab bands", slab[3], full[3][:, :, rows])
    # the merge gives every voxel of occ2, and no other, a positive hit
    occ2 = (slab[0].hit > 0).numpy()
    hm = jax.jit(lambda o, m, org, e, ys: jmaps2d.height_map(JCFG, jgrid.pack_yz(o), jgrid.pack_yz(m), org, e,
                                                             y_coords=ys))(
        occ2, slab[0].min_height.numpy(), contrib["origin"], ego, np.arange(y0, y0 + Ys, dtype=np.int32))
    _same("slab height vs JAX", slab[2][0], hm)


# egos at which a height map whose disk seed computes with the decimal
# resolution instead of XLA's f32(xy_resolution) differs at a boundary cell
# (ROADMAP §C, fault C2)
FAR_EGOS = ((-2861.950927734375, -2783.637451171875, 2863.93994140625),
            (-2941.975341796875, 1164.08056640625, 2173.244873046875),
            (-571.199951171875, 2734.81982421875, 761.3739624023438),
            (2128.54150390625, -2382.275390625, -84.17460632324219))


@pytest.mark.parametrize("ego", FAR_EGOS)
def test_height_map_disk_seed_far_from_the_world_origin(ego):
    """With no occupied voxel the height map is the ego-disk seed; at these
    egos kilometres from the world origin, a disk boundary cell lies within
    the difference between 0.4 and f32(0.4) times the cell's coordinate:
    the port's height_map is bitwise the JAX package's there."""
    ego = np.array(ego, np.float32)
    origin = np.floor(ego / np.float32(0.4) - np.array([X / 2, X / 2, Z / 2], np.float32)).astype(np.int32)
    occ, minh = np.zeros((X, X, Z), bool), np.zeros((X, X, Z), np.float32)
    ref = jax.jit(lambda o, m, org, e: jmaps2d.height_map(JCFG, jgrid.pack_yz(o), jgrid.pack_yz(m), org, e))(
        occ, minh, origin, ego)
    got = maps2d.height_map(CFG, torch.from_numpy(occ), torch.from_numpy(minh), torch.from_numpy(origin),
                            torch.from_numpy(ego))
    _same("disk seed", got, ref)


def _jax_tail(*maps):
    """The JAX package's maps' tail: gvom_tpu/models/pipeline.py::
    _combine_fused, jitted, with its kernel (pallas_kernels.fused_combine)
    and its two stencils replaced, while it is traced, by functions that
    return the given column maps, band sums, slopes and guessed delta. The
    package's own lines then compute the window layout, the positive
    obstacle from the band sums, the negative obstacle and the visibility.
    Returns (hm, ihm, pos, neg, vis)."""
    from gvom_tpu.models import pipeline as jpipeline
    from gvom_tpu.ops import pallas_kernels
    from gvom_tpu.types import empty_buffer_state, empty_world_state

    def f(hm_t, ihm_t, pnum, pden, bok, sx, sy, ghd, origin):
        buf, world = empty_buffer_state(JCFG), empty_world_state(JCFG)
        g = world.grid
        products = (g.hit_pk, g.miss_pk, g.minh_pk, world.evidence_pk, hm_t, ihm_t, pnum, pden, bok)
        with mock.patch.object(pallas_kernels, "fused_combine", lambda *a, **k: products), \
                mock.patch.object(jmaps2d, "slope_and_roughness", lambda cfg, hm: (sx, sy, jnp.zeros_like(sx))), \
                mock.patch.object(jmaps2d, "guess_height_delta", lambda cfg, hm, ihm: ghd):
            _, p, _ = jpipeline._combine_fused(JCFG, buf, world, jnp.zeros(3, jnp.float32), origin,
                                               jnp.asarray(True))
        return p.height, p.inferred_height, p.positive_obstacle, p.negative_obstacle, p.visibility

    return jax.jit(f)(*maps)


def _tail_inputs(seed):
    d = map_tail_inputs(X, CFG.slope_obstacle_threshold, CFG.negative_obstacle_threshold, seed)
    return d, {k: torch.from_numpy(v) for k, v in d.items()}


@pytest.mark.parametrize("origin", TAIL_ORIGINS)
def test_map_tail_twins_against_jax(origin):
    """maps_to_window_plain and map_products_plain against the JAX
    package's maps' tail (the window layout, the positive obstacle from the
    band sums, the negative obstacle and the visibility), bitwise."""
    d, tt = _tail_inputs(sum(origin) % 7)
    o = np.array(origin, np.int32)
    ref = _jax_tail(d["hm_t"], d["ihm_t"], d["pnum"], d["pden"], d["band_ok"], d["slope_x"], d["slope_y"], d["ghd"], o)
    hm, ihm = maps2d.maps_to_window_plain(tt["hm_t"], tt["ihm_t"], torch.from_numpy(o))
    _same("height", hm, ref[0])
    _same("inferred height", ihm, ref[1])
    got = maps2d.map_products_plain(CFG, tt["pnum"], tt["pden"], tt["band_ok"], tt["slope_x"], tt["slope_y"],
                                    tt["ghd"], hm, torch.from_numpy(o))
    for name, a, b in zip(("positive", "negative", "visibility"), got, ref[2:]):
        _same(name, a, b)


def test_map_tail_inputs_reach_their_cases():
    """The crafted map puts cells on both sides of each threshold: steep and
    not steep at |slope| next to the threshold, negative obstacles at and
    around theirs, den = 0 with band_ok, an unknown and a known height next
    to UNKNOWN_HEIGHT, and band cells on the map's edges."""
    d, tt = _tail_inputs(0)
    o = torch.tensor([5, -7, 2], dtype=torch.int32)
    hm, _ = maps2d.maps_to_window_plain(tt["hm_t"], tt["ihm_t"], o)
    pos, neg, vis = maps2d.map_products_plain(CFG, tt["pnum"], tt["pden"], tt["band_ok"], tt["slope_x"], tt["slope_y"],
                                              tt["ghd"], hm, o)
    sx = d["slope_x"]
    steep = pos.numpy() == 100
    thr_rows = np.arange(X) % 8 < 3
    assert steep[thr_rows].any() and (~steep[thr_rows]).any()
    assert (neg.numpy()[:, 0::8] == 0).all() and (neg.numpy()[:, 2::8] == 100).all()
    assert ((d["pden"] == 0) & (d["band_ok"] > 0)).any() and (np.abs(sx[0::8]) == np.float32(0.3)).all()
    assert 0 < int(vis.sum()) < X * X and (hm.numpy() == np.float32(-1000.0)).any()
    assert (d["band_ok"][0] > 0).all() and (d["band_ok"][:, -1] > 0).all()


def test_cpu_wrappers_are_the_twins():
    """On CPU tensors the kernel wrappers run the plain twins: merge_batch
    (its slab too), and the plane fit and the guess height with the maps'
    tail folded into them (plane_fit_window_plain, guess_products_plain);
    wrong shapes, dtypes and slab rows outside the torus are refused."""
    world, contrib, ego = _merge_inputs("moved")
    w, c = _torch_state(world, contrib)
    e = torch.from_numpy(ego)
    got = kernels.merge_batch(CFG, w, c, e)
    want = merge_and_columns_plain(CFG, w, c, e, 0)
    for name in ("hit", "miss", "min_height", "mom", "origin"):
        _same(name, getattr(got[0], name), getattr(want[0], name))
    for name, a, b in zip(("evidence", "cols", "bands"), got[1:], want[1:]):
        _same(name, a, b)
    ws, cs = _torch_state(world, contrib, slice(32, 48))
    _same("slab bands", kernels.merge_batch(CFG, ws, cs, e, 32)[3], want[3][:, :, 32:48])
    with pytest.raises(ValueError, match="not inside"):
        kernels.merge_batch(CFG, ws, cs, e, 56)
    with pytest.raises(ValueError, match="world hit: shape"):
        kernels.merge_batch(CFG, ws, c, e)
    with pytest.raises(ValueError, match="ego: dtype"):
        kernels.merge_batch(CFG, w, c, e.double())

    d, tt = _tail_inputs(2)
    o = torch.tensor([5, -7, 2], dtype=torch.int32)
    fitted = kernels.plane_fit(CFG, tt["hm_t"], tt["ihm_t"], o)
    for a, b in zip(fitted, maps2d.plane_fit_window_plain(CFG, tt["hm_t"], tt["ihm_t"], o)):
        _same("plane fit", a, b)
    for a, b in zip(fitted[:2], maps2d.maps_to_window_plain(tt["hm_t"], tt["ihm_t"], o)):
        _same("window", a, b)
    args = (fitted[0], fitted[1], tt["slope_x"], tt["slope_y"], tt["pnum"], tt["pden"], tt["band_ok"], o)
    got = kernels.guess_height(CFG, *args)
    for a, b in zip(got, maps2d.guess_products_plain(CFG, *args)):
        _same("guess and products", a, b)
    for a, b in zip(got[1:], maps2d.map_products_plain(CFG, tt["pnum"], tt["pden"], tt["band_ok"], tt["slope_x"],
                                                       tt["slope_y"], got[0], fitted[0], o)):
        _same("products", a, b)
    with pytest.raises(ValueError, match="band_ok: dtype"):
        kernels.guess_height(CFG, *args[:6], tt["band_ok"].bool(), o)
    with pytest.raises(ValueError, match="ihm_t: shape"):
        kernels.plane_fit(CFG, tt["hm_t"], tt["ihm_t"][:-1], o)


def test_library_name_hashes_the_included_headers(tmp_path):
    """A kernel library is named by its source AND the headers it includes
    from its own directory: an edit of a header builds anew."""
    (tmp_path / "shared.cuh").write_text("// v1\n")
    (tmp_path / "k.cu").write_text('#include "shared.cuh"\n#include <cuda_runtime.h>\n')
    k = kernels.CudaKernel("k", str(tmp_path / "k.cu"), "k", [], "none")
    before = k.library()
    (tmp_path / "shared.cuh").write_text("// v2\n")
    assert k.library() != before and k.library().name.startswith("k-")
    assert kernels.MERGE.library() != kernels.CMB.library()
