"""The port's debug exporters, reset and checkpoints against gvom_tpu's
facade on the CPU, over the same scans with a moving ego.

The voxel map's columns 0-4 (world xyz, hit/total, hit) and the inferred
height map are bitwise; the eigen columns 5-7 go through acos and cos in
float32 and are held within EIGEN_ATOL, the tolerance of the JAX package's
own test of them against the NumPy oracle (tests/test_exporters.py). The
height map is bitwise, its roughness and slope columns too (as the
MapProducts fields are, tests/torch_helpers.py)."""

import sys

import numpy as np
import pytest

import gvom_tpu_torch

from conftest import make_scan
from gvom_tpu.io import synthetic
from gvom_tpu_torch.utils import convert
from torch_helpers import (EGOS, assert_products_equal, jax_facade, jax_numpy, products_numpy,
                          tcfg)

EIGEN_ATOL = 2e-3
SCANS = [(make_scan(synthetic.composite_terrain(), e, seed=i), e) for i, e in enumerate(EGOS[:4])]


def feed(g, scans=SCANS):
    for pts, ego in scans:
        g.process_pointcloud(pts, ego)
    assert g.combine_maps() is not None
    return g


@pytest.fixture(scope="module")
def facades(small_cfg):
    return feed(jax_facade(small_cfg)), feed(gvom_tpu_torch.Gvom(config=tcfg(small_cfg), device="cpu"))


def test_debug_voxel_map(facades):
    jg, tg = facades
    ref, out = jg.make_debug_voxel_map(), tg.make_debug_voxel_map()
    assert out.dtype == ref.dtype == np.float32
    assert out.shape == ref.shape and out.shape[0] > 500
    np.testing.assert_array_equal(out[:, :5], ref[:, :5])
    np.testing.assert_allclose(out[:, 5:], ref[:, 5:], rtol=0, atol=EIGEN_ATOL)
    print(f"eigen columns: max abs err {np.abs(out[:, 5:] - ref[:, 5:]).max():.3g} over {len(out)} voxels")


def test_debug_height_maps(facades):
    jg, tg = facades
    ref, out = jg.make_debug_height_map(), tg.make_debug_height_map()
    assert out.shape == ref.shape == (jg.config.xy_size ** 2, 7)
    np.testing.assert_array_equal(out, ref)
    ref, out = jg.make_debug_inferred_height_map(), tg.make_debug_inferred_height_map()
    assert out.shape == ref.shape == (jg.config.xy_size ** 2, 3)
    np.testing.assert_array_equal(out, ref)


def test_no_data_before_the_first_combine(small_cfg, capsys):
    g = gvom_tpu_torch.Gvom(config=tcfg(small_cfg), device="cpu")
    for fn in (g.make_debug_voxel_map, g.make_debug_height_map, g.make_debug_inferred_height_map):
        assert fn() is None
    assert capsys.readouterr().out.count("No data") == 3
    assert g.products is None and g.get_map_as_occupancy_grid() is None


def test_reset_then_the_same_scans_gives_the_same_products(facades, small_cfg):
    """reset forgets the buffer, the world and the products; the same scans
    after it give bitwise the products and world of the first pass (the
    buffer is a fresh one: ingest writes it in place)."""
    _, first = facades
    g = feed(gvom_tpu_torch.Gvom(config=tcfg(small_cfg), device="cpu"))
    g.reset()
    assert g.products is None and g.make_debug_voxel_map() is None
    assert g.combine_maps() is None                     # the buffer is empty again
    assert not bool(g.world_state.valid) and int(g.world_state.grid.hit.sum()) == 0
    feed(g)
    assert_products_equal(products_numpy(g.products), products_numpy(first.products), "after reset")
    for k, v in convert.to_numpy(first.world_state).items():
        np.testing.assert_array_equal(convert.to_numpy(g.world_state)[k], v, err_msg=f"world after reset: {k}")


def test_reset_and_checkpoints_run_on_the_facade_stream(small_cfg, tmp_path, monkeypatch):
    """reset's fresh state, save_checkpoint's copies and load_checkpoint's
    tensors are made inside the facade's stream context (on the card, the
    stream current when the facade was made), as ingest's writes are: a
    thread on another stream could otherwise zero-fill a buffer that the
    next ingest is writing."""
    import contextlib

    from gvom_tpu_torch.engine import gvom as facade

    g = feed(gvom_tpu_torch.Gvom(config=tcfg(small_cfg), device="cpu"))
    depth, seen = [], []

    @contextlib.contextmanager
    def on_stream():
        depth.append(1)
        try:
            yield
        finally:
            depth.pop()

    monkeypatch.setattr(g, "_on_stream", on_stream)
    for name in ("empty_buffer_state", "empty_world_state", "save_world", "load_world"):
        def spy(*a, _fn=getattr(facade, name), _name=name, **k):
            seen.append((_name, bool(depth)))
            return _fn(*a, **k)

        monkeypatch.setattr(facade, name, spy)
    path = g.save_checkpoint(str(tmp_path / "world"))
    g.reset()
    g.load_checkpoint(path)
    assert seen == [("save_world", True), ("empty_buffer_state", True), ("empty_world_state", True),
                    ("load_world", True)]


def test_jax_checkpoint_loads_into_the_port(facades, small_cfg, tmp_path, monkeypatch):
    jg, _ = facades
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)   # gvom_tpu's npz form
    path = jg.save_checkpoint(str(tmp_path / "jax_world"))
    g = gvom_tpu_torch.Gvom(config=tcfg(small_cfg), device="cpu")
    g.load_checkpoint(path)
    got, want = convert.to_numpy(g.world_state), convert.logical_from_jax_numpy(jax_numpy(jg.world_state))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    back = g.save_checkpoint(str(tmp_path / "port_world"))
    np.testing.assert_array_equal(np.load(back)["mom"], np.load(path)["mom"])
    bad = gvom_tpu_torch.Gvom(config=tcfg(small_cfg).replace(z_size=2 * small_cfg.z_size), device="cpu")
    with pytest.raises(ValueError, match="does not match"):
        bad.load_checkpoint(path)


def test_moment_features_match_jax():
    """mean_local, covariance and eigenvalues on the same moments: the
    first two bitwise, the eigenvalues within EIGEN_ATOL, with the empty
    voxel (n = 0), diagonal covariances (the p1 == 0 branch) and a
    rank-one one (acos's argument at its clamp) among them."""
    import torch
    from gvom_tpu.ops import moments as jm
    from gvom_tpu_torch.ops import moments as tm

    rng = np.random.default_rng(5)
    pts = [rng.normal(size=(k, 3)) * rng.uniform(0.05, 0.4, 3) for k in (1, 2, 3, 5, 40, 200)]
    pts += [np.c_[rng.normal(size=(9, 1)) * 0.3, np.zeros((9, 2))]]                  # rank one
    pts += [np.diag([0.1, 0.2, 0.3]), np.eye(3) * 0.25]                              # diagonal
    n = np.array([0.0] + [len(p) for p in pts], np.float32)
    s1 = np.zeros((3, len(n)), np.float32)
    s2 = np.zeros((6, len(n)), np.float32)
    for i, p in enumerate(pts, start=1):
        s1[:, i] = p.sum(0)
        s2[:, i] = [(p[:, a] * p[:, b]).sum() for a, b in ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))]
    np.testing.assert_array_equal(tm.mean_local(torch.from_numpy(n), torch.from_numpy(s1)).numpy(),
                                  np.asarray(jm.mean_local(n, s1)))
    cov = tm.covariance(torch.from_numpy(n), torch.from_numpy(s1), torch.from_numpy(s2))
    np.testing.assert_array_equal(cov.numpy(), np.asarray(jm.covariance(n, s1, s2)))
    ev, ref = tm.eigenvalues(cov).numpy(), np.asarray(jm.eigenvalues(np.asarray(jm.covariance(n, s1, s2))))
    np.testing.assert_allclose(ev, ref, rtol=0, atol=EIGEN_ATOL)
    assert (ev[:, 0] == 0).all() and (ev[0] >= ev[1]).all() and (ev[1] >= ev[2] - 1e-6).all()
