"""The port's Gvom facade against gvom_tpu's, on the CPU: the same scans with
a moving ego, the same 5-tuple from combine_maps after each scan, and the
same occupancy grid. roughness goes through log and is held within
ROUGH_ATOL (see tests/test_torch_combine.py); the rest is bitwise."""

import numpy as np
import pytest

import gvom_tpu
import gvom_tpu_torch

from conftest import make_scan
from gvom_tpu.io import synthetic
from torch_helpers import EGOS, tcfg

ROUGH_ATOL = 1e-4


@pytest.fixture(scope="module")
def facades(small_cfg):
    return gvom_tpu.Gvom(config=small_cfg), gvom_tpu_torch.Gvom(config=tcfg(small_cfg), device="cpu")


def test_combine_before_ingest_and_empty_cloud(small_cfg):
    g = gvom_tpu_torch.Gvom(config=tcfg(small_cfg), device="cpu")
    assert g.combine_maps() is None
    assert g.process_pointcloud(np.zeros((0, 3), np.float32), EGOS[0]) is None
    assert g.get_map_as_occupancy_grid() is None


def test_reference_positional_constructor():
    g = gvom_tpu_torch.Gvom(0.4, 0.4, 32, 16, 2, 1.0, 0.5, 0.5, 0.3, 2.0, 4.0, 1.0, 1, 1, device="cpu")
    assert g.config.grid_shape == (32, 32, 16)
    assert g.config.buffer_size == 2
    assert g._buffer.grids.hit.shape == (3, 32, 32, 16)


def test_five_outputs_match_over_moving_ego(facades, small_cfg):
    jg, tg = facades
    for i, ego in enumerate(EGOS):
        pts = make_scan(synthetic.composite_terrain(), ego, seed=i, cfg=small_cfg)
        assert bool(jg.process_pointcloud(pts, ego)) and bool(tg.process_pointcloud(pts, ego))
        ref, out = jg.combine_maps(), tg.combine_maps()
        assert len(out) == 5
        np.testing.assert_array_equal(out[0], ref[0])
        for name, a, b in zip(("positive", "negative", "visibility"), (out[1], out[2], out[4]),
                              (ref[1], ref[2], ref[4])):
            assert a.dtype == b.dtype and a.shape == b.shape == small_cfg.map_shape
            np.testing.assert_array_equal(a, b, err_msg=f"scan {i}: {name}")
        np.testing.assert_allclose(out[3], ref[3], rtol=0, atol=ROUGH_ATOL)
        np.testing.assert_array_equal(tg.get_map_as_occupancy_grid(), jg.get_map_as_occupancy_grid())
    assert tg.metrics.snapshot()["counters"]["combines"] == len(EGOS)


def test_ingest_while_combining(small_cfg):
    """A sensor thread ingests while another thread combines: no call fails,
    no ingest is lost, and the ring buffer ends as a sequential ingest of
    the same scans leaves it (the buffer is written in place under the
    state lock)."""
    import sys
    import threading

    from gvom_tpu_torch.utils import convert

    scans = [(make_scan(synthetic.composite_terrain(), e, seed=i, cfg=small_cfg), e) for i, e in enumerate(EGOS)]
    g = gvom_tpu_torch.Gvom(config=tcfg(small_cfg), device="cpu")
    ref = gvom_tpu_torch.Gvom(config=tcfg(small_cfg), device="cpu")
    errors, done = [], threading.Event()

    def ingest():
        try:
            for pts, ego in scans:
                g.process_pointcloud(pts, ego)
        except Exception as e:  # reported by the assertion below
            errors.append(e)
        finally:
            done.set()

    def combine():
        try:
            while not done.is_set():
                g.combine_maps()
        except Exception as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=ingest), threading.Thread(target=combine)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errors, errors
    for pts, ego in scans:
        ref.process_pointcloud(pts, ego)
    a, b = convert.to_numpy(g._buffer), convert.to_numpy(ref._buffer)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert g.metrics.snapshot()["counters"]["scans_ingested"] == len(scans)
    assert g.combine_maps() is not None
