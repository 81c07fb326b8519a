"""The port's VoxelMapperNode against gvom_tpu's on the CPU: the same scans
and odometry through on_odometry / on_pointcloud, publish_maps after each
scan and publish_debug at the end. Every published layer is bitwise equal;
the debug clouds have JAX's channel names and shapes (their values are
held in tests/test_torch_exporters.py). Then the threads: two sensor
threads, the timer and the debug exporters, and an exception raised in the
timer thread."""

import threading
import time

import numpy as np
import pytest

from gvom_tpu.engine.node import VoxelMapperNode as JaxNode
from gvom_tpu_torch import VoxelMapperNode

from conftest import make_scan
from gvom_tpu.io import synthetic
from torch_helpers import EGOS, jax_facade, tcfg

LAYERS = ("hard_obstacle_map", "soft_obstacle_map", "positive_obstacle_map", "negative_obstacle_map",
          "ground_certainty_map", "all_ground_certainty_map", "roughness_map")
JOIN_S = 10.0


def drive(node, published, scans):
    layers = []
    for pts, ego in scans:
        node.on_odometry(ego)
        assert node.on_pointcloud(pts)
        layers.append(node.publish_maps())
    node.publish_debug()
    return layers


@pytest.fixture(scope="module")
def nodes(small_cfg):
    scans = [(make_scan(synthetic.composite_terrain(), e, seed=i, cfg=small_cfg), e) for i, e in enumerate(EGOS)]
    out = []
    def jax_node(pub):
        node = JaxNode(config=small_cfg, publisher=pub)
        node.engine = jax_facade(small_cfg)
        return node

    for make in (jax_node,
                 lambda pub: VoxelMapperNode(config=tcfg(small_cfg), publisher=pub, device="cpu")):
        published = {}
        node = make(lambda name, data, meta: published.setdefault(name, []).append((data, meta)))
        out.append((node, drive(node, published, scans), published))
    return out


def test_published_layers_bitwise(nodes):
    (_, jl, jpub), (_, tl, tpub) = nodes
    assert len(tl) == len(jl) == len(EGOS)
    for i, (a, b) in enumerate(zip(tl, jl)):
        np.testing.assert_array_equal(a.origin, b.origin)
        assert sorted(a.keys()) == sorted(b.keys()) == sorted(LAYERS)
        for name in LAYERS:
            assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
            np.testing.assert_array_equal(a[name], b[name], err_msg=f"combine {i}: {name}")
    for name in LAYERS:
        assert len(tpub[name]) == len(jpub[name]) == len(EGOS)
        assert tpub[name][-1][1].keys() == jpub[name][-1][1].keys()


def test_debug_clouds_match_jax_channels(nodes):
    (jnode, _, jpub), (tnode, _, tpub) = nodes
    assert tnode.DEBUG_CHANNELS == jnode.DEBUG_CHANNELS
    for name in tnode.DEBUG_CHANNELS:
        (a, am), (b, bm) = tpub[name][-1], jpub[name][-1]
        assert am["channels"] == bm["channels"] and a.shape == b.shape and a.dtype == b.dtype == np.float32
    # the appended obstacles channel is the Fortran-flattened positive obstacle map
    np.testing.assert_array_equal(tpub["debug/height_map"][-1][0][:, 7], jpub["debug/height_map"][-1][0][:, 7])
    assert "debug/lidar" not in tpub


def test_no_odometry_no_ingest(small_cfg):
    node = VoxelMapperNode(config=tcfg(small_cfg), device="cpu")
    assert not node.on_pointcloud(np.zeros((4, 3), np.float32))
    assert node.publish_maps() is None


def test_two_sensor_threads_and_the_timer(small_cfg):
    published = {}
    node = VoxelMapperNode(config=tcfg(small_cfg).replace(buffer_size=6, combine_freq=50.0), device="cpu",
                           publisher=lambda name, data, meta: published.setdefault(name, data))
    errors = []

    def sensor(offset, seed0):
        try:
            ego = np.array([0.3 + offset, -0.2, 1.5])
            for i in range(3):
                ego = ego + np.array([0.3, 0.15, 0.0])
                pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego, channels=16,
                                                    azimuth_steps=48, max_range=20.0, seed=seed0 + i)
                node.on_odometry(ego)
                node.on_pointcloud(pts)
        except Exception as e:  # reported by the assertion below
            errors.append(e)

    node.on_odometry(np.array([0.3, -0.2, 1.5]))
    node.start()
    threads = [threading.Thread(target=sensor, args=(0.0, 0)), threading.Thread(target=sensor, args=(1.5, 100))]
    for t in threads:
        t.start()
    deadline = time.monotonic() + JOIN_S
    while "debug/voxel" not in published and time.monotonic() < deadline:
        node.publish_debug()                           # the exporters beside the ingests and the timer's combines
        time.sleep(0.02)
    for t in threads:
        t.join(timeout=JOIN_S)
    while node.metrics.snapshot()["counters"].get("combines", 0) == 0 and time.monotonic() < deadline:
        time.sleep(0.02)
    node.stop()
    assert not any(t.is_alive() for t in threads) and not errors, errors
    counters = node.metrics.snapshot()["counters"]
    assert counters["scans"] == 6 and counters["combines"] >= 1 and "timer_errors" not in counters
    stats = node.metrics.snapshot()["timings"]
    assert stats["ingest_s"]["n"] == 6 and stats["ingest_s"]["p95"] >= stats["ingest_s"]["median"]
    assert "debug/voxel" in published and "debug/height_map" in published
    assert node.publish_maps() is not None            # a final combine sees every scan


def test_timer_exception_is_raised_on_stop(small_cfg):
    def publisher(name, data, meta):
        raise OSError("publisher down")

    node = VoxelMapperNode(config=tcfg(small_cfg).replace(combine_freq=100.0), publisher=publisher, device="cpu")
    pts, ego = make_scan(synthetic.composite_terrain(), EGOS[0], seed=0), EGOS[0]
    node.on_odometry(ego)
    node.on_pointcloud(pts)
    node.start()
    deadline = time.monotonic() + JOIN_S
    while node._timer.is_alive() and time.monotonic() < deadline:
        time.sleep(0.02)
    with pytest.raises(OSError, match="publisher down"):
        node.stop()
    assert node.metrics.snapshot()["counters"]["timer_errors"] == 1
    node.stop()                                        # the error is raised once


def test_node_regions_in_a_profile_trace(small_cfg, tmp_path):
    """utils.profiling: the node's ingest, combine and export regions show in
    the Chrome trace that profile_trace writes."""
    import json

    from gvom_tpu_torch.utils.profiling import annotate, profile_trace

    node = VoxelMapperNode(config=tcfg(small_cfg), device="cpu")
    node.on_odometry(EGOS[0])
    with profile_trace(str(tmp_path)) as prof:
        node.on_pointcloud(make_scan(synthetic.composite_terrain(), EGOS[0], seed=0))
        node.publish_maps()
        node.publish_debug()
        with annotate("outer"):
            pass
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"gvom/ingest", "gvom/combine", "gvom/export", "outer"} <= names
    assert sum(ev.name == "gvom/export" for ev in prof.events()) == 3
