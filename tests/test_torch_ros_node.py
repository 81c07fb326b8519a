"""The port's ROS node (gvom_tpu_torch/ros/node.py) against gvom_tpu's, both
driven through the stubbed rospy / tf2_ros / message modules of
tests/test_ros_node.py: the same odometry and PointCloud2 messages through
the recorded subscriber callbacks and timer ticks. Every message on the
eleven topics (seven OccupancyGrids, four debug PointCloud2s of which the
reference publishes three) is compared field by field, bitwise, with two
exception in the debug clouds' payloads: the voxel cloud's eigen channels
are held within EIGEN_ATOL (tests/test_torch_exporters.py). The height-map
cloud's roughness and slope channels are bitwise, as the MapProducts fields
are (tests/torch_helpers.py). rospy is imported only when a node is made, so
this runs without ROS."""

import importlib
import sys

import numpy as np
import pytest

from torch_helpers import jax_facade
from test_ros_node import DEBUG_TOPICS, GRID_TOPICS, _Bag, _make_msg_modules, _make_rospy, _make_tf2, \
    _synthetic_cloud_msg

EIGEN_ATOL = 2e-3
# channels of a debug cloud held within a tolerance; the others are bitwise
CLOSE = {"~debug/voxel": ((slice(5, 8), EIGEN_ATOL),)}
# tests/conftest.py's small_cfg, so that the JAX node shares the compiled facade of the other tests
PARAMS = {"~width": 64, "~height": 32, "~z_resolution": 0.4, "~buffer_size": 3, "~max_points": 4096}


def _install(monkeypatch):
    published = {}
    rospy = _make_rospy(dict(PARAMS), published)
    mods = {"rospy": rospy, "tf2_ros": _make_tf2([])}
    mods.update(_make_msg_modules())
    for name, mod in mods.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return rospy, published


def _drive(rospy):
    subs = rospy._subscribers
    for i in range(2):
        odom = _Bag()
        odom.pose.pose.position = _Bag(x=0.5 + 0.4 * i, y=0.25, z=1.6)
        subs["~odom"](odom)
        subs["~cloud"](_synthetic_cloud_msg(None, seed=i)[0])
        rospy._timers[0][1](None)


def _flat(msg, prefix=""):
    out = {}
    for k, v in vars(msg).items():
        if isinstance(v, _Bag):
            out.update(_flat(v, f"{prefix}{k}."))
        elif k == "fields":
            out[prefix + k] = [(f.name, f.offset, f.datatype, f.count) for f in v]
        else:
            out[prefix + k] = v
    return out


@pytest.fixture
def published(monkeypatch):
    """(port's, JAX's) published messages by topic."""
    rospy, jax_pub = _install(monkeypatch)
    monkeypatch.delitem(sys.modules, "gvom_tpu.ros.node", raising=False)
    jmod = importlib.reload(importlib.import_module("gvom_tpu.ros.node"))   # binds the stubs
    jnode = jmod.GvomRosNode()
    jnode.node.engine = jax_facade(jnode.node.config)
    _drive(rospy)
    monkeypatch.delitem(sys.modules, "gvom_tpu.ros.node", raising=False)

    rospy, port_pub = _install(monkeypatch)
    from gvom_tpu_torch.ros.node import GvomRosNode

    node = GvomRosNode(device="cpu")
    assert node.node.config.grid_shape == (64, 64, 32) and node.node.config.max_points == 4096
    assert set(node.pubs) | set(node.debug_pubs) == {t[1:] for t in GRID_TOPICS + DEBUG_TOPICS} | {"debug/lidar"}
    assert set(rospy._subscribers) == {"~cloud", "~odom"} and len(rospy._timers) == 1
    _drive(rospy)
    return port_pub, jax_pub


def test_every_topic_matches_the_jax_node(published):
    port, ref = published
    assert sorted(port) == sorted(ref) == sorted(GRID_TOPICS + DEBUG_TOPICS)    # debug/lidar: never
    for topic in GRID_TOPICS + DEBUG_TOPICS:
        assert len(port[topic]) == len(ref[topic]) == 2, topic
        for a, b in zip(port[topic], ref[topic]):
            fa, fb = _flat(a), _flat(b)
            assert sorted(fa) == sorted(fb), topic
            for k in fa:
                if k == "data" and topic in CLOSE:
                    x, y = (np.frombuffer(m, np.float32).reshape(-1, len(fa["fields"])).copy()
                            for m in (fa[k], fb[k]))
                    for cols, atol in CLOSE[topic]:
                        np.testing.assert_allclose(x[:, cols], y[:, cols], rtol=0, atol=atol, err_msg=topic)
                        x[:, cols] = y[:, cols] = 0
                    np.testing.assert_array_equal(x, y, err_msg=topic)
                elif isinstance(fa[k], np.ndarray):
                    assert fa[k].dtype == fb[k].dtype, (topic, k)
                    np.testing.assert_array_equal(fa[k], fb[k], err_msg=f"{topic} {k}")
                else:
                    assert type(fa[k]) is type(fb[k]) and fa[k] == fb[k], (topic, k, fa[k], fb[k])
    assert np.asarray(port["~positive_obstacle_map"][-1].data).max() > 0


def test_cloud_decode_and_no_cpu_fallback(monkeypatch):
    """The node decodes exactly the points the wire carried; main() runs the
    node on the GPU, and without one it raises rather than fall back."""
    import torch

    rospy, _ = _install(monkeypatch)
    from gvom_tpu_torch.ros import node as node_mod

    node = node_mod.GvomRosNode(device="cpu")
    seen = {}
    node.node.on_pointcloud = lambda pts, tf=None: seen.update(pts=pts, tf=tf)
    msg, pts = _synthetic_cloud_msg(None, seed=3)
    rospy._subscribers["~cloud"](msg)
    np.testing.assert_array_equal(seen["pts"], pts)
    np.testing.assert_array_equal(seen["tf"], np.eye(4))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        node_mod.main()
