"""The port's host I/O against gvom_tpu's, on the same bytes: LZ4 frames
(io/lz4f.py, byte-identical and decoded across packages), rosbag v2.0
files (io/rosbag.py: written and read by either package, flat and with
none / bz2 / lz4 chunks) and the PointCloud2 decode (io/pointcloud2.py:
the native extractor and the NumPy path, bitwise with JAX's). The LZ4
inputs stay at or under 65,536 bytes: the codec is pure Python."""

import struct

import numpy as np
import pytest

from gvom_tpu.io import lz4f as jlz4f
from gvom_tpu.io import pointcloud2 as jpc2
from gvom_tpu.io import rosbag as jrosbag
from gvom_tpu_torch.io import lz4f, pointcloud2, rosbag

from test_lz4f import _linked_frame
from test_rosbag import _make_messages


def _data(kind, n):
    rng = np.random.default_rng(n)
    if kind == "low_entropy":
        return bytes(rng.integers(0, 4, size=n, dtype=np.uint8))
    if kind == "random":
        return bytes(rng.integers(0, 256, size=n, dtype=np.uint8))
    return (b"abcdefgh" * (n // 8 + 1))[:n]


@pytest.mark.parametrize("kind,n,bsid", [("low_entropy", 0, 7), ("low_entropy", 13, 7), ("low_entropy", 4096, 7),
                                         ("low_entropy", 65536, 4), ("random", 20000, 7), ("repeat", 65536, 7)])
def test_lz4_frames_byte_identical_and_cross_decoded(kind, n, bsid):
    data = _data(kind, n)
    frame = lz4f.compress(data, block_size_id=bsid)
    assert frame == jlz4f.compress(data, block_size_id=bsid)
    assert lz4f.decompress(jlz4f.compress(data, block_size_id=bsid)) == data
    assert jlz4f.decompress(frame) == data
    assert lz4f.block_compress(data) == jlz4f.block_compress(data)
    assert lz4f.xxh32(data, 0x9E3779B1) == jlz4f.xxh32(data, 0x9E3779B1)


def test_lz4_linked_blocks_and_corrupt_frames():
    assert lz4f.decompress(_linked_frame()) == jlz4f.decompress(_linked_frame())
    frame = bytearray(lz4f.compress(b"some data " * 100))
    frame[-1] ^= 0xFF
    with pytest.raises(ValueError, match="content checksum"):
        lz4f.decompress(bytes(frame))
    with pytest.raises(ValueError, match="bad frame magic"):
        lz4f.decompress(struct.pack("<I", 0x12345678) + b"\0" * 8)


@pytest.mark.parametrize("chunked", [None, "none", "bz2", "lz4"])
def test_bags_read_the_same_by_both_packages(tmp_path, chunked):
    msgs, clouds = _make_messages()
    ours, theirs = str(tmp_path / "port.bag"), str(tmp_path / "jax.bag")
    rosbag.write_minimal_bag(ours, msgs, chunked=chunked)
    jrosbag.write_minimal_bag(theirs, msgs, chunked=chunked)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    for path in (ours, theirs):
        got, want = rosbag.read_bag_messages(path), jrosbag.read_bag_messages(path)
        assert [(m.topic, m.msg_type, m.stamp, m.raw) for m in got] == \
               [(m.topic, m.msg_type, m.stamp, m.raw) for m in want]
        log, ref = rosbag.bag_to_scanlog(path), jrosbag.bag_to_scanlog(path)
        assert len(log) == len(ref) == len(clouds)
        for (p, e, tf), (rp, re_, rtf), (xyz, pos) in zip(log, ref, clouds):
            assert p.dtype == rp.dtype == np.float32 and e.dtype == re_.dtype
            np.testing.assert_array_equal(p, rp)
            np.testing.assert_array_equal(p, xyz)
            np.testing.assert_array_equal(e, re_)
            assert tf is None and rtf is None


def test_bag_pairing_rules(tmp_path):
    """Odometry at or before each cloud; clouds before any odometry dropped;
    an ambiguous cloud topic needs naming; a file that is no bag is refused."""
    msgs = [
        ("/lidar/points", "sensor_msgs/PointCloud2", 9.0,
         rosbag.serialize_pointcloud2(np.zeros((5, 3), np.float32), 9.0)),
        ("/odom", "nav_msgs/Odometry", 10.0, rosbag.serialize_odometry([1.0, 0, 0], 10.0)),
        ("/odom", "nav_msgs/Odometry", 12.0, rosbag.serialize_odometry([2.0, 0, 0], 12.0)),
        ("/lidar/points", "sensor_msgs/PointCloud2", 11.0,
         rosbag.serialize_pointcloud2(np.ones((4, 3), np.float32), 11.0)),
    ]
    xyz = np.random.default_rng(1).normal(size=(7, 3)).astype(np.float32)
    assert rosbag.serialize_pointcloud2(xyz, 11.5) == jrosbag.serialize_pointcloud2(xyz, 11.5)
    assert rosbag.serialize_odometry([1.0, 2.5, -3.0], 10.25) == jrosbag.serialize_odometry([1.0, 2.5, -3.0], 10.25)
    path = str(tmp_path / "pair.bag")
    rosbag.write_minimal_bag(path, msgs)
    log = rosbag.bag_to_scanlog(path)
    assert len(log) == 1
    np.testing.assert_array_equal(log[0][1], [1.0, 0.0, 0.0])
    np.testing.assert_array_equal(log[0][0], np.ones((4, 3), np.float32))
    msgs.append(("/other/points", "sensor_msgs/PointCloud2", 13.0,
                 rosbag.serialize_pointcloud2(np.ones((2, 3), np.float32), 13.0)))
    rosbag.write_minimal_bag(path, msgs)
    with pytest.raises(ValueError, match="cloud"):
        rosbag.bag_to_scanlog(path)
    assert len(rosbag.bag_to_scanlog(path, cloud_topic="/lidar/points", max_scans=1)) == 1
    (tmp_path / "not.bag").write_bytes(b"definitely not a bag")
    with pytest.raises(ValueError, match="not a rosbag"):
        rosbag.read_bag_messages(str(tmp_path / "not.bag"))


def _cloud(dtype, point_step, bigendian=False, n=3000):
    """A PointCloud2 payload of n points (some of them NaN) with x, y, z at
    the start of each point_step-byte point; returns (data, the port's spec,
    JAX's spec)."""
    rng = np.random.default_rng(point_step)
    xyz = rng.normal(scale=20.0, size=(n, 3))
    xyz[::97, rng.integers(0, 3)] = np.nan
    xyz[5] = np.inf
    dt = np.dtype(dtype).newbyteorder(">" if bigendian else "<")
    buf = np.zeros((n, point_step), np.uint8)
    for i in range(3):
        buf[:, i * dt.itemsize:(i + 1) * dt.itemsize] = xyz[:, i].astype(dt).view(np.uint8).reshape(n, -1)
    code = 7 if dt.itemsize == 4 else 8
    specs = [mod.CloudSpec(fields=[mod.PointField(c, i * dt.itemsize, code) for i, c in enumerate("xyz")],
                           point_step=point_step, width=n, is_bigendian=bigendian) for mod in (pointcloud2, jpc2)]
    return buf.tobytes(), *specs


@pytest.mark.parametrize("dtype,point_step,bigendian", [(np.float32, 12, False), (np.float32, 20, False),
                                                        (np.float64, 32, False), (np.float32, 16, True)])
def test_pointcloud2_decode_native_and_numpy_bitwise_with_jax(dtype, point_step, bigendian):
    data, spec, jspec = _cloud(dtype, point_step, bigendian)
    ref = jpc2.pointcloud2_to_xyz(data, jspec, use_native=False)
    assert ref.shape[0] < 3000 and np.isfinite(ref).all()
    out = pointcloud2.pointcloud2_to_xyz(data, spec, use_native=False)
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(pointcloud2.pointcloud2_to_xyz(data, spec, drop_nan=False, use_native=False),
                                  jpc2.pointcloud2_to_xyz(data, jspec, drop_nan=False, use_native=False))
    assert pointcloud2.native_available()
    if bigendian:
        assert pointcloud2.decode_path(spec) == "numpy"
        with pytest.raises(RuntimeError, match="native extractor unavailable"):
            pointcloud2.pointcloud2_to_xyz(data, spec, use_native=True)
    else:
        assert pointcloud2.decode_path(spec) == "native"
        np.testing.assert_array_equal(pointcloud2.pointcloud2_to_xyz(data, spec, use_native=True), ref)
        np.testing.assert_array_equal(pointcloud2.pointcloud2_to_xyz(data, spec), ref)
    with pytest.raises(ValueError, match="payload"):
        pointcloud2.pointcloud2_to_xyz(data[:-1], spec)


def test_pointcloud2_encoder_matches_jax():
    a = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    names = ["x", "y", "z", "solid factor", "count", "eigen_line", "eigen_surface", "eigen_point"]
    (wire, spec), (jwire, jspec) = pointcloud2.array_to_pointcloud2(a, names), jpc2.array_to_pointcloud2(a, names)
    assert wire == jwire and spec.point_step == jspec.point_step and spec.width == jspec.width
    assert [(f.name, f.offset, f.datatype) for f in spec.fields] == [(f.name, f.offset, f.datatype)
                                                                     for f in jspec.fields]
    np.testing.assert_array_equal(pointcloud2.pointcloud2_to_xyz(wire, spec), a[:, :3])
    bad = pointcloud2.CloudSpec(fields=[pointcloud2.PointField(c, 8 * i, 7) for i, c in enumerate("xyz")],
                                point_step=16, width=64)
    with pytest.raises(ValueError, match="does not fit"):
        pointcloud2.pointcloud2_to_xyz(wire, bad)
    with pytest.raises(ValueError):
        pointcloud2.array_to_pointcloud2(a, names[:3])
