"""rosbag v1 ("#ROSBAG V2.0") reader → ScanLog converter, pure Python; the
port's copy of gvom_tpu/io/rosbag.py (each package reads the other's bags).

The reference ran live from `PointCloud2` + `Odometry` topics and was replayed
from rosbags (the reference's scripts/gvom_ros.py:82-109 and install.md); this
module reads those bags directly — no ROS installation, no `rosbags` pip
package — and pairs each cloud with the latest odometry at-or-before its
timestamp (the reference's `cb_odom` keeps only the latest pose,
gvom_ros.py:79-80).

Supports unchunked record streams and chunks with `none`/`bz2`/`lz4`
compression (lz4 via the pure-Python frame codec in io/lz4f.py when the
native lz4 package is absent).
Only the two message types the node consumes are deserialized; everything
else is skipped by connection type.

A minimal writer (`write_minimal_bag`) exists so the round-trip is testable
without ROS; it emits a valid unchunked record stream our reader and
`rosbag`'s own tools can index.
"""

from __future__ import annotations

import bz2
import struct
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from gvom_tpu_torch.io.logio import ScanLog
from gvom_tpu_torch.io.pointcloud2 import CloudSpec, PointField, pointcloud2_to_xyz

__all__ = [
    "BagMessage",
    "read_bag_messages",
    "bag_to_scanlog",
    "write_minimal_bag",
    "serialize_pointcloud2",
    "serialize_odometry",
]

_MAGIC = b"#ROSBAG V2.0\n"

# record op codes (rosbag/Format — v2.0)
_OP_MSG = 0x02
_OP_BAGHDR = 0x03
_OP_INDEX = 0x04
_OP_CHUNK = 0x05
_OP_CHUNKINFO = 0x06
_OP_CONN = 0x07

_u32 = struct.Struct("<I")
_u64 = struct.Struct("<Q")


# ----------------------------------------------------------------------
# low-level record stream


def _parse_header(buf: bytes) -> Dict[str, bytes]:
    fields: Dict[str, bytes] = {}
    off = 0
    while off < len(buf):
        (flen,) = _u32.unpack_from(buf, off)
        off += 4
        fld = buf[off : off + flen]
        off += flen
        eq = fld.index(b"=")
        fields[fld[:eq].decode()] = fld[eq + 1 :]
    return fields


def _iter_records(buf: bytes, off: int = 0) -> Iterator[Tuple[Dict[str, bytes], bytes]]:
    end = len(buf)
    while off + 8 <= end:
        (hlen,) = _u32.unpack_from(buf, off)
        off += 4
        header = _parse_header(buf[off : off + hlen])
        off += hlen
        (dlen,) = _u32.unpack_from(buf, off)
        off += 4
        data = buf[off : off + dlen]
        off += dlen
        yield header, data


@dataclass
class _Connection:
    conn_id: int
    topic: str
    msg_type: str


@dataclass
class BagMessage:
    topic: str
    msg_type: str
    stamp: float          # record receive time, seconds
    raw: bytes            # ROS1-serialized message body


def read_bag_messages(path: str, topics: Optional[Sequence[str]] = None) -> List[BagMessage]:
    """All message records of a bag (optionally filtered by topic), in file
    order. Chunked (none/bz2) and unchunked streams both work."""
    with open(path, "rb") as f:
        buf = f.read()
    if not buf.startswith(_MAGIC):
        raise ValueError(f"{path}: not a rosbag v2.0 file")

    conns: Dict[int, _Connection] = {}
    out: List[BagMessage] = []

    def consume(records: Iterator[Tuple[Dict[str, bytes], bytes]]):
        for header, data in records:
            op = header.get("op", b"\x00")[0]
            if op == _OP_CONN:
                (cid,) = _u32.unpack(header["conn"])
                cheader = _parse_header(data)
                conns[cid] = _Connection(
                    conn_id=cid,
                    topic=header.get("topic", cheader.get("topic", b"")).decode(),
                    msg_type=cheader.get("type", b"").decode(),
                )
            elif op == _OP_MSG:
                (cid,) = _u32.unpack(header["conn"])
                secs, nsecs = struct.unpack("<II", header["time"])
                conn = conns.get(cid)
                if conn is None:
                    continue
                if topics is not None and conn.topic not in topics:
                    continue
                out.append(BagMessage(conn.topic, conn.msg_type, secs + nsecs * 1e-9, data))
            elif op == _OP_CHUNK:
                comp = header.get("compression", b"none").decode()
                if comp == "none":
                    payload = data
                elif comp == "bz2":
                    payload = bz2.decompress(data)
                elif comp == "lz4":
                    # roslz4 writes standard LZ4 frames; prefer the native
                    # lz4 package when present, else the pure-Python codec
                    try:
                        import lz4.frame  # type: ignore

                        payload = lz4.frame.decompress(data)
                    except ImportError:
                        from gvom_tpu_torch.io import lz4f

                        payload = lz4f.decompress(data)
                else:
                    raise ValueError(f"{path}: unknown chunk compression {comp!r}")
                consume(_iter_records(payload))
            # _OP_BAGHDR / _OP_INDEX / _OP_CHUNKINFO: metadata, skipped

    consume(_iter_records(buf, len(_MAGIC)))
    return out


# ----------------------------------------------------------------------
# ROS1 message deserialization (little-endian wire format)


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.off = 0

    def u8(self) -> int:
        v = self.buf[self.off]
        self.off += 1
        return v

    def u32(self) -> int:
        (v,) = _u32.unpack_from(self.buf, self.off)
        self.off += 4
        return v

    def f64(self) -> float:
        (v,) = struct.unpack_from("<d", self.buf, self.off)
        self.off += 8
        return v

    def string(self) -> str:
        n = self.u32()
        s = self.buf[self.off : self.off + n].decode(errors="replace")
        self.off += n
        return s

    def skip(self, n: int) -> None:
        self.off += n

    def ros_header(self) -> float:
        self.u32()                      # seq
        secs, nsecs = self.u32(), self.u32()
        self.string()                   # frame_id
        return secs + nsecs * 1e-9


def parse_pointcloud2(raw: bytes) -> Tuple[float, np.ndarray]:
    """sensor_msgs/PointCloud2 → (header stamp, [N,3] xyz f32)."""
    r = _Reader(raw)
    stamp = r.ros_header()
    height, width = r.u32(), r.u32()
    nf = r.u32()
    fields = []
    for _ in range(nf):
        name = r.string()
        offset, datatype, count = r.u32(), r.u8(), r.u32()
        fields.append(PointField(name, offset, datatype, count))
    is_bigendian = bool(r.u8())
    point_step, _row_step = r.u32(), r.u32()
    dlen = r.u32()
    data = r.buf[r.off : r.off + dlen]
    spec = CloudSpec(
        fields=fields, point_step=point_step, width=width, height=height,
        is_bigendian=is_bigendian,
    )
    return stamp, pointcloud2_to_xyz(bytes(data), spec)


def parse_odometry(raw: bytes) -> Tuple[float, np.ndarray]:
    """nav_msgs/Odometry → (header stamp, [3] position f64)."""
    r = _Reader(raw)
    stamp = r.ros_header()
    r.string()                          # child_frame_id
    pos = np.array([r.f64(), r.f64(), r.f64()])
    return stamp, pos


# ----------------------------------------------------------------------
# converter


def bag_to_scanlog(
    path: str,
    cloud_topic: Optional[str] = None,
    odom_topic: Optional[str] = None,
    transform: Optional[np.ndarray] = None,
    max_scans: Optional[int] = None,
) -> ScanLog:
    """Pair each PointCloud2 with the latest Odometry at-or-before it.

    Topics default to the (unique) topic of each message type; ambiguity is
    an error naming the candidates. `transform` (optional 3×4/4×4 sensor→odom
    matrix) is attached to every entry — bags whose clouds are already in the
    odom frame need none. Clouds seen before any odometry are dropped, as the
    reference does ("no odom", gvom_ros.py:85-87)."""
    msgs = read_bag_messages(path)

    def pick(topic: Optional[str], ros_type: str, kind: str) -> str:
        if topic is not None:
            return topic
        cands = sorted({m.topic for m in msgs if m.msg_type == ros_type})
        if len(cands) != 1:
            raise ValueError(
                f"{path}: need an explicit {kind} topic; {ros_type} found on {cands}"
            )
        return cands[0]

    cloud_topic = pick(cloud_topic, "sensor_msgs/PointCloud2", "cloud")
    odom_topic = pick(odom_topic, "nav_msgs/Odometry", "odom")

    odoms: List[Tuple[float, np.ndarray]] = []
    for m in msgs:
        if m.topic == odom_topic:
            odoms.append(parse_odometry(m.raw))
    odoms.sort(key=lambda t: t[0])
    otimes = np.array([t for t, _ in odoms]) if odoms else np.empty((0,))

    entries = []
    for m in msgs:
        if m.topic != cloud_topic:
            continue
        stamp, xyz = parse_pointcloud2(m.raw)
        i = int(np.searchsorted(otimes, stamp, side="right")) - 1
        if i < 0:
            continue                    # no odom yet → reference drops the scan
        entries.append((xyz, odoms[i][1], transform))
        if max_scans is not None and len(entries) >= max_scans:
            break
    return ScanLog(entries)


# ----------------------------------------------------------------------
# minimal writer (tests / tooling)


def _header_bytes(fields: Dict[str, bytes]) -> bytes:
    parts = []
    for k, v in fields.items():
        fld = k.encode() + b"=" + v
        parts.append(_u32.pack(len(fld)) + fld)
    return b"".join(parts)


def _record(fields: Dict[str, bytes], data: bytes) -> bytes:
    h = _header_bytes(fields)
    return _u32.pack(len(h)) + h + _u32.pack(len(data)) + data


def serialize_pointcloud2(xyz: np.ndarray, stamp: float, frame_id: str = "lidar") -> bytes:
    """ROS1-serialize an [N,3] f32 cloud as a dense x/y/z PointCloud2."""
    xyz = np.ascontiguousarray(np.asarray(xyz, np.float32))
    secs, nsecs = int(stamp), int((stamp - int(stamp)) * 1e9)
    w = struct.pack
    out = [w("<III", 0, secs, nsecs), _u32.pack(len(frame_id)), frame_id.encode()]
    out.append(w("<II", 1, xyz.shape[0]))            # height, width
    out.append(_u32.pack(3))                          # 3 fields
    for i, name in enumerate((b"x", b"y", b"z")):
        out.append(_u32.pack(len(name)) + name)
        out.append(w("<IBI", 4 * i, 7, 1))            # offset, FLOAT32, count
    out.append(w("<B", 0))                            # is_bigendian
    out.append(w("<II", 12, 12 * xyz.shape[0]))       # point_step, row_step
    payload = xyz.tobytes()
    out.append(_u32.pack(len(payload)) + payload)
    out.append(w("<B", 1))                            # is_dense
    return b"".join(out)


def serialize_odometry(position: Sequence[float], stamp: float, frame_id: str = "odom") -> bytes:
    secs, nsecs = int(stamp), int((stamp - int(stamp)) * 1e9)
    w = struct.pack
    out = [w("<III", 0, secs, nsecs), _u32.pack(len(frame_id)), frame_id.encode()]
    out.append(_u32.pack(0))                          # child_frame_id ""
    x, y, z = (float(v) for v in position)
    out.append(w("<3d", x, y, z))                     # position
    out.append(w("<4d", 0.0, 0.0, 0.0, 1.0))          # orientation
    out.append(b"\x00" * (36 * 8))                    # pose covariance
    out.append(w("<6d", *([0.0] * 6)))                # twist
    out.append(b"\x00" * (36 * 8))                    # twist covariance
    return b"".join(out)


def write_minimal_bag(
    path: str,
    messages: Sequence[Tuple[str, str, float, bytes]],
    chunked: Optional[str] = None,
) -> str:
    """Write (topic, msg_type, stamp, raw) messages as a v2.0 bag.

    chunked=None emits a flat record stream; "none"/"bz2"/"lz4" wrap the
    connection+message records in a single chunk with that compression."""
    topics = sorted({(t, mt) for t, mt, _, _ in messages})
    conn_ids = {t: i for i, (t, _) in enumerate(topics)}

    body = b""
    for topic, msg_type in topics:
        cid = conn_ids[topic]
        cdata = _header_bytes(
            {
                "topic": topic.encode(),
                "type": msg_type.encode(),
                "md5sum": b"*",
                "message_definition": b"",
            }
        )
        body += _record(
            {"op": bytes([_OP_CONN]), "conn": _u32.pack(cid), "topic": topic.encode()},
            cdata,
        )
    for topic, _mt, stamp, raw in messages:
        secs, nsecs = int(stamp), int((stamp - int(stamp)) * 1e9)
        body += _record(
            {
                "op": bytes([_OP_MSG]),
                "conn": _u32.pack(conn_ids[topic]),
                "time": struct.pack("<II", secs, nsecs),
            },
            raw,
        )

    if chunked is not None:
        if chunked == "none":
            payload = body
        elif chunked == "bz2":
            payload = bz2.compress(body)
        elif chunked == "lz4":
            from gvom_tpu_torch.io import lz4f

            payload = lz4f.compress(body)
        else:
            raise ValueError(f"unknown chunk compression {chunked!r}")
        body = _record(
            {
                "op": bytes([_OP_CHUNK]),
                "compression": chunked.encode(),
                "size": _u32.pack(len(body)),
            },
            payload,
        )

    baghdr = _record(
        {
            "op": bytes([_OP_BAGHDR]),
            "index_pos": _u64.pack(0),
            "conn_count": _u32.pack(len(topics)),
            "chunk_count": _u32.pack(1 if chunked else 0),
        },
        b" " * 4096,                    # standard bag-header padding
    )
    with open(path, "wb") as f:
        f.write(_MAGIC + baghdr + body)
    return path
