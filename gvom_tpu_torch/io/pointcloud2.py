"""PointCloud2 deserialization (host side); the port's copy of
gvom_tpu/io/pointcloud2.py.

The reference leans on ros_numpy for PointCloud2 → xyz (gvom_ros.py:108).
This module implements the wire format directly so the engine has no ROS
dependency: a NumPy strided path, plus a native C extractor
(gvom_tpu_torch/csrc/pointcloud.c, built with `cc` into
gvom_tpu_torch/_build/ at first use and loaded with ctypes) for float32 and
float64 little-endian fields. `pointcloud2_to_xyz` takes the native path
when it is built and the layout allows it, the NumPy path otherwise;
`decode_path` says which one a layout takes.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from dataclasses import dataclass
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "PointField",
    "CloudSpec",
    "pointcloud2_to_xyz",
    "array_to_pointcloud2",
    "native_available",
    "decode_path",
]

# ROS sensor_msgs/PointField datatype codes
_DTYPES = {
    1: np.int8, 2: np.uint8, 3: np.int16, 4: np.uint16,
    5: np.int32, 6: np.uint32, 7: np.float32, 8: np.float64,
}

_PKG = Path(__file__).resolve().parent.parent
_SRC = _PKG / "csrc" / "pointcloud.c"
_CC_FLAGS = ["-O3", "-shared", "-fPIC"]


@dataclass
class PointField:
    name: str
    offset: int
    datatype: int
    count: int = 1


@dataclass
class CloudSpec:
    fields: Sequence[PointField]
    point_step: int
    width: int
    height: int = 1
    is_bigendian: bool = False

    def field(self, name: str) -> PointField:
        for f in self.fields:
            if f.name == name:
                return f
        raise KeyError(name)


@functools.lru_cache(maxsize=None)
def _load_native():
    """The native extractor, built on first use (a library named by a hash
    of its source and flags, written under a temporary name and renamed, so
    processes that build it together never load a torn file); None when no
    C compiler is available."""
    h = hashlib.sha256(_SRC.read_bytes() + " ".join(_CC_FLAGS).encode()).hexdigest()[:16]
    so = _PKG / "_build" / f"pointcloud-{h}.so"
    try:
        if not so.exists():
            so.parent.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            subprocess.run(["cc", *_CC_FLAGS, "-o", str(tmp), str(_SRC)], check=True, capture_output=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
    except (OSError, subprocess.CalledProcessError):
        return None
    lib.extract_xyz_f32.restype = ctypes.c_long
    lib.extract_xyz_f32.argtypes = [
        ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
        ctypes.c_long, ctypes.c_long, ctypes.c_long,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
    ]
    return lib


def native_available() -> bool:
    return _load_native() is not None


def _native_layout(spec: CloudSpec) -> bool:
    fx, fy, fz = spec.field("x"), spec.field("y"), spec.field("z")
    return fx.datatype == fy.datatype == fz.datatype and fx.datatype in (7, 8) and not spec.is_bigendian


def decode_path(spec: CloudSpec, use_native: Optional[bool] = None) -> str:
    """"native" or "numpy": the path pointcloud2_to_xyz takes for this
    layout and choice."""
    if use_native in (None, True) and _native_layout(spec) and native_available():
        return "native"
    return "numpy"


def pointcloud2_to_xyz(
    data: bytes,
    spec: CloudSpec,
    drop_nan: bool = True,
    use_native: Optional[bool] = None,
) -> np.ndarray:
    """Extract [N,3] float32 xyz from a PointCloud2 payload. use_native=True
    raises when the native path cannot take the layout, False forces the
    NumPy path, None picks (decode_path)."""
    fx, fy, fz = spec.field("x"), spec.field("y"), spec.field("z")
    n = spec.width * spec.height
    if len(data) < n * spec.point_step:
        raise ValueError(f"PointCloud2 payload of {len(data)} bytes, {n} points of {spec.point_step} need more")
    for f in (fx, fy, fz):
        if f.datatype not in _DTYPES or f.offset < 0 or \
                f.offset + np.dtype(_DTYPES[f.datatype]).itemsize > spec.point_step:
            raise ValueError(f"PointCloud2 field {f.name!r} (offset {f.offset}, datatype {f.datatype}) "
                             f"does not fit a point of {spec.point_step} bytes")

    if decode_path(spec, use_native) == "native":
        out = np.empty((n, 3), np.float32)
        kept = _load_native().extract_xyz_f32(
            data, n, spec.point_step, fx.offset, fy.offset, fz.offset,
            int(fx.datatype), int(drop_nan),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        )
        return out[:kept]
    if use_native is True:
        raise RuntimeError("native extractor unavailable for this layout")

    # NumPy strided path: view each column with its own stride
    buf = np.frombuffer(data, dtype=np.uint8, count=n * spec.point_step)
    cols = []
    for f in (fx, fy, fz):
        dt = np.dtype(_DTYPES[f.datatype])
        if spec.is_bigendian:
            dt = dt.newbyteorder(">")
        raw = np.ndarray((n,), dtype=dt, buffer=buf, offset=f.offset, strides=(spec.point_step,))
        cols.append(raw.astype(np.float32))
    xyz = np.stack(cols, axis=1)
    if drop_nan:
        xyz = xyz[np.isfinite(xyz).all(axis=1)]
    return np.ascontiguousarray(xyz)


def array_to_pointcloud2(
    arr: np.ndarray, names: Sequence[str]
) -> Tuple[bytes, CloudSpec]:
    """Encode an [N, K] float32 array as PointCloud2 wire data — the inverse
    of pointcloud2_to_xyz, with the dense all-float32 layout ros_numpy's
    array_to_pointcloud2 produces for the reference's debug clouds
    (gvom_ros.py:170-189): field k at offset 4k, point_step 4K."""
    arr = np.ascontiguousarray(np.asarray(arr, np.float32))
    if arr.ndim != 2 or arr.shape[1] != len(names):
        raise ValueError(f"need [N, {len(names)}] array, got {arr.shape}")
    fields = [PointField(name, 4 * k, 7) for k, name in enumerate(names)]
    spec = CloudSpec(fields=fields, point_step=4 * len(names), width=arr.shape[0])
    return arr.tobytes(), spec
