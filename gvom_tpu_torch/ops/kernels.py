"""The hand-written CUDA kernels of the port: loader, build and wrappers.

Each kernel is one source under gvom_tpu_torch/csrc/, compiled at first use
for sm_90a with nvcc into its own shared library under gvom_tpu_torch/_build/
(named by a hash of the source and flags, so an edited source rebuilds), and
called through ctypes with a plain C interface: device pointers and PyTorch's
current stream as c_void_p, sizes as c_int. Each C entry returns
cudaGetLastError() and the wrapper raises if it is not 0.

Every wrapper checks dtype, shape, device and contiguity, takes the kernel's
plain PyTorch twin only for tensors on the CPU, launches the kernel for CUDA
tensors (there is no fallback), and counts its launches in `launches`.

| wrapper            | source       | replaces (gvom_tpu/ops/pallas_kernels.py) | plain twin                         |
|--------------------|--------------|-------------------------------------------|------------------------------------|
| prepare_points     | prepare.cu   | none: the port's own (the JAX package's   | binning.prepare_plain              |
|                    |              | point preparation in XLA, ops/binning.py: |                                    |
|                    |              | 47-69, models/pipeline.py:209-213,        |                                    |
|                    |              | parallel/sharding.py:193-202)             |                                    |
| ray_pass_counts    | raycast.cu   | _run_hist and _run_hist_steppair, via     | raycast.pass_counts_plain (per     |
|                    |              | ray_pass_counts_matmul                    | scan: march_inputs, then           |
|                    |              |                                           | ray_pass_counts_plain)             |
| ray_march_stats    | raycast.cu   | none: K1 with its march schedule counted  | raycast.march_stats_plain          |
|                    |              | (lane utilisation, atomics), off the path |                                    |
| bin_points         | binning.cu   | fused_point_moments                       | binning.bin_points                 |
| ingest_epilogue    | epilogue.cu  | _xbox_epilogue_into                       | moments.ingest_epilogue_plain      |
| combine            | combine.cu   | fused_combine (+ the XLA mom merge)       | models.pipeline.fuse_plain         |
| moments_epilogue   | epilogue.cu  | _xbox_epilogue                            | moments.moments_epilogue_plain     |
| point_moments      | (K2 then K5) | fused_point_moments' contract             | moments.point_moments              |
| plane_fit          | planefit.cu  | none: the port's own (the JAX package's   | maps2d.plane_fit_window_plain      |
|                    |              | torus_to_window of the height maps and    | (maps_to_window_plain, then        |
|                    |              | 3×3 plane fit in XLA, ops/maps2d.py:129)  | plane_fit_plain)                   |
| plane_fit_tail     | planefit.cu  | none: the fit's tail alone (log, atan2),  | maps2d.plane_fit_tail_plain        |
|                    |              | off the map path (a sweep of its domain)  |                                    |
| guess_height       | guess.cu     | none: the port's own (the JAX package's   | maps2d.guess_products_plain        |
|                    |              | guess-height search in XLA, :201, and the | (guess_height_plain, then          |
|                    |              | obstacle maps and visibility after it,    | map_products_plain)                |
|                    |              | models/pipeline.py:380-389, :442-458)     |                                    |
| merge_batch        | merge.cu     | none: the port's own (the batched step's  | sharding.merge_and_columns_plain   |
|                    |              | merge and column maps in XLA,             | (merge_batch_plain, then the       |
|                    |              | parallel/sharding.py:264-328)             | column maps)                       |

prepare_points turns S scans of raw points into what the kernels after it
take: world-frame points, keep, the origin and each scan's scan_ok, in one
launch (the batched step's dead-scan mask too). ray_pass_counts takes
what the JAX function takes: world-frame points [S, N, 3], keep [S, N], one
ego per scan [S, 3] and one origin; it builds the ray geometry itself and
marches all S scans in one launch (S = 1 is one scan). bin_points takes
world-frame points too and computes their map-local coordinates itself; it
leaves channels 1-9 of the sums in a binning.MomentScratch that the caller
keeps across calls, and ingest_epilogue and moments_epilogue read them there.
ray_pass_counts, bin_points and moments_epilogue take y_window = (ys0, Ys),
the slab forms: the same kernels restricted to the torus rows
[ys0, ys0+Ys). A slab launch is counted by an entry of its own (RAY_SLAB,
BIN_SLAB, XBOX_SLAB), so a run shows which form the path went through.
merge_batch merges the batched step's contribution with the old world and
takes the merged world's column maps. After K4 or merge_batch the 2-D maps
are two launches: plane_fit moves the column maps to the window layout as
it loads them, and guess_height writes the positive and negative obstacles
and the visibility as its epilogue. combine.cu and merge.cu share the
column tail of columns.cuh.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import binning, maps2d, moments, raycast
from gvom_tpu_torch.ops import grid as gridops
from gvom_tpu_torch.ops.maps2d import f32_square, f32_value
from gvom_tpu_torch.types import UNKNOWN_HEIGHT, VoxelGrid
from gvom_tpu_torch.utils import profiling

__all__ = [
    "CudaKernel",
    "KERNELS",
    "build_all",
    "check_card_limits",
    "check_batch",
    "reset_launches",
    "prepare_points",
    "ray_pass_counts",
    "ray_window",
    "ray_march_stats",
    "bin_points",
    "ingest_epilogue",
    "combine",
    "combine_launch",
    "moments_epilogue",
    "epilogue_route",
    "point_moments",
    "plane_fit",
    "plane_fit_tail",
    "guess_height",
    "merge_batch",
    "NVCC_FLAGS",
]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def _nvcc() -> str:
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels are built at first use")
    return found


class CudaKernel:
    """One kernel: its source, its C entry, its builds and its launch count.
    A build is the source compiled with a set of -D flags, in a library of
    its own; `defines` is the set that build_all builds up front. While
    spans record (utils/profiling.py), each launch's ctypes call is the
    span `kernel/<name>`."""

    def __init__(self, name: str, source: str, entry: str, argtypes: list, replaces: str,
                 defines: Sequence[str] = ()):
        self.name = name
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = argtypes
        self.replaces = replaces
        self.defines = tuple(defines)
        self.launches = 0
        self.span = "kernel/" + name
        self._fns = {}

    def _defines(self, defines: Optional[Sequence[str]]) -> tuple:
        return self.defines if defines is None else tuple(defines)

    def library(self, defines: Optional[Sequence[str]] = None) -> Path:
        """The library of this source and -D set, named by a hash of the
        source, the headers it includes from its own directory and the
        flags, so that an edit of any of them builds anew."""
        flags = NVCC_FLAGS + list(self._defines(defines))
        text = self.source.read_bytes()
        headers = re.findall(rb'^\s*#include\s+"([^"]+)"', text, re.M)
        h = hashlib.sha256(b"".join([text, *((self.source.parent / n.decode()).read_bytes() for n in headers),
                                     " ".join(flags).encode()])).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{h}.so"

    def start_build(self, defines: Optional[Sequence[str]] = None) -> Optional[subprocess.Popen]:
        """Start nvcc for this source unless its library exists; returns the
        process (its output is the ptxas report) or None."""
        d = self._defines(defines)
        lib = self.library(d)
        if lib.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.{id(self)}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, *d, "-o", str(tmp), str(self.source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        proc.library = lib
        return proc

    def finish_build(self, proc: Optional[subprocess.Popen]) -> str:
        if proc is None:
            return ""
        out, _ = proc.communicate()
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{out}")
        os.replace(tmp, proc.library)
        return out

    def fn(self, defines: Optional[Sequence[str]] = None):
        d = self._defines(defines)
        if d not in self._fns:
            self.finish_build(self.start_build(d))
            f = getattr(ctypes.CDLL(str(self.library(d))), self.entry)
            f.argtypes = self.argtypes
            f.restype = ctypes.c_int
            self._fns[d] = f
        return self._fns[d]

    def launch(self, *args, defines: Optional[Sequence[str]] = None) -> None:
        fn = self.fn(defines)
        if profiling.recording():
            t0 = time.perf_counter_ns()
            rc = fn(*args)
            profiling.record(self.span, t0, time.perf_counter_ns())
        else:
            rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: cudaError {rc}")
        self.launches += 1


_PK = "gvom_tpu/ops/pallas_kernels.py"
_RAY_ARGS = ("raycast.cu", "gvom_ray_pass_counts", [_P] * 4 + [_F] * 2 + [_I] * 9 + [_P, _P])
_BIN_ARGS = ("binning.cu", "gvom_bin_points", [_P] * 3 + [_F] * 2 + [_I] * 9 + [_P] * 6)
_EPI_ARGS = ("epilogue.cu", "gvom_moments_epilogue", [_P] * 5 + [_I] * 9 + [_P] * 3)

# the point preparation: no TPU kernel, the JAX package computes it in XLA
PREP = CudaKernel("prepare_points", "prepare.cu", "gvom_prepare_points",
                  [_P] * 6 + [_F] * 3 + [_I] * 7 + [_P] * 6,
                  "none: the port's own (gvom_tpu/ops/binning.py:47-69, gvom_tpu/models/pipeline.py:209-213, "
                  "gvom_tpu/parallel/sharding.py:193-202: the point preparation in XLA)")
RAY = CudaKernel(
    "ray_pass_counts", *_RAY_ARGS,
    f"{_PK}:335 (_run_hist, via ray_pass_counts_matmul :510) and {_PK}:478 (_run_hist_steppair)")
BIN = CudaKernel("bin_points", *_BIN_ARGS, f"{_PK}:1510 (fused_point_moments)")
EPI = CudaKernel("ingest_epilogue", *_EPI_ARGS, f"{_PK}:1459 (_xbox_epilogue_into)")
# K4 unrolls its slot loops: one library per ring-buffer depth B up to
# CMB_MAX_B, the upstream B = 4 built by build_all(), another by
# build_all(cfg) (the Gvom facade calls it when it is made on the card) or at
# first use. Every library also holds the grouped form (slots in groups a
# runtime loop takes), which takes any deeper buffer, and any z_size past 256
CMB_MAX_B = 16
CMB = CudaKernel(
    "combine", "combine.cu", "gvom_combine",
    [_P] * 11 + [_I] * 4 + [_F] * 8 + [_I] * 2 + [_P] * 11,
    f"{_PK}:1883 (fused_combine) + gvom_tpu/models/pipeline.py:420 (mom merge)", defines=("-DGVOM_COMBINE_B=4",))
XBOX = CudaKernel("moments_epilogue", *_EPI_ARGS, f"{_PK}:1310 (_xbox_epilogue)")
RAY_SLAB = CudaKernel("ray_pass_counts_slab", *_RAY_ARGS,
                      f"{_PK}:725 (ray_pass_counts_matmul(y_window=), the slab form of _run_hist)")
# K1's body with its schedule counted: off every path, so not in KERNELS
# (its library is K1's)
MARCH_STATS = CudaKernel("ray_march_stats", "raycast.cu", "gvom_ray_march_stats",
                         [_P] * 4 + [_F] * 2 + [_I] * 10 + [_P] * 3,
                         "none: K1's march with its schedule counted (raycast.march_stats_plain), off every path")
BIN_SLAB = CudaKernel("bin_points_slab", *_BIN_ARGS,
                      f"{_PK}:1559 (fused_point_moments(y_window=), the slab prefilter)")
XBOX_SLAB = CudaKernel("moments_epilogue_slab", *_EPI_ARGS,
                       f"{_PK}:1540 (fused_point_moments(y_window=) → _xbox_epilogue with U = Ys)")

# the 2-D maps' stencils: no TPU kernel, the JAX package computes them in XLA
_M2 = "gvom_tpu/ops/maps2d.py"
PLANEFIT = CudaKernel("plane_fit", "planefit.cu", "gvom_plane_fit", [_P] * 3 + [_I, _I, _F, _F] + [_P] * 6,
                      f"none: the port's own ({_M2}:129-179, the 3×3 plane fit in XLA, and "
                      "gvom_tpu/models/pipeline.py:382-383, torus_to_window of the height maps)")
PLANEFIT_TAIL = CudaKernel("plane_fit_tail", "planefit.cu", "gvom_plane_fit_tail", [_P] * 5 + [_I] + [_P] * 4,
                           f"none: the port's own ({_M2}:175-178, jnp.log and jnp.arctan2 in XLA)")
GUESS = CudaKernel("guess_height", "guess.cu", "gvom_guess_height", [_P] * 8 + [_I, _I] + [_F] * 3 + [_P] * 5,
                   f"none: the port's own ({_M2}:201-282, the guess-height search in XLA, and "
                   "gvom_tpu/models/pipeline.py:386-389, :442-458, the obstacle maps and the visibility)")

# the batched step's merge: no TPU kernel, XLA in the JAX package
MERGE = CudaKernel("merge_batch", "merge.cu", "gvom_merge_batch",
                   [_P] * 13 + [_I] * 5 + [_F] * 8 + [_I] * 2 + [_P] * 4,
                   "none: the port's own (gvom_tpu/parallel/sharding.py:264-328, the batched merge and the "
                   "column maps in XLA)")

KERNELS: List[CudaKernel] = [RAY, BIN, EPI, CMB, XBOX, RAY_SLAB, BIN_SLAB, XBOX_SLAB, PLANEFIT, PLANEFIT_TAIL,
                             GUESS, PREP, MERGE]


def build_all(cfg: Optional[GvomConfig] = None) -> Dict[str, str]:
    """Build every kernel library that is missing, one nvcc per library, all
    started together. With cfg, K4's library for cfg.buffer_size is built as
    well, so that no combine of that configuration waits for nvcc. Returns
    each kernel's compiler report (kernels that share a source share its
    report; K4's is that of its up-front depth)."""
    builds = {(k.source, k.defines): k for k in KERNELS}
    if cfg is not None:
        builds.setdefault((CMB.source, _combine_defines(cfg)), CMB)
    procs = {key: k.start_build(key[1]) for key, k in builds.items()}
    reports = {key: k.finish_build(procs[key]) for key, k in builds.items()}
    return {k.name: reports[(k.source, k.defines)] for k in KERNELS}


def check_card_limits(cfg: GvomConfig, slab: bool = False) -> None:
    """Raise ValueError naming the limit when cfg is past what the kernels'
    int32 indexing takes: the grid's X·Y·Z voxels and K2's padded moment
    scratch (X+2rx)·(Y+2ry)·(Z+2rz), or with `slab` the slab scratch's
    Y + 4ry rows, below 2^31 - 1. The entry points call it when they are
    made on the card, before any state is allocated; the plain versions on
    the CPU have no such limit. A batch's scans are checked by the batched
    step when it gets them (check_batch)."""
    X, Y, Z = cfg.grid_shape
    rx, ry, rz = binning.moment_pad(cfg)
    if X * Y * Z >= INT32_LIMIT:
        raise ValueError(f"grid {X}x{Y}x{Z} has {X * Y * Z} voxels; the CUDA kernels index them in int32, "
                         f"below {INT32_LIMIT}")
    padded = (X + 2 * rx) * (Y + (4 if slab else 2) * ry) * (Z + 2 * rz)
    if padded >= INT32_LIMIT:
        raise ValueError(f"the moment scratch of grid {X}x{Y}x{Z} at eigen distances ({cfg.xy_eigen_dist}, "
                         f"{cfg.z_eigen_dist}) has {padded} cells; K2 indexes it in int32, below {INT32_LIMIT}")


def check_batch(S: int, N: int) -> None:
    """Raise ValueError when a batch of S scans of N points is past what the
    kernels take: S scans in one raycast launch (a grid's y dimension, at
    most RAY_MAX_SCANS) and S·N points in one K2 launch (int32)."""
    if S > RAY_MAX_SCANS:
        raise ValueError(f"a batch of {S} scans; one raycast launch takes at most {RAY_MAX_SCANS}")
    if S * N >= INT32_LIMIT:
        raise ValueError(f"a batch of {S} scans of {N} points; K2 indexes the points in int32, below {INT32_LIMIT}")


INT32_LIMIT = 2 ** 31 - 1
RAY_MAX_SCANS = 65535


def reset_launches() -> None:
    for k in KERNELS:
        k.launches = 0


# ----------------------------------------------------------------------
# checks


def _is_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type != "cuda":
        raise ValueError(f"tensors must be on the CPU or a CUDA device, got {t.device}")
    return False


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise ValueError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _stream() -> int:
    """PyTorch's current stream, as the int that ctypes passes as c_void_p."""
    return torch.cuda.current_stream().cuda_stream


def _ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def _column_consts(cfg: GvomConfig) -> tuple:
    """The f32 constants and the two integer ones of columns.cuh's column
    tail and the merges (K4, merge_batch), in their C argument order."""
    inv_z = float(torch.reciprocal(torch.tensor(cfg.z_resolution, dtype=torch.float32)))
    return (f32_value(cfg.z_resolution), f32_value(cfg.xy_resolution), inv_z,
            f32_value(cfg.positive_obstacle_threshold), f32_value(cfg.robot_height), f32_square(cfg.robot_radius),
            f32_value(cfg.ground_to_lidar_height), UNKNOWN_HEIGHT, cfg.decay_miss_limit, cfg.hit_count_threshold)


# ----------------------------------------------------------------------
# the point preparation


def prepare_points(cfg: GvomConfig, points: torch.Tensor, valid: torch.Tensor, egos: torch.Tensor,
                   frame_ego: Optional[torch.Tensor] = None, origin: Optional[torch.Tensor] = None,
                   transform: Optional[torch.Tensor] = None, drop_dead: bool = False):
    """S scans' raw points [S,N,3] f32, valid [S,N] bool and egos [S,3] f32
    → (p [S,N,3] f32 world frame, keep [S,N] bool, origin [3] int32,
    scan_ok [S] bool), binning.prepare_plain's function, bitwise, in one
    launch.

    The origin is the pinned `origin` [3] int32 or that of `frame_ego` [3]
    f32, one of the two. `transform` [4,4] f32 maps the points to the world
    frame (without it p is `points` itself). drop_dead also takes the points
    of a scan with no kept endpoint in the window out of keep (the batched
    step)."""
    if points.ndim != 3:
        raise ValueError(f"points: shape {tuple(points.shape)}, expected [S, N, 3]")
    if (frame_ego is None) == (origin is None):
        raise ValueError("prepare_points: give frame_ego or a pinned origin, one of the two")
    S, n = points.shape[:2]
    dev = points.device
    _check("points", points, torch.float32, (S, n, 3), dev)
    _check("valid", valid, torch.bool, (S, n), dev)
    _check("egos", egos, torch.float32, (S, 3), dev)
    if frame_ego is not None:
        _check("frame_ego", frame_ego, torch.float32, (3,), dev)
    else:
        _check("origin", origin, torch.int32, (3,), dev)
    if transform is not None:
        _check("transform", transform, torch.float32, (4, 4), dev)
    if _is_cpu(points):
        return binning.prepare_plain(cfg, points, valid, egos, frame_ego, origin, transform, drop_dead)
    stream = _stream()
    p = points if transform is None else torch.empty_like(points)
    keep = torch.empty((S, n), dtype=torch.bool, device=dev)
    origin_out = torch.empty((3,), dtype=torch.int32, device=dev)
    scan_ok = torch.empty((S,), dtype=torch.bool, device=dev)
    PREP.launch(_ptr(points), _ptr(valid), _ptr(egos), None if frame_ego is None else _ptr(frame_ego),
                None if origin is None else _ptr(origin), None if transform is None else _ptr(transform),
                *_prep_consts(cfg), S, n, *cfg.grid_shape, int(drop_dead), None if transform is None else _ptr(p),
                _ptr(keep), _ptr(origin_out), _ptr(scan_ok), _ptr(_prep_workspace(dev, stream, S)), stream)
    return p, keep, origin_out, scan_ok


@functools.lru_cache(maxsize=None)
def _prep_consts(cfg: GvomConfig) -> tuple:
    """The preparation's constants of cfg in their C argument order: f32(1 /
    res) for xy and z, fl(min_distance)², ego_relative_min_distance."""
    inv = gridops.inv_resolution_vector(cfg, "cpu")
    md = torch.tensor(cfg.min_distance, dtype=torch.float32)
    return float(inv[0]), float(inv[2]), float(md * md), int(cfg.ego_relative_min_distance)


# the preparation's workspace a CUDA stream: each scan's ticket word, zeroed
# once here and reset by the kernel at the end of every call
_PREP_WORK: Dict[int, torch.Tensor] = {}


def _prep_workspace(dev, stream: int, S: int) -> torch.Tensor:
    """The workspace of the stream's preparations, at least S int32 words of
    zeros. One a stream, so that calls on two streams, which the card may
    run at once, never count into the same words; a call on a stream runs
    after the stream's last one, whose words it finds reset."""
    work = _PREP_WORK.get(stream)
    if work is None or work.numel() < S or work.device != dev:
        work = _PREP_WORK[stream] = torch.zeros((max(S, 32),), dtype=torch.int32, device=dev)
    return work


# ----------------------------------------------------------------------
# K1


def _ray_inputs(cfg: GvomConfig, points, keep, egos, origin, y_window, out):
    """K1's inputs checked, before the device: (S, n, ys0, Ys)."""
    if points.ndim != 3:
        raise ValueError(f"points: shape {tuple(points.shape)}, expected [S, N, 3]")
    S, n = points.shape[:2]
    dev = points.device
    X, Y, Z = cfg.grid_shape
    ys0, Ys = binning.check_y_window(cfg, y_window)
    _check("points", points, torch.float32, (S, n, 3), dev)
    _check("keep", keep, torch.bool, (S, n), dev)
    _check("egos", egos, torch.float32, (S, 3), dev)
    _check("origin", origin, torch.int32, (3,), dev)
    if out is not None:
        _check("out", out, torch.int32, (X, Ys, Z), dev)
    return S, n, ys0, Ys


# K1's sort window: 1,024 rays a block (four a thread) where a launch of
# such blocks still gives every SM this many, else 256
WIDE_BLOCKS_PER_SM = 8


def ray_window(S: int, n: int, sms: int) -> int:
    """The rays a block of K1 sorts by length and marches, from the launch's
    shape: 1,024 where S scans of n rays make at least WIDE_BLOCKS_PER_SM
    such blocks for each of the card's `sms` SMs, else 256, so that a small
    launch (one scan: 512 blocks of 256) leaves no SM idle."""
    return 1024 if S * -(-n // 1024) >= WIDE_BLOCKS_PER_SM * sms else 256


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _sms(dev: torch.device) -> int:
    return _sm_count(torch.cuda.current_device() if dev.index is None else dev.index)


def _ray_launch(k: CudaKernel, cfg: GvomConfig, points, keep, egos, origin, ys0: int, Ys: int, window: int,
                *tail) -> None:
    S, n = points.shape[:2]
    X, Y, Z = cfg.grid_shape
    inv = gridops.inv_resolution_vector(cfg, "cpu")
    k.launch(_ptr(points), _ptr(keep), _ptr(egos), _ptr(origin), float(inv[0]), float(inv[2]),
             S, n, cfg.ray_steps, X, Y, Z, ys0, Ys, window, *tail, _stream())


def ray_pass_counts(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, egos: torch.Tensor,
                    origin: torch.Tensor, y_window=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[X,Ys,Z] int32 pass counts in the torus layout of S scans: world-frame
    points [S,N,3] f32 (binning.prepare_points), keep [S,N] bool, each scan's
    ego [S,3] f32, one origin [3] int32. The kernel builds each ray's
    geometry itself and marches each block's rays sorted by length, in the
    window of ray_window. y_window = (ys0, Ys) gives only the torus rows
    [ys0, ys0+Ys) (the slab form); `out` is a grid to add the counts into,
    returned. Shapes, dtypes and contiguity are checked before the device."""
    S, n, ys0, Ys = _ray_inputs(cfg, points, keep, egos, origin, y_window, out)
    if _is_cpu(points):
        return raycast.pass_counts_plain(cfg, points, keep, egos, origin, y_window, out)
    if out is None:
        out = torch.zeros((cfg.xy_size, Ys, cfg.z_size), dtype=torch.int32, device=points.device)
    _ray_launch(RAY_SLAB if binning.is_slab(cfg, y_window) else RAY, cfg, points, keep, egos, origin, ys0, Ys,
                ray_window(S, n, _sms(points.device)), _ptr(out))
    return out


def ray_march_stats(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, egos: torch.Tensor,
                    origin: torch.Tensor, y_window=None, sort: bool = True, window: Optional[int] = None):
    """(passes [X,Ys,Z] int32, stats [3] int64): K1's march of
    ray_pass_counts' inputs, with its schedule counted: the live lane-steps
    (the march's iterations over all rays), the issued lane-steps (32 × each
    warp's iterations) and the atomics after the warp merge. The lane
    utilisation is stats[0] / stats[1]. sort=False marches each block's rays
    in launch order, as K1 did before it sorted them. `window` is the rays a
    block (256 or 1,024): on the card by default ray_window's; the CPU's plain
    twin (raycast.march_stats_plain) needs it given. Off every path."""
    S, n, ys0, Ys = _ray_inputs(cfg, points, keep, egos, origin, y_window, None)
    if window not in (None, 256, 1024):
        raise ValueError(f"window {window}: K1 takes 256 or 1024 rays a block")
    if _is_cpu(points):
        if window is None:
            raise ValueError("ray_march_stats on the CPU: give the window (256 or 1024 rays a block)")
        return (raycast.pass_counts_plain(cfg, points, keep, egos, origin, y_window),
                raycast.march_stats_plain(cfg, points, keep, egos, origin, y_window, window, sort))
    dev = points.device
    if window is None:
        window = ray_window(S, n, _sms(dev))
    out = torch.zeros((cfg.xy_size, Ys, cfg.z_size), dtype=torch.int32, device=dev)
    stats = torch.zeros(3, dtype=torch.int64, device=dev)
    _ray_launch(MARCH_STATS, cfg, points, keep, egos, origin, ys0, Ys, window, int(sort), _ptr(out), _ptr(stats))
    return out, stats


# ----------------------------------------------------------------------
# K2


def bin_points(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, origin: torch.Tensor, y_window=None,
               scratch: Optional[binning.MomentScratch] = None):
    """One point set's binning from its world-frame points [N,3] (the kernel
    computes the map-local coordinates): returns binning.PointBins (hit,
    min_height torus [X,Ys,Z]; own-voxel n padded [1, Xp, Yp, Zp], or the
    slab scratch [1, Xp, Ys+4ry, Zp] with y_window = (ys0, Ys), see
    binning.slab_rows; channels 1-9 in the scratch's rest, zero where n is
    0). `scratch` (binning.moment_scratch of this shape) is kept across the
    caller's calls, which run in order on one stream; without one, a fresh
    one is made with zeros."""
    if _is_cpu(points):
        return binning.bin_points(cfg, points, keep, origin, y_window, scratch)
    dev = points.device
    n = points.shape[0]
    _check("points", points, torch.float32, (n, 3), dev)
    _check("keep", keep, torch.bool, (n,), dev)
    _check("origin", origin, torch.int32, (3,), dev)
    X, Y, Z = cfg.grid_shape
    rx, ry, rz = binning.moment_pad(cfg)
    ys0, Ys = binning.check_y_window(cfg, y_window)
    shape = binning.padded_shape(cfg, y_window)
    if scratch is None:
        scratch = binning.moment_scratch(cfg, dev, y_window)
    _check("scratch rest", scratch.rest, torch.float32, (9,) + shape, dev)
    _check("scratch touched", scratch.touched, torch.uint8, shape, dev)
    # the kernel sets hit, min_height and n, and channels 1-9 in the scratch
    hit = torch.empty((X, Ys, Z), dtype=torch.int32, device=dev)
    minh = torch.empty((X, Ys, Z), dtype=torch.float32, device=dev)
    cnt = torch.empty((1,) + shape, dtype=torch.float32, device=dev)
    inv = gridops.inv_resolution_vector(cfg, "cpu")
    (BIN_SLAB if binning.is_slab(cfg, y_window) else BIN).launch(
        _ptr(points), _ptr(keep), _ptr(origin), float(inv[0]), float(inv[2]), n, X, Y, Z, rx, ry, rz, ys0, Ys,
        _ptr(hit), _ptr(minh), _ptr(cnt), _ptr(scratch.rest), _ptr(scratch.touched), _stream())
    return binning.PointBins(hit=hit, min_height=minh, n=cnt, rest=scratch.rest)


# ----------------------------------------------------------------------
# K3


def ingest_epilogue(cfg: GvomConfig, n: torch.Tensor, rest: torch.Tensor, hit: torch.Tensor, origin: torch.Tensor,
                    out: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Box-aggregate, crop and occupancy-mask one scan's moments (K2's
    sums: n and channels 1-9, binning.PointBins) and write them into
    out[slot] ([S, 10, X, Y, Z], torus); slot is a device int32 tensor of
    one element. Returns out."""
    if _is_cpu(n):
        return moments.ingest_epilogue_plain(cfg, n, rest, hit, origin, out, slot)
    dev = n.device
    X, Y, Z = cfg.grid_shape
    rx, ry, rz = binning.moment_pad(cfg)
    shape = binning.padded_shape(cfg)
    _check("n", n, torch.float32, (1,) + shape, dev)
    _check("rest", rest, torch.float32, (9,) + shape, dev)
    _check("hit", hit, torch.int32, (X, Y, Z), dev)
    _check("origin", origin, torch.int32, (3,), dev)
    _check("out", out, torch.float32, (out.shape[0], 10, X, Y, Z), dev)
    _check("slot", slot.reshape(1), torch.int32, (1,), dev)
    work = _epilogue_workspace(EPI, X, Y, Z, rx, ry, rz, 0, Y, True, dev)
    EPI.launch(_ptr(n), _ptr(rest), _ptr(hit), _ptr(origin), _ptr(slot), X, Y, Z, rx, ry, rz, 0, Y, 1,
               _ptr(out), work if work is None else _ptr(work), _stream())
    return out


_EPI_WORK: Dict[tuple, int] = {}


def _epilogue_workspace(k: CudaKernel, X: int, Y: int, Z: int, rx: int, ry: int, rz: int, ys0: int, Ys: int,
                        mask: bool, dev):
    """The workspace of an epilogue launch: None where epilogue.cu takes its
    tiled kernel, else a fresh float32 tensor for its separable passes (the
    library answers which, once a shape). The caller holds it until the
    launch is enqueued; the allocator reuses it only in this stream's order."""
    key = (id(k), X, Y, Z, rx, ry, rz, ys0, Ys, mask)
    if key not in _EPI_WORK:
        k.fn()   # the library built before it is opened
        fn = getattr(ctypes.CDLL(str(k.library())), "gvom_moments_epilogue_workspace")
        fn.argtypes, fn.restype = [_I] * 9, ctypes.c_int64
        n = fn(*key[1:9], int(mask))
        if n < 0:
            raise RuntimeError(f"CUDA kernel {k.name}: the route query failed: cudaError {-n}")
        _EPI_WORK[key] = n
    n = _EPI_WORK[key]
    return torch.empty((n,), dtype=torch.float32, device=dev) if n else None


# the kernels of epilogue.cu, by the number its route query answers
EPILOGUE_ROUTES = ("tiled", "separable", "direct")


def epilogue_route(cfg: GvomConfig, y_window=None, occupancy_mask: bool = True) -> str:
    """Which kernel of epilogue.cu takes this shape on the current card: its
    tiled kernel (the upstream box), the separable passes (any other box,
    bitwise the plain twin) or the direct kernel (within the f32 summation
    bound of the twin): with the mask on at a box of at most 297 voxels,
    and wherever the passes' smallest tile or grid does not fit the card
    (max(xy_eigen_dist) past 1452 on an H100)."""
    X, Y, Z = cfg.grid_shape
    rx, ry, rz = binning.moment_pad(cfg)
    ys0, Ys = binning.check_y_window(cfg, y_window)
    XBOX.fn()   # the library built before it is opened
    fn = getattr(ctypes.CDLL(str(XBOX.library())), "gvom_moments_epilogue_route")
    fn.argtypes, fn.restype = [_I] * 9, _I
    rc = fn(X, Y, Z, rx, ry, rz, ys0, Ys, int(occupancy_mask))
    if rc < 0:
        raise RuntimeError(f"CUDA kernel {XBOX.name}: the route query failed: cudaError {-rc}")
    return EPILOGUE_ROUTES[rc]


# ----------------------------------------------------------------------
# K5


def moments_epilogue(cfg: GvomConfig, n: torch.Tensor, rest: torch.Tensor, hit: torch.Tensor, origin: torch.Tensor,
                     y_window=None, occupancy_mask: bool = True) -> torch.Tensor:
    """Box-aggregate and crop a point set's own-voxel sums (K2's: n
    [1, ...] and channels 1-9 [9, ...], binning.PointBins) into a fresh
    [10, X, Ys, Z] torus tensor. With occupancy_mask the moments are zero
    where `hit` is 0; without it the box is taken at every voxel. With
    y_window = (ys0, Ys), the sums are the slab scratch and `hit` the slab."""
    if _is_cpu(n):
        return moments.moments_epilogue_plain(cfg, n, rest, hit, origin, y_window, occupancy_mask)
    dev = n.device
    X, Y, Z = cfg.grid_shape
    rx, ry, rz = binning.moment_pad(cfg)
    ys0, Ys = binning.check_y_window(cfg, y_window)
    shape = binning.padded_shape(cfg, y_window)
    _check("n", n, torch.float32, (1,) + shape, dev)
    _check("rest", rest, torch.float32, (9,) + shape, dev)
    _check("hit", hit, torch.int32, (X, Ys, Z), dev)
    _check("origin", origin, torch.int32, (3,), dev)
    out = torch.empty((10, X, Ys, Z), dtype=torch.float32, device=dev)
    k = XBOX_SLAB if binning.is_slab(cfg, y_window) else XBOX
    work = _epilogue_workspace(k, X, Y, Z, rx, ry, rz, ys0, Ys, occupancy_mask, dev)
    k.launch(_ptr(n), _ptr(rest), _ptr(hit), _ptr(origin), None, X, Y, Z, rx, ry, rz, ys0, Ys,
             int(occupancy_mask), _ptr(out), work if work is None else _ptr(work), _stream())
    return out


def point_moments(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, origin: torch.Tensor,
                  y_window=None, occupancy_mask: bool = True):
    """(hit [X,Ys,Z] int32, min_height [X,Ys,Z] f32, mom [10,X,Ys,Z] f32) of a
    flat point set [N,3] in the world frame: K2 then K5 (the contract of
    the JAX package's fused_point_moments), moments.point_moments on the CPU."""
    if _is_cpu(points):
        return moments.point_moments(cfg, points, keep, origin, y_window, occupancy_mask)
    bins = bin_points(cfg, points, keep, origin, y_window)
    mom = moments_epilogue(cfg, bins.n, bins.rest, bins.hit, origin, y_window, occupancy_mask)
    return bins.hit, bins.min_height, mom


# ----------------------------------------------------------------------
# K4


def _combine_defines(cfg: GvomConfig) -> tuple:
    """K4's library for cfg: its unrolled depth, or past CMB_MAX_B the
    up-front library, whose grouped form takes any depth."""
    B = cfg.buffer_size
    return (f"-DGVOM_COMBINE_B={B}",) if B <= CMB_MAX_B else CMB.defines


def combine(cfg: GvomConfig, buf, world, origin: torch.Tensor, ego: torch.Tensor):
    """Fuse the ring buffer and the old world. Returns (hit, miss, min_height,
    evidence, mom) of the new world with the any_valid latch applied, and
    the torus-layout column products (hm_t, ihm_t, pnum, pden, band_ok;
    band_ok int32)."""
    from gvom_tpu_torch.models import pipeline   # pipeline imports this module

    if _is_cpu(buf.grids.hit):
        return pipeline.fuse_plain(cfg, buf, world, origin, ego)
    launch, outs = combine_launch(cfg, buf, world, origin, ego)
    launch()
    return outs


def combine_launch(cfg: GvomConfig, buf, world, origin: torch.Tensor, ego: torch.Tensor):
    """K4's inputs on the card, checked, with its meta vector and fresh
    outputs: returns (launch, outputs), where launch() runs the kernel once
    into those outputs (band_ok as int32). combine() calls it once; a timing
    of the kernel alone calls launch()."""
    if _is_cpu(buf.grids.hit):
        raise ValueError("combine_launch: the buffer is on the CPU; the kernel takes CUDA tensors")
    dev = buf.grids.hit.device
    B = cfg.buffer_size
    X, Y, Z = cfg.grid_shape
    g, w = buf.grids, world.grid
    for nm, t, dt in (("hit", g.hit, torch.int32), ("miss", g.miss, torch.int32),
                      ("min_height", g.min_height, torch.float32)):
        _check("buffer " + nm, t, dt, (B + 1, X, Y, Z), dev)
    _check("buffer mom", g.mom, torch.float32, (B + 1, 10, X, Y, Z), dev)
    for nm, t, dt in (("hit", w.hit, torch.int32), ("miss", w.miss, torch.int32),
                      ("min_height", w.min_height, torch.float32), ("evidence", world.evidence, torch.int32)):
        _check("world " + nm, t, dt, (X, Y, Z), dev)
    _check("world mom", w.mom, torch.float32, (10, X, Y, Z), dev)
    _check("ego", ego, torch.float32, (3,), dev)
    any_valid = buf.slot_valid.any()
    meta = torch.cat([g.origin[:B].reshape(-1), w.origin.reshape(-1), origin.reshape(-1),
                      buf.slot_valid.to(torch.int32), world.valid.reshape(1).to(torch.int32),
                      any_valid.reshape(1).to(torch.int32)]).to(torch.int32).contiguous()
    hit = torch.empty((X, Y, Z), dtype=torch.int32, device=dev)
    miss = torch.empty_like(hit)
    minh = torch.empty((X, Y, Z), dtype=torch.float32, device=dev)
    ev = torch.empty_like(hit)
    mom = torch.empty((10, X, Y, Z), dtype=torch.float32, device=dev)
    hm_t = torch.empty((X, Y), dtype=torch.float32, device=dev)
    ihm_t = torch.empty_like(hm_t)
    pnum = torch.empty((X, Y), dtype=torch.int32, device=dev)
    pden = torch.empty_like(pnum)
    bok = torch.empty_like(pnum)
    ins = (meta, ego, g.hit, g.miss, g.min_height, g.mom, w.hit, w.miss, w.min_height, world.evidence, w.mom)
    outs = (hit, miss, minh, ev, mom, hm_t, ihm_t, pnum, pden, bok)
    consts = (B, X, Y, Z) + _column_consts(cfg)

    def launch():
        # the closure holds the tensors (meta is made here), not bare pointers
        CMB.launch(*map(_ptr, ins), *consts, *map(_ptr, outs), _stream(), defines=_combine_defines(cfg))

    return launch, outs


# ----------------------------------------------------------------------
# the 2-D maps' stencils


def plane_fit(cfg: GvomConfig, hm_t: torch.Tensor, ihm_t: torch.Tensor, origin: torch.Tensor):
    """(height, inferred height, roughness, slope_x, slope_y) [X, X] in
    window layout from the torus-layout column maps hm_t and ihm_t [X, X]
    f32 at origin [3] int32: the maps moved to the window layout, then the
    3×3 plane fit of the height map; maps2d.plane_fit_window_plain's
    function, bitwise, in one launch."""
    X = cfg.xy_size
    dev = hm_t.device
    _check("hm_t", hm_t, torch.float32, (X, X), dev)
    _check("ihm_t", ihm_t, torch.float32, (X, X), dev)
    _check("origin", origin, torch.int32, (3,), dev)
    if _is_cpu(hm_t):
        return maps2d.plane_fit_window_plain(cfg, hm_t, ihm_t, origin)
    outs = tuple(torch.empty((X, X), dtype=torch.float32, device=dev) for _ in range(5))
    PLANEFIT.launch(_ptr(hm_t), _ptr(ihm_t), _ptr(origin), X, X, f32_value(cfg.xy_resolution), UNKNOWN_HEIGHT,
                    *map(_ptr, outs), _stream())
    return outs


def plane_fit_tail(err: torch.Tensor, ok: torch.Tensor, a0n: torch.Tensor, a1n: torch.Tensor,
                   inv_m: torch.Tensor):
    """(roughness, slope_x, slope_y) of the plane fit from its residual err,
    its `ok` mask and its normalized coefficients a0n, a1n and 1/m, all of
    one shape: maps2d.plane_fit_tail_plain's function, bitwise, in one
    launch. Off the map path: plane_fit computes the whole fit."""
    if _is_cpu(err):
        return maps2d.plane_fit_tail_plain(err, ok, a0n, a1n, inv_m)
    dev, shape = err.device, tuple(err.shape)
    for nm, t in (("err", err), ("a0n", a0n), ("a1n", a1n), ("inv_m", inv_m)):
        _check(nm, t, torch.float32, shape, dev)
    _check("ok", ok, torch.bool, shape, dev)
    outs = tuple(torch.empty(shape, dtype=torch.float32, device=dev) for _ in range(3))
    PLANEFIT_TAIL.launch(*map(_ptr, (err, ok, a0n, a1n, inv_m)), err.numel(), *map(_ptr, outs), _stream())
    return outs


def guess_height(cfg: GvomConfig, hm: torch.Tensor, ihm: torch.Tensor, slope_x: torch.Tensor,
                 slope_y: torch.Tensor, pnum: torch.Tensor, pden: torch.Tensor, band_ok: torch.Tensor,
                 origin: torch.Tensor):
    """(guessed_height_delta f32, positive_obstacle, negative_obstacle,
    visibility int32) [X, X] in window layout, from the window-layout height,
    inferred height and slopes (f32, plane_fit's) and the torus-layout band
    sums pnum, pden and band_ok (int32) at origin [3] int32: the guess-height
    search, for any guess_search_radius >= 0, then the obstacle maps and the
    visibility as its epilogue; maps2d.guess_products_plain's function,
    bitwise, in one launch."""
    X, R = cfg.xy_size, cfg.guess_search_radius
    if R < 0:
        raise ValueError(f"guess_search_radius {R}: must be >= 0")
    dev = hm.device
    for nm, t in (("hm", hm), ("ihm", ihm), ("slope_x", slope_x), ("slope_y", slope_y)):
        _check(nm, t, torch.float32, (X, X), dev)
    for nm, t in (("pnum", pnum), ("pden", pden), ("band_ok", band_ok)):
        _check(nm, t, torch.int32, (X, X), dev)
    _check("origin", origin, torch.int32, (3,), dev)
    if _is_cpu(hm):
        return maps2d.guess_products_plain(cfg, hm, ihm, slope_x, slope_y, pnum, pden, band_ok, origin)
    ghd = torch.empty((X, X), dtype=torch.float32, device=dev)
    maps = tuple(torch.empty((X, X), dtype=torch.int32, device=dev) for _ in range(3))
    GUESS.launch(*map(_ptr, (hm, ihm, slope_x, slope_y, pnum, pden, band_ok, origin)), X, R, UNKNOWN_HEIGHT,
                 f32_value(cfg.slope_obstacle_threshold), f32_value(cfg.negative_obstacle_threshold), _ptr(ghd),
                 *map(_ptr, maps), _stream())
    return (ghd,) + maps


# ----------------------------------------------------------------------
# the batched step's merge with its column maps


def merge_batch(cfg: GvomConfig, world, contrib: VoxelGrid, ego: torch.Tensor, y0: int = 0):
    """Merge a batch's contribution (hit, miss, min_height and RAW moments at
    contrib.origin, for the torus rows [y0, y0+Ys) of a y-slab: [X, Ys, Z],
    mom [10, X, Ys, Z]) with the old world's slab, and take the merged
    world's column maps. Returns (merged VoxelGrid, evidence [X, Ys, Z],
    cols [2, X, Ys] f32: height and inferred height, bands [3, X, Ys] int32:
    the band's hit sum, total sum and band_ok), torus layout:
    sharding.merge_and_columns_plain's function, bitwise, in one launch.
    On the card the merged channels are written over contrib's own
    buffers, which the caller hands over; the old world is only read."""
    from gvom_tpu_torch.parallel import sharding   # sharding imports this module

    X, Y, Z = cfg.grid_shape
    if contrib.hit.ndim != 3:
        raise ValueError(f"contrib hit: shape {tuple(contrib.hit.shape)}, expected [X, Ys, Z]")
    Ys = contrib.hit.shape[1]
    if not (0 <= y0 and Ys > 0 and y0 + Ys <= Y):
        raise ValueError(f"merge_batch: rows [{y0}, {y0 + Ys}) are not inside the torus's {Y}")
    dev = contrib.hit.device
    w = world.grid
    for nm, t, dt in (("hit", contrib.hit, torch.int32), ("miss", contrib.miss, torch.int32),
                      ("min_height", contrib.min_height, torch.float32)):
        _check("contrib " + nm, t, dt, (X, Ys, Z), dev)
    _check("contrib mom", contrib.mom, torch.float32, (10, X, Ys, Z), dev)
    _check("contrib origin", contrib.origin, torch.int32, (3,), dev)
    for nm, t, dt in (("hit", w.hit, torch.int32), ("miss", w.miss, torch.int32),
                      ("min_height", w.min_height, torch.float32), ("evidence", world.evidence, torch.int32)):
        _check("world " + nm, t, dt, (X, Ys, Z), dev)
    _check("world mom", w.mom, torch.float32, (10, X, Ys, Z), dev)
    _check("world origin", w.origin, torch.int32, (3,), dev)
    _check("world valid", world.valid, torch.bool, (), dev)
    _check("ego", ego, torch.float32, (3,), dev)
    if _is_cpu(contrib.hit):
        return sharding.merge_and_columns_plain(cfg, world, contrib, ego, y0)
    ev = torch.empty((X, Ys, Z), dtype=torch.int32, device=dev)
    cols = torch.empty((2, X, Ys), dtype=torch.float32, device=dev)
    bands = torch.empty((3, X, Ys), dtype=torch.int32, device=dev)
    MERGE.launch(*map(_ptr, (contrib.origin, w.origin, world.valid, ego, contrib.hit, contrib.miss,
                             contrib.min_height, contrib.mom, w.hit, w.miss, w.min_height, world.evidence, w.mom)),
                 X, Ys, Y, Z, y0, *_column_consts(cfg), _ptr(ev), _ptr(cols), _ptr(bands), _stream())
    merged = VoxelGrid(hit=contrib.hit, miss=contrib.miss, min_height=contrib.min_height, mom=contrib.mom,
                       origin=contrib.origin)
    return merged, ev, cols, bands
