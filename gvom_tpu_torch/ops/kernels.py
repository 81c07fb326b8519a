"""The hand-written CUDA kernels of the main path: loader, build and wrappers.

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
| ray_pass_counts    | raycast.cu   | _run_hist via ray_pass_counts_matmul      | raycast.ray_pass_counts_plain      |
| bin_points         | binning.cu   | fused_point_moments                       | binning.bin_points                 |
| ingest_epilogue    | epilogue.cu  | _xbox_epilogue_into                       | moments.ingest_epilogue_plain      |
| combine            | combine.cu   | fused_combine (+ the XLA mom merge)       | models.pipeline.fuse_plain         |
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional

import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import binning, moments, raycast
from gvom_tpu_torch.ops.maps2d import f32_square
from gvom_tpu_torch.types import UNKNOWN_HEIGHT

__all__ = [
    "CudaKernel",
    "KERNELS",
    "build_all",
    "reset_launches",
    "ray_pass_counts",
    "bin_points",
    "ingest_epilogue",
    "combine",
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
    """One kernel: its source, its C entry, its build and its launch count."""

    def __init__(self, name: str, source: str, entry: str, argtypes: list, replaces: str):
        self.name = name
        self.source = CSRC / source
        self.entry = entry
        self.argtypes = argtypes
        self.replaces = replaces
        self.launches = 0
        self._fn = None

    @property
    def library(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        return BUILD_DIR / f"{self.source.stem}-{h}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start nvcc for this source unless its library exists; returns the
        process (its output is the ptxas report) or None."""
        if self.library.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = self.library.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> str:
        if proc is None:
            return ""
        out, _ = proc.communicate()
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {self.source.name}:\n{out}")
        os.replace(tmp, self.library)
        return out

    def fn(self):
        if self._fn is None:
            self.finish_build(self.start_build())
            lib = ctypes.CDLL(str(self.library))
            f = getattr(lib, self.entry)
            f.argtypes = self.argtypes
            f.restype = ctypes.c_int
            self._fn = f
        return self._fn

    def launch(self, *args) -> None:
        rc = self.fn()(*args)
        if rc != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: cudaError {rc}")
        self.launches += 1


RAY = CudaKernel(
    "ray_pass_counts", "raycast.cu", "gvom_ray_pass_counts",
    [_P] * 7 + [_I] * 5 + [_P, _P],
    "gvom_tpu/ops/pallas_kernels.py:335 (_run_hist, via ray_pass_counts_matmul :510)")
BIN = CudaKernel(
    "bin_points", "binning.cu", "gvom_bin_points",
    [_P] * 3 + [_I] * 7 + [_P] * 4,
    "gvom_tpu/ops/pallas_kernels.py:1510 (fused_point_moments)")
EPI = CudaKernel(
    "ingest_epilogue", "epilogue.cu", "gvom_ingest_epilogue",
    [_P] * 4 + [_I] * 6 + [_P, _P],
    "gvom_tpu/ops/pallas_kernels.py:1459 (_xbox_epilogue_into)")
CMB = CudaKernel(
    "combine", "combine.cu", "gvom_combine",
    [_P] * 11 + [_I] * 4 + [_F] * 8 + [_I] * 2 + [_P] * 11,
    "gvom_tpu/ops/pallas_kernels.py:1883 (fused_combine) + gvom_tpu/models/pipeline.py:420 (mom merge)")

KERNELS: List[CudaKernel] = [RAY, BIN, EPI, CMB]


def build_all() -> Dict[str, str]:
    """Build every kernel library that is missing, one nvcc per source, all
    started together. Returns each kernel's compiler report."""
    procs = [(k, k.start_build()) for k in KERNELS]
    return {k.name: k.finish_build(p) for k, p in procs}


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


def _stream() -> ctypes.c_void_p:
    return _P(torch.cuda.current_stream().cuda_stream)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return _P(t.data_ptr())


def _f32(v: float) -> float:
    return float(torch.tensor(v, dtype=torch.float32))


# ----------------------------------------------------------------------
# K1


def ray_pass_counts(cfg: GvomConfig, m, origin: torch.Tensor) -> torch.Tensor:
    """[X,Y,Z] int32 pass counts in the torus layout from ray_geometry's
    march inputs (ops/raycast.RayMarch)."""
    if _is_cpu(m.step):
        return raycast.ray_pass_counts_plain(cfg, m, origin)
    dev = m.step.device
    n = m.step.shape[0]
    _check("start_rel", m.start_rel, torch.float32, (3,), dev)
    _check("start_i", m.start_i, torch.int32, (3,), dev)
    _check("step", m.step, torch.float32, (n, 3), dev)
    for nm in ("delta", "budget"):
        _check(nm, getattr(m, nm), torch.float32, (n,), dev)
    _check("dom", m.dom, torch.int32, (n,), dev)
    _check("origin", origin, torch.int32, (3,), dev)
    X, Y, Z = cfg.grid_shape
    out = torch.zeros((X, Y, Z), dtype=torch.int32, device=dev)
    RAY.launch(_ptr(m.start_rel), _ptr(m.start_i), _ptr(m.step), _ptr(m.delta), _ptr(m.budget),
               _ptr(m.dom), _ptr(origin), n, cfg.ray_steps, X, Y, Z, _ptr(out), _stream())
    return out


# ----------------------------------------------------------------------
# K2


def bin_points(cfg: GvomConfig, pn: torch.Tensor, keep: torch.Tensor, origin: torch.Tensor):
    """One scan's binning from map-local coordinates pn [N,3]: returns
    binning.PointBins (hit, min_height torus [X,Y,Z]; own-voxel sums padded
    [10, Xp, Yp, Zp])."""
    if _is_cpu(pn):
        return binning.bin_points(cfg, pn, keep, origin)
    dev = pn.device
    n = pn.shape[0]
    _check("pn", pn, torch.float32, (n, 3), dev)
    _check("keep", keep, torch.bool, (n,), dev)
    _check("origin", origin, torch.int32, (3,), dev)
    X, Y, Z = cfg.grid_shape
    rx, ry, rz = binning.moment_pad(cfg)
    hit = torch.zeros((X, Y, Z), dtype=torch.int32, device=dev)
    minh = torch.ones((X, Y, Z), dtype=torch.float32, device=dev)
    sums = torch.zeros((10,) + binning.padded_shape(cfg), dtype=torch.float32, device=dev)
    BIN.launch(_ptr(pn), _ptr(keep), _ptr(origin), n, X, Y, Z, rx, ry, rz,
               _ptr(hit), _ptr(minh), _ptr(sums), _stream())
    return binning.PointBins(hit=hit, min_height=minh, sums=sums)


# ----------------------------------------------------------------------
# K3


def ingest_epilogue(cfg: GvomConfig, sums: torch.Tensor, hit: torch.Tensor, origin: torch.Tensor,
                    out: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Box-aggregate, crop and occupancy-mask one scan's moments and write
    them into out[slot] ([S, 10, X, Y, Z], torus); slot is a device int32
    tensor of one element. Returns out."""
    if _is_cpu(sums):
        return moments.ingest_epilogue_plain(cfg, sums, hit, origin, out, slot)
    dev = sums.device
    X, Y, Z = cfg.grid_shape
    rx, ry, rz = binning.moment_pad(cfg)
    _check("sums", sums, torch.float32, (10,) + binning.padded_shape(cfg), dev)
    _check("hit", hit, torch.int32, (X, Y, Z), dev)
    _check("origin", origin, torch.int32, (3,), dev)
    _check("out", out, torch.float32, (out.shape[0], 10, X, Y, Z), dev)
    _check("slot", slot.reshape(1), torch.int32, (1,), dev)
    EPI.launch(_ptr(sums), _ptr(hit), _ptr(origin), _ptr(slot), X, Y, Z, rx, ry, rz, _ptr(out), _stream())
    return out


# ----------------------------------------------------------------------
# K4


def combine(cfg: GvomConfig, buf, world, origin: torch.Tensor, ego: torch.Tensor):
    """Fuse the ring buffer and the old world. Returns (hit, miss, min_height,
    evidence, mom) of the new world with the any_valid latch applied, and
    the torus-layout column products (hm_t, ihm_t, pnum, pden, band_ok)."""
    from gvom_tpu_torch.models import pipeline   # pipeline imports this module

    if _is_cpu(buf.grids.hit):
        return pipeline.fuse_plain(cfg, buf, world, origin, ego)
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
    inv_z = float(torch.reciprocal(torch.tensor(cfg.z_resolution, dtype=torch.float32)))
    CMB.launch(_ptr(meta), _ptr(ego), _ptr(g.hit), _ptr(g.miss), _ptr(g.min_height), _ptr(g.mom),
               _ptr(w.hit), _ptr(w.miss), _ptr(w.min_height), _ptr(world.evidence), _ptr(w.mom),
               B, X, Y, Z,
               _f32(cfg.z_resolution), _f32(cfg.xy_resolution), inv_z,
               _f32(cfg.positive_obstacle_threshold), _f32(cfg.robot_height),
               f32_square(cfg.robot_radius), _f32(cfg.ground_to_lidar_height), UNKNOWN_HEIGHT,
               cfg.decay_miss_limit, cfg.hit_count_threshold,
               _ptr(hit), _ptr(miss), _ptr(minh), _ptr(ev), _ptr(mom),
               _ptr(hm_t), _ptr(ihm_t), _ptr(pnum), _ptr(pden), _ptr(bok), _stream())
    return hit, miss, minh, ev, mom, hm_t, ihm_t, pnum, pden, bok.bool()
