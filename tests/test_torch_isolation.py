"""The port stands alone: importing every module of gvom_tpu_torch loads
neither jax nor anything of gvom_tpu (checked in a subprocess, since this
test process has imported jax already; ros.node imports without rospy),
chip_smoke.py imports neither, and the port's entry points refuse to fall
back to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gvom_tpu_torch import Gvom, GvomConfig, VoxelMapperNode, batched_replay, cli, make_batched_step, sequential_replay
from gvom_tpu_torch.entry import entry
from gvom_tpu_torch.io.logio import ScanLog
from gvom_tpu_torch.ops import kernels
from gvom_tpu_torch.types import VoxelGrid, WorldState, empty_buffer_state, empty_world_state
from gvom_tpu_torch.utils.checkpoint import load_world
from gvom_tpu_torch.utils.failures import load_resumable

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import gvom_tpu_torch
for m in pkgutil.walk_packages(gvom_tpu_torch.__path__, "gvom_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "gvom_tpu", "rospy", "tf2_ros"))
print(" ".join(sorted(n for n in sys.modules if n.startswith("gvom_tpu_torch"))))
sys.exit("loaded: " + ", ".join(bad) if bad else 0)
"""


def _modules():
    pkg = ROOT / "gvom_tpu_torch"
    return sorted(".".join(("gvom_tpu_torch",) + p.relative_to(pkg).with_suffix("").parts).removesuffix(".__init__")
                  for p in pkg.rglob("*.py"))


def test_port_imports_no_jax_and_nothing_of_gvom_tpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr + r.stdout
    imported = set(r.stdout.split())
    assert {"gvom_tpu_torch.ros.node", "gvom_tpu_torch.cli", "gvom_tpu_torch.engine.node", "gvom_tpu_torch.bench",
            "gvom_tpu_torch.entry", "gvom_tpu_torch.oracle", "gvom_tpu_torch.oracle.numpy_ref",
            "gvom_tpu_torch.utils.parity"} <= imported
    assert set(_modules()) <= imported       # every module was imported


_BUILD_PROBE = """
import ctypes, subprocess, sys
import torch
calls = []
popen, cdll = subprocess.Popen.__init__, ctypes.CDLL.__init__
def record_popen(self, *a, **k):
    calls.append(repr(a[0] if a else k.get("args")))
    return popen(self, *a, **k)
def record_cdll(self, name, *a, **k):
    calls.append(str(name))
    return cdll(self, name, *a, **k)
subprocess.Popen.__init__, ctypes.CDLL.__init__ = record_popen, record_cdll
import gvom_tpu_torch.ops
import gvom_tpu_torch.pipelines
from gvom_tpu_torch.ops import kernels
sys.exit("started or loaded: " + "; ".join(calls) if calls else 0)
"""


def test_importing_the_port_builds_and_loads_no_kernel():
    """Importing the package, its ops and its pipelines starts no process
    (no nvcc) and loads no library: a kernel is built at its first launch."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _BUILD_PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr + r.stdout


@pytest.mark.parametrize("path", ["chip_smoke.py"] + sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "gvom_tpu_torch").rglob("*.py")))
def test_no_jax_import_statement(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module]
        for n in names:
            assert n.split(".")[0] not in ("jax", "jaxlib", "gvom_tpu"), f"{path} imports {n}"


def test_default_device_raises_without_gpu(monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GvomConfig(xy_size=16, z_size=8, max_points=64, buffer_size=2)
    log = ScanLog([])
    for make in (lambda: Gvom(config=cfg), lambda: empty_buffer_state(cfg), lambda: empty_world_state(cfg),
                 lambda: make_batched_step(cfg), lambda: batched_replay(cfg, log, 4),
                 lambda: sequential_replay(cfg, log), lambda: load_world("no_such_file.npz"),
                 lambda: VoxelMapperNode(), lambda: VoxelMapperNode(config=cfg),
                 lambda: load_resumable(str(tmp_path))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert empty_buffer_state(cfg, "cpu").grids.hit.shape == (3, 16, 16, 8)
    assert cli.main(["replay", "--scans", "1"]) == 2
    assert "device='cpu'" in capsys.readouterr().err
    assert cli.main(["selftest"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
    assert cli.main(["parity", "--scans", "1"]) == 2
    assert "device='cpu'" in capsys.readouterr().err
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry()


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs the plain version for CPU tensors only; any other
    device that is not CUDA is refused, never silently computed."""
    cfg = GvomConfig(xy_size=16, z_size=8, max_points=64, buffer_size=2)
    pn = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        kernels.bin_points(cfg, pn, torch.ones(4, dtype=torch.bool, device="meta"),
                           torch.zeros(3, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        kernels.prepare_points(cfg, pn[None], torch.ones((1, 4), dtype=torch.bool, device="meta"),
                               torch.zeros((1, 3), device="meta"), frame_ego=torch.zeros(3, device="meta"))
    f = torch.zeros((2, 2), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        kernels.plane_fit_tail(f, torch.ones((2, 2), dtype=torch.bool, device="meta"), f, f, f)
    m = torch.zeros((16, 16), device="meta")
    o = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        kernels.plane_fit(cfg, m, m, o)
    mi = torch.zeros((16, 16), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        kernels.guess_height(cfg, m, m, m, m, mi, mi, mi, o)
    g = lambda dt: torch.zeros(cfg.grid_shape, dtype=dt, device="meta")
    grid = VoxelGrid(hit=g(torch.int32), miss=g(torch.int32), min_height=g(torch.float32),
                     mom=torch.zeros((10,) + cfg.grid_shape, device="meta"), origin=o)
    world = WorldState(grid=grid, evidence=g(torch.int32), valid=torch.ones((), dtype=torch.bool, device="meta"))
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        kernels.merge_batch(cfg, world, grid, torch.zeros(3, device="meta"))
    assert [k.name for k in kernels.KERNELS] == [
        "ray_pass_counts", "bin_points", "ingest_epilogue", "combine", "moments_epilogue",
        "ray_pass_counts_slab", "bin_points_slab", "moments_epilogue_slab", "plane_fit", "plane_fit_tail",
        "guess_height", "prepare_points", "merge_batch"]
    ours = (kernels.PLANEFIT, kernels.PLANEFIT_TAIL, kernels.GUESS, kernels.PREP, kernels.MERGE)
    for k in kernels.KERNELS:
        # every kernel but the 2-D maps' stencils, the point preparation and the batched
        # merge, which the port adds, replaces a TPU kernel
        assert k.source.exists() and k.replaces.startswith(
            "none: the port's own" if k in ours else "gvom_tpu/ops/pallas_kernels.py:")


def test_raycast_wrapper_checks_its_inputs_before_the_device():
    """K1's wrapper refuses mismatched scan counts between points, keep and
    egos, and a non-contiguous input, whatever the device; inputs that pass
    on a device that is neither the CPU nor CUDA are refused as before."""
    cfg = GvomConfig(xy_size=16, z_size=8, max_points=64, buffer_size=2)
    pts = torch.zeros((2, 8, 3), device="meta")
    keep = torch.ones((2, 8), dtype=torch.bool, device="meta")
    egos = torch.zeros((2, 3), device="meta")
    origin = torch.zeros(3, dtype=torch.int32, device="meta")
    for bad, what in (((pts, keep[:1], egos), "keep: shape"), ((pts, keep, egos[:1]), "egos: shape"),
                      ((pts[:1], keep, egos), "keep: shape"),
                      ((torch.zeros((2, 3, 8), device="meta").transpose(1, 2), keep, egos), "contiguous"),
                      ((pts, keep.t().contiguous().t(), egos), "contiguous"),
                      ((pts[0], keep, egos), r"expected \[S, N, 3\]")):
        with pytest.raises(ValueError, match=what):
            kernels.ray_pass_counts(cfg, *bad, origin)
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        kernels.ray_pass_counts(cfg, pts, keep, egos, origin)


def test_build_all_builds_the_configs_combine_depth(monkeypatch):
    """K4 is one library per ring-buffer depth: build_all() builds each
    source once with K4 at B = 4, build_all(cfg) adds cfg.buffer_size's, and
    a facade made on the CPU builds nothing."""
    started = []
    monkeypatch.setattr(kernels.CudaKernel, "start_build",
                        lambda self, defines=None: started.append((self.source.name, tuple(defines))))
    monkeypatch.setattr(kernels.CudaKernel, "finish_build", lambda self, proc: "")
    reports = kernels.build_all()
    assert sorted(reports) == sorted(k.name for k in kernels.KERNELS)
    assert sorted(started) == [("binning.cu", ()), ("combine.cu", ("-DGVOM_COMBINE_B=4",)),
                               ("epilogue.cu", ()), ("guess.cu", ()), ("merge.cu", ()),
                               ("planefit.cu", ()), ("prepare.cu", ()), ("raycast.cu", ())]
    started.clear()
    kernels.build_all(GvomConfig(xy_size=16, z_size=8, max_points=64, buffer_size=3))
    assert ("combine.cu", ("-DGVOM_COMBINE_B=3",)) in started and len(started) == 9
    started.clear()
    kernels.build_all(GvomConfig(xy_size=16, z_size=8, max_points=64, buffer_size=4))
    assert len(started) == 8
    started.clear()
    Gvom(config=GvomConfig(xy_size=16, z_size=8, max_points=64, buffer_size=3), device="cpu")
    assert started == []


def test_combine_launch_takes_cuda_tensors_only():
    """combine_launch (K4's launch alone, for timing) has no plain twin: a
    buffer on the CPU is refused; combine() takes the plain version there."""
    cfg = GvomConfig(xy_size=16, z_size=8, max_points=64, buffer_size=2)
    buf, world = empty_buffer_state(cfg, "cpu"), empty_world_state(cfg, "cpu")
    origin, ego = torch.zeros(3, dtype=torch.int32), torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        kernels.combine_launch(cfg, buf, world, origin, ego)
    assert len(kernels.combine(cfg, buf, world, origin, ego)) == 10
