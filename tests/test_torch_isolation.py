"""The port stands alone: importing every module of gvom_tpu_torch loads
neither jax nor anything of gvom_tpu (checked in a subprocess, since this
test process has imported jax already), chip_smoke.py imports neither, and
the port's entry points refuse to fall back to the CPU on their own."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gvom_tpu_torch import Gvom, GvomConfig
from gvom_tpu_torch.ops import kernels
from gvom_tpu_torch.types import empty_buffer_state, empty_world_state

ROOT = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import gvom_tpu_torch
for m in pkgutil.walk_packages(gvom_tpu_torch.__path__, "gvom_tpu_torch."):
    importlib.import_module(m.name)
bad = sorted(n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib", "gvom_tpu"))
print(len([n for n in sys.modules if n.startswith("gvom_tpu_torch")]))
sys.exit("loaded: " + ", ".join(bad) if bad else 0)
"""


def test_port_imports_no_jax_and_nothing_of_gvom_tpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr + r.stdout
    assert int(r.stdout.split()[-1]) >= 15   # every module was imported


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


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = GvomConfig(xy_size=16, z_size=8, max_points=64, buffer_size=2)
    for make in (lambda: Gvom(config=cfg), lambda: empty_buffer_state(cfg), lambda: empty_world_state(cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    assert empty_buffer_state(cfg, "cpu").grids.hit.shape == (3, 16, 16, 8)


def test_kernel_wrappers_refuse_other_devices():
    """A wrapper runs the plain version for CPU tensors only; any other
    device that is not CUDA is refused, never silently computed."""
    cfg = GvomConfig(xy_size=16, z_size=8, max_points=64, buffer_size=2)
    pn = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA"):
        kernels.bin_points(cfg, pn, torch.ones(4, dtype=torch.bool, device="meta"),
                           torch.zeros(3, dtype=torch.int32, device="meta"))
    assert [k.name for k in kernels.KERNELS] == ["ray_pass_counts", "bin_points", "ingest_epilogue", "combine"]
    for k in kernels.KERNELS:
        assert k.source.exists() and k.replaces.startswith("gvom_tpu/ops/pallas_kernels.py:")
