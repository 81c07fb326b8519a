"""The port as a user installs it: the wheel that pyproject.toml builds
carries every kernel source of gvom_tpu_torch/csrc and the gvom-tpu-torch
script, and the port unpacked from it imports without JAX, runs its CLI and
finds its sources (and its build directory) inside the installed copy. The
wheel is built offline from a copy of the package sources, so the repo
itself gets no build/ or egg-info. chip_smoke.py builds and launches two
kernels from such a copy on the card."""

import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CSRC = REPO / "gvom_tpu_torch" / "csrc"

# run inside the unpacked copy: where the port's sources and build directory
# resolve, and whether importing the port (its kernels and the PointCloud2
# decoder included) loaded JAX
PROBE = """
import json, sys
import gvom_tpu_torch
from gvom_tpu_torch.io import pointcloud2
from gvom_tpu_torch.ops import kernels
print(json.dumps(dict(package=gvom_tpu_torch.__file__, build_dir=str(kernels.BUILD_DIR),
                      sources=sorted({str(k.source) for k in kernels.KERNELS}), pointcloud=str(pointcloud2._SRC),
                      jax="jax" in sys.modules)))
"""


def _env(path: Path) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(path)
    return env


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    src = tmp_path_factory.mktemp("src")
    shutil.copy(REPO / "pyproject.toml", src)
    skip = shutil.ignore_patterns("__pycache__", "_build", "*.pyc")
    for pkg in ("gvom_tpu", "gvom_tpu_torch"):
        shutil.copytree(REPO / pkg, src / pkg, ignore=skip)
    out = tmp_path_factory.mktemp("wheel")
    proc = subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation", "--no-index",
                           "--no-cache-dir", "-w", str(out), str(src)],
                          capture_output=True, text=True, timeout=120, cwd=src)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    (whl,) = out.glob("gvom_tpu-*.whl")
    return whl


@pytest.fixture(scope="module")
def unpacked(wheel, tmp_path_factory):
    root = tmp_path_factory.mktemp("site")
    with zipfile.ZipFile(wheel) as z:
        z.extractall(root)
    return root


def test_wheel_carries_every_kernel_source_and_the_script(wheel):
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
        (ep,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
        entry_points = z.read(ep).decode()
    sources = sorted(p.name for p in CSRC.iterdir() if p.is_file())
    assert {"combine.cu", "columns.cuh", "pointcloud.c"} <= set(sources)
    missing = [s for s in sources if f"gvom_tpu_torch/csrc/{s}" not in names]
    assert not missing, f"the wheel lacks {missing}"
    assert not any("/_build/" in n for n in names)
    assert "gvom-tpu-torch = gvom_tpu_torch.cli:main" in entry_points
    assert "gvom-tpu = gvom_tpu.cli:main" in entry_points


def test_installed_cli_runs_without_the_repo(unpacked):
    proc = subprocess.run([sys.executable, "-m", "gvom_tpu_torch.cli", "--help"], capture_output=True, text=True,
                          timeout=120, cwd=unpacked, env=_env(unpacked))
    assert proc.returncode == 0, proc.stderr
    assert "replay" in proc.stdout and "selftest" in proc.stdout


def test_installed_port_finds_its_sources_without_jax(unpacked):
    proc = subprocess.run([sys.executable, "-c", PROBE], capture_output=True, text=True, timeout=120, cwd=unpacked,
                          env=_env(unpacked))
    assert proc.returncode == 0, proc.stderr
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    pkg = unpacked / "gvom_tpu_torch"
    assert Path(got["package"]).parent == pkg
    assert Path(got["build_dir"]) == pkg / "_build"
    for s in got["sources"] + [got["pointcloud"]]:
        assert Path(s).parent == pkg / "csrc" and Path(s).is_file(), s
    assert not got["jax"], "importing the installed port loaded jax"
