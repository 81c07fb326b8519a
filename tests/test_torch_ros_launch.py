"""The port's ROS deployment entry: launch/gvom_node_torch.launch starts
scripts/node_torch.py, a shim over gvom_tpu_torch.ros.node.main, with the
same parameters and remaps as launch/gvom_node.launch (the JAX node's), and
CMakeLists.txt installs the shim beside scripts/node.py."""

import os
import subprocess
import sys
import xml.etree.ElementTree as ET
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _node(name):
    node = ET.parse(ROOT / "launch" / name).getroot().find("node")
    params = {p.get("name"): p.get("value") for p in node.findall("param")}
    remaps = {r.get("from"): r.get("to") for r in node.findall("remap")}
    return node.attrib, params, remaps


def test_launch_file_has_the_jax_nodes_parameters():
    attrs, params, remaps = _node("gvom_node_torch.launch")
    jattrs, jparams, jremaps = _node("gvom_node.launch")
    assert params == jparams and len(params) == 19
    assert remaps == jremaps == {"~cloud": "/points", "~odom": "/odometry"}
    assert attrs["type"] == "node_torch.py" and jattrs["type"] == "node.py"
    assert {k: v for k, v in attrs.items() if k != "type"} == {k: v for k, v in jattrs.items() if k != "type"}
    assert (ROOT / "scripts" / attrs["type"]).is_file() and os.access(ROOT / "scripts" / attrs["type"], os.X_OK)


def test_shim_runs_the_ports_node_and_imports_no_jax():
    """Loaded as a module (not as __main__), the shim binds the port's
    main and has imported neither jax nor gvom_tpu; ROS is imported only
    when the node starts."""
    code = ("import runpy, sys\n"
            f"g = runpy.run_path({str(ROOT / 'scripts' / 'node_torch.py')!r}, run_name='shim')\n"
            "import gvom_tpu_torch.ros.node as n\n"
            "assert g['main'] is n.main\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'gvom_tpu', 'rospy'))\n"
            "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, env=env,
                         cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_cmake_installs_the_shim():
    text = (ROOT / "CMakeLists.txt").read_text()
    block = text[text.index("catkin_install_python("):]
    block = block[:block.index(")")]
    assert "scripts/node.py" in block and "scripts/node_torch.py" in block
