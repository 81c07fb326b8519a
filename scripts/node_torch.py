#!/usr/bin/env python3
"""roslaunch entrypoint of the PyTorch/CUDA port (launch/gvom_node_torch.launch
names type="node_torch.py").

Thin shim over gvom_tpu_torch.ros.node.main so catkin_install_python has a
script target; the package itself ships on the PYTHONPATH (pip or catkin
venv). It imports no JAX."""

from gvom_tpu_torch.ros.node import main

if __name__ == "__main__":
    main()
