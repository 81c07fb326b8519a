"""ROS1 integration (optional; runs only where rospy is installed).

Parameter-compatible with the reference node (gvom_ros.py:23-41): same
rosparam names (including `slope_obsacle_threshold`), same topic set
(gvom_ros.py:61-77). rospy, tf2_ros and the message types are imported
when a GvomRosNode is made, so this package imports without ROS.

    python -m gvom_tpu_torch.ros.node      # under ROS: the port's node
"""

import importlib.util
import sys

ROS_AVAILABLE = "rospy" in sys.modules or importlib.util.find_spec("rospy") is not None

__all__ = ["GvomRosNode", "main", "ROS_AVAILABLE"]


def __getattr__(name):
    # imported on first use, so that `python -m gvom_tpu_torch.ros.node`
    # does not find its module imported already by its package
    if name in ("GvomRosNode", "main"):
        from gvom_tpu_torch.ros import node

        return getattr(node, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
