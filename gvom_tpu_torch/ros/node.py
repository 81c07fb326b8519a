"""ROS1 node: topic/param surface of the reference node (gvom_ros.py),
engine + layer math from gvom_tpu_torch.engine.node; the port's copy of
gvom_tpu/ros/node.py. rospy, tf2_ros and the message types are imported
when GvomRosNode is made (or main runs), never when this module is."""

from __future__ import annotations

import numpy as np

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.engine.node import VoxelMapperNode
from gvom_tpu_torch.io.pointcloud2 import (
    CloudSpec,
    PointField,
    array_to_pointcloud2,
    pointcloud2_to_xyz,
)

__all__ = ["GvomRosNode", "main"]

GRID_TOPICS = (
    "soft_obstacle_map", "positive_obstacle_map", "negative_obstacle_map",
    "hard_obstacle_map", "ground_certainty_map", "all_ground_certainty_map",
    "roughness_map",
)
# debug PointCloud2 surface (gvom_ros.py:74-77; debug/lidar is
# declared-but-never-published in the reference — kept for parity)
DEBUG_TOPICS = ("debug/lidar", "debug/voxel", "debug/height_map", "debug/inferred_height_map")


def _quat_to_mat(tx, ty, tz, qx, qy, qz, qw):
    n = qx * qx + qy * qy + qz * qz + qw * qw
    s = 0.0 if n == 0 else 2.0 / n
    wx, wy, wz = s * qw * qx, s * qw * qy, s * qw * qz
    xx, xy, xz = s * qx * qx, s * qx * qy, s * qx * qz
    yy, yz, zz = s * qy * qy, s * qy * qz, s * qz * qz
    m = np.array(
        [
            [1.0 - (yy + zz), xy - wz, xz + wy, tx],
            [xy + wz, 1.0 - (xx + zz), yz - wx, ty],
            [xz - wy, yz + wx, 1.0 - (xx + yy), tz],
            [0.0, 0.0, 0.0, 1.0],
        ]
    )
    return m


class GvomRosNode:
    """The reference node's topics and parameters around a VoxelMapperNode
    on `device` (the CUDA GPU unless "cpu" is passed)."""

    def __init__(self, device="cuda"):
        import rospy
        import tf2_ros
        from nav_msgs.msg import OccupancyGrid, Odometry
        from sensor_msgs.msg import PointCloud2
        from sensor_msgs.msg import PointField as RosPointField

        self._rospy = rospy
        self._OccupancyGrid, self._PointCloud2, self._RosPointField = OccupancyGrid, PointCloud2, RosPointField
        get = rospy.get_param
        cfg = GvomConfig.from_dict(
            {
                "odom_frame": get("~odom_frame", "odom"),
                "xy_resolution": get("~xy_resolution", 0.40),
                "z_resolution": get("~z_resolution", 0.2),
                "width": get("~width", 256),
                "height": get("~height", 64),
                "buffer_size": get("~buffer_size", 4),
                "min_point_distance": get("~min_point_distance", 1.0),
                "positive_obstacle_threshold": get("~positive_obstacle_threshold", 0.50),
                "negative_obstacle_threshold": get("~negative_obstacle_threshold", 0.5),
                "density_threshold": get("~density_threshold", 50),
                "slope_obsacle_threshold": get("~slope_obsacle_threshold", 0.3),
                "min_roughness": get("~min_roughness", -10),
                "max_roughness": get("~max_roughness", 0),
                "robot_height": get("~robot_height", 2.0),
                "robot_radius": get("~robot_radius", 4.0),
                "ground_to_lidar_height": get("~ground_to_lidar_height", 1.0),
                "freq": get("~freq", 10.0),
                "xy_eigen_dist": get("~xy_eigen_dist", 1),
                "z_eigen_dist": get("~z_eigen_dist", 1),
                # no reference equivalent: the per-scan point capacity —
                # size to the sensor (OS1-128 default; scans beyond it warn
                # and truncate)
                "max_points": get("~max_points", 131072),
            }
        )
        self.node = VoxelMapperNode(config=cfg, publisher=self._publish, device=device)
        self.tf_buffer = tf2_ros.Buffer()
        self.tf_listener = tf2_ros.TransformListener(self.tf_buffer)
        self.pubs = {name: rospy.Publisher(f"~{name}", OccupancyGrid, queue_size=1) for name in GRID_TOPICS}
        self.debug_pubs = {name: rospy.Publisher(f"~{name}", PointCloud2, queue_size=1) for name in DEBUG_TOPICS}
        rospy.Subscriber("~cloud", PointCloud2, self.cb_lidar, queue_size=1)
        rospy.Subscriber("~odom", Odometry, self.cb_odom, queue_size=1)
        rospy.Timer(rospy.Duration(1.0 / cfg.combine_freq), self.cb_timer)

    def cb_odom(self, msg):
        p = msg.pose.pose.position
        self.node.on_odometry((p.x, p.y, p.z))

    def cb_lidar(self, msg):
        t = self.tf_buffer.lookup_transform(
            self.node.config.odom_frame, msg.header.frame_id, msg.header.stamp, self._rospy.Duration(1)
        )
        tr, q = t.transform.translation, t.transform.rotation
        tf_mat = _quat_to_mat(tr.x, tr.y, tr.z, q.x, q.y, q.z, q.w)
        spec = CloudSpec(
            fields=[PointField(f.name, f.offset, f.datatype, f.count) for f in msg.fields],
            point_step=msg.point_step,
            width=msg.width,
            height=msg.height,
            is_bigendian=msg.is_bigendian,
        )
        xyz = pointcloud2_to_xyz(bytes(msg.data), spec)
        self.node.on_pointcloud(xyz, tf_mat)

    def cb_timer(self, _event):
        if self.node.publish_maps() is not None:
            self.node.publish_debug()   # reference publishes debug each tick

    def _publish(self, name, data, meta):
        if name in self.debug_pubs:
            self._publish_debug_cloud(name, data, meta)
            return
        pub = self.pubs.get(name)
        if pub is None:
            return
        cfg = self.node.config
        msg = self._OccupancyGrid()
        msg.header.stamp = self._rospy.Time.now()
        msg.header.frame_id = cfg.odom_frame
        msg.info.resolution = cfg.xy_resolution
        msg.info.width = cfg.xy_size
        msg.info.height = cfg.xy_size
        msg.info.origin.orientation.w = 1
        msg.info.origin.position.x = meta["origin"][0]
        msg.info.origin.position.y = meta["origin"][1]
        # Fortran-order flatten as the reference publishes (gvom_ros.py:142)
        msg.data = np.reshape(data, -1, order="F").astype(np.int8)
        pub.publish(msg)

    def _publish_debug_cloud(self, name, data, meta):
        wire, spec = array_to_pointcloud2(data, meta["channels"])
        msg = self._PointCloud2()
        msg.header.stamp = self._rospy.Time.now()
        msg.header.frame_id = self.node.config.odom_frame
        msg.height = 1
        msg.width = spec.width
        msg.fields = [
            self._RosPointField(name=f.name, offset=f.offset, datatype=f.datatype, count=1)
            for f in spec.fields
        ]
        msg.is_bigendian = False
        msg.point_step = spec.point_step
        msg.row_step = spec.point_step * spec.width
        msg.is_dense = True
        msg.data = wire
        self.debug_pubs[name].publish(msg)


def main():
    import rospy

    rospy.init_node("voxel_mapping")
    GvomRosNode()
    rospy.spin()


if __name__ == "__main__":
    main()
