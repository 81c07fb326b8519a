"""Host-side I/O: scan logs (logio), synthetic scenes (synthetic), the
PointCloud2 wire format (pointcloud2), rosbag v2.0 files (rosbag) and the
LZ4 frames of their chunks (lz4f). numpy only; no ROS installation needed."""

from gvom_tpu_torch.io.logio import ScanLog, load_log, save_log, synthesize_log
from gvom_tpu_torch.io.pointcloud2 import (CloudSpec, PointField, array_to_pointcloud2, native_available,
                                           pointcloud2_to_xyz)
from gvom_tpu_torch.io.rosbag import (bag_to_scanlog, parse_odometry, parse_pointcloud2, read_bag_messages,
                                      serialize_odometry, serialize_pointcloud2, write_minimal_bag)
from gvom_tpu_torch.io.synthetic import (Terrain, bumpy_terrain, composite_terrain, flat_terrain, nudge_off_grid,
                                         pad_scan, ramp_terrain, simulate_lidar_scan, trench_terrain, wall_terrain)

__all__ = [
    "ScanLog", "save_log", "load_log", "synthesize_log",
    "PointField", "CloudSpec", "pointcloud2_to_xyz", "array_to_pointcloud2", "native_available",
    "read_bag_messages", "parse_pointcloud2", "parse_odometry", "bag_to_scanlog",
    "serialize_pointcloud2", "serialize_odometry", "write_minimal_bag",
    "Terrain", "flat_terrain", "ramp_terrain", "trench_terrain", "wall_terrain", "bumpy_terrain",
    "composite_terrain", "simulate_lidar_scan", "pad_scan", "nudge_off_grid",
]
