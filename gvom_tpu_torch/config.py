"""Configuration schema.

The reference passes 14 positional constructor parameters (gvom.py:29-51) plus
node-level extras loaded from rosparam (gvom_ros.py:23-41). Here the whole schema
is one frozen (hence hashable) dataclass: every parameter below shapes either
tensor extents or constants baked into the kernels' arguments.

This is the PyTorch port's own copy of gvom_tpu/config.py (stdlib only); the
port imports nothing of gvom_tpu.

Parameter names match the reference for drop-in familiarity (including the
reference's `slope_obsacle_threshold` spelling, accepted as an alias).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional

__all__ = ["GvomConfig", "load_config", "DEFAULT_CONFIG"]


@dataclasses.dataclass(frozen=True)
class GvomConfig:
    """Static configuration for the mapping engine.

    Core grid / algorithm parameters — semantics follow the reference docstring
    (gvom.py:14-27) and defaults follow the reference node (gvom_ros.py:23-41):
    """

    # --- voxel grid geometry ---
    xy_resolution: float = 0.40     # meters per voxel in x,y
    z_resolution: float = 0.40      # meters per voxel in z (launch default 0.4; node default 0.2)
    xy_size: int = 256              # voxels in x and in y
    z_size: int = 64                # voxels in z

    # --- ingest / fusion ---
    buffer_size: int = 4            # ring-buffer depth (scans kept)
    min_distance: float = 1.0       # discard points with |p| < min_distance (world frame — reference quirk)

    # --- costmap thresholds ---
    positive_obstacle_threshold: float = 0.50   # m above ground ⇒ positive obstacle band start
    negative_obstacle_threshold: float = 0.50   # hole depth ⇒ negative obstacle
    slope_obstacle_threshold: float = 0.30      # rad; |slope| ≥ this ⇒ obstacle
    robot_height: float = 2.0       # m; overhangs above ground+robot_height ignored
    robot_radius: float = 4.0       # m; ego disk seeded into the height map
    ground_to_lidar_height: float = 1.0         # m; lidar height above ground for the ego seed

    # --- covariance support radius, in voxels (gvom.py:47-51) ---
    xy_eigen_dist: int = 1
    z_eigen_dist: int = 1

    # --- node-level parameters (gvom_ros.py:23-41) ---
    density_threshold: int = 50     # hard/soft positive-obstacle split
    min_roughness: float = -10.0    # roughness display normalization
    max_roughness: float = 0.0
    combine_freq: float = 10.0      # Hz; combine_maps cadence in the host node
    odom_frame: str = "odom"

    # --- engine extensions (no reference equivalent) ---
    max_points: int = 131072        # static per-scan point capacity (OS1-128 density); scans are padded/masked
    hit_count_threshold: int = 10   # occupied-voxel density gate (constant 10 in reference, gvom.py:515)
    decay_miss_limit: int = 10      # staleness veto: old occupied voxel dropped past this many misses (gvom.py:992)
    guess_search_radius: int = 15   # __guess_height outward search bound (gvom.py:581)
    ray_steps_override: Optional[int] = None  # static DDA step budget; None derives the
                                              # centered-ego bound (see ray_steps). The batched
                                              # sharded step raises it to the any-in-grid bound
                                              # because it rasterizes a whole batch at the LAST
                                              # scan's origin (parallel/sharding.py).
    ego_relative_min_distance: bool = False  # True = filter on sensor-relative distance instead of the
                                             # reference's world-frame-norm quirk (gvom.py:1064-1068)

    # ------------------------------------------------------------------
    @property
    def voxel_count(self) -> int:
        return self.xy_size * self.xy_size * self.z_size

    @property
    def grid_shape(self) -> tuple:
        return (self.xy_size, self.xy_size, self.z_size)

    @property
    def map_shape(self) -> tuple:
        return (self.xy_size, self.xy_size)

    @property
    def ray_steps(self) -> int:
        """Static bound on DDA steps. The ego sits within one voxel of grid
        center (origin = floor(ego/res − size/2), gvom.py:123-126), and each
        step advances the dominant axis by exactly one voxel, so a ray exits
        the grid within max(xy,z)/2 + slack dominant-axis steps. An ego
        anywhere in the grid needs max(xy,z) + slack — set
        `ray_steps_override` when rasterizing at a foreign origin."""
        if self.ray_steps_override is not None:
            return self.ray_steps_override
        return max(self.xy_size, self.z_size) // 2 + 4

    def validate(self) -> "GvomConfig":
        if self.xy_size <= 0 or self.z_size <= 0:
            raise ValueError("grid sizes must be positive")
        if self.buffer_size <= 0:
            raise ValueError("buffer_size must be positive")
        if self.xy_resolution <= 0 or self.z_resolution <= 0:
            raise ValueError("resolutions must be positive")
        if self.xy_eigen_dist < 0 or self.z_eigen_dist < 0:
            raise ValueError("eigen dists must be >= 0")
        return self

    # --- serialization -------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GvomConfig":
        d = dict(d)
        # accept the reference's parameter spellings/aliases (gvom_ros.py:24-41)
        aliases = {
            "slope_obsacle_threshold": "slope_obstacle_threshold",
            "width": "xy_size",
            "height": "z_size",
            "min_point_distance": "min_distance",
            "freq": "combine_freq",
        }
        for old, new in aliases.items():
            if old in d:
                d[new] = d.pop(old)
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d).validate()

    def replace(self, **kw) -> "GvomConfig":
        return dataclasses.replace(self, **kw).validate()


DEFAULT_CONFIG = GvomConfig()


def load_config(path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None) -> GvomConfig:
    """Load a config from a JSON/YAML file and/or override dict."""
    data: Dict[str, Any] = {}
    if path is not None:
        with open(path) as f:
            text = f.read()
        try:
            data = json.loads(text)
        except json.JSONDecodeError:
            try:
                import yaml  # type: ignore

                data = yaml.safe_load(text)
            except ImportError as e:
                raise ValueError(f"{path}: not JSON and PyYAML unavailable") from e
    if overrides:
        data.update(overrides)
    return GvomConfig.from_dict(data)
