"""The reference's configuration and state records.

A copy of the port's configuration schema (its field names and defaults,
which the benchmark's configuration files give by name) and of its state
records, so that the reference imports nothing of the port.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch

__all__ = ["GvomConfig", "UNKNOWN_HEIGHT", "VoxelGrid", "WorldState", "BufferState", "MapProducts",
           "empty_voxel_grid", "empty_world_state", "empty_buffer_state"]

# Sentinel for "no height measured" in the 2D maps (reference −1000.0, gvom.py:289).
UNKNOWN_HEIGHT = -1000.0
MOMENT_CHANNELS = 10


@dataclasses.dataclass(frozen=True)
class GvomConfig:
    xy_resolution: float = 0.40
    z_resolution: float = 0.40
    xy_size: int = 256
    z_size: int = 64
    buffer_size: int = 4
    min_distance: float = 1.0
    positive_obstacle_threshold: float = 0.50
    negative_obstacle_threshold: float = 0.50
    slope_obstacle_threshold: float = 0.30
    robot_height: float = 2.0
    robot_radius: float = 4.0
    ground_to_lidar_height: float = 1.0
    xy_eigen_dist: int = 1
    z_eigen_dist: int = 1
    density_threshold: int = 50
    min_roughness: float = -10.0
    max_roughness: float = 0.0
    combine_freq: float = 10.0
    odom_frame: str = "odom"
    max_points: int = 131072
    hit_count_threshold: int = 10
    decay_miss_limit: int = 10
    guess_search_radius: int = 15
    ray_steps_override: Optional[int] = None
    ego_relative_min_distance: bool = False

    @property
    def voxel_count(self) -> int:
        return self.xy_size * self.xy_size * self.z_size

    @property
    def grid_shape(self) -> tuple:
        return (self.xy_size, self.xy_size, self.z_size)

    @property
    def ray_steps(self) -> int:
        """The DDA step budget: the centred-ego bound unless pinned."""
        if self.ray_steps_override is not None:
            return self.ray_steps_override
        return max(self.xy_size, self.z_size) // 2 + 4

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "GvomConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown config keys: {sorted(unknown)}")
        return cls(**d)

    def replace(self, **kw) -> "GvomConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class VoxelGrid:
    hit: torch.Tensor         # [.., X, Y, Z] int32, torus layout
    miss: torch.Tensor        # [.., X, Y, Z] int32
    min_height: torch.Tensor  # [.., X, Y, Z] f32, 1.0 where no point
    mom: torch.Tensor         # [.., 10, X, Y, Z] f32 raw moments (n, S1, R2)
    origin: torch.Tensor      # [.., 3] int32, voxel units


@dataclasses.dataclass
class WorldState:
    grid: VoxelGrid
    evidence: torch.Tensor   # [X, Y, Z] int32
    valid: torch.Tensor      # [] bool


@dataclasses.dataclass
class BufferState:
    grids: VoxelGrid          # leading dim B+1: slot B absorbs degenerate scans
    slot_valid: torch.Tensor  # [B] bool
    cursor: torch.Tensor      # [] int32
    last_slot: torch.Tensor   # [] int32


@dataclasses.dataclass
class MapProducts:
    """The ten 2-D maps of a combine or a batched step, window layout."""

    origin: torch.Tensor
    height: torch.Tensor
    inferred_height: torch.Tensor
    slope_x: torch.Tensor
    slope_y: torch.Tensor
    roughness: torch.Tensor
    guessed_height_delta: torch.Tensor
    positive_obstacle: torch.Tensor
    negative_obstacle: torch.Tensor
    visibility: torch.Tensor


MAP_FIELDS = tuple(f.name for f in dataclasses.fields(MapProducts))


def empty_voxel_grid(cfg: GvomConfig, device, lead: tuple = ()) -> VoxelGrid:
    shape = tuple(lead) + cfg.grid_shape
    return VoxelGrid(hit=torch.zeros(shape, dtype=torch.int32, device=device),
                     miss=torch.zeros(shape, dtype=torch.int32, device=device),
                     min_height=torch.ones(shape, dtype=torch.float32, device=device),
                     mom=torch.zeros(tuple(lead) + (MOMENT_CHANNELS,) + cfg.grid_shape, dtype=torch.float32,
                                     device=device),
                     origin=torch.zeros(tuple(lead) + (3,), dtype=torch.int32, device=device))


def empty_world_state(cfg: GvomConfig, device) -> WorldState:
    return WorldState(grid=empty_voxel_grid(cfg, device),
                      evidence=torch.zeros(cfg.grid_shape, dtype=torch.int32, device=device),
                      valid=torch.zeros((), dtype=torch.bool, device=device))


def empty_buffer_state(cfg: GvomConfig, device) -> BufferState:
    b = cfg.buffer_size
    return BufferState(grids=empty_voxel_grid(cfg, device, lead=(b + 1,)),
                       slot_valid=torch.zeros((b,), dtype=torch.bool, device=device),
                       cursor=torch.zeros((), dtype=torch.int32, device=device),
                       last_slot=torch.zeros((), dtype=torch.int32, device=device))
