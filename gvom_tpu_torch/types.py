"""State containers: dataclasses of tensors.

Dense-grid encoding (the same as gvom_tpu/types.py, which replaces the
reference's index_map int encoding, gvom.py:1152-1159):
    occupied          <=> hit > 0
    observed-empty    <=> hit == 0 and miss > 0     (reference: index == -miss-1)
    unobserved        <=> hit == 0 and miss == 0    (reference: index == -1)

Every grid channel is stored in the logical torus layout: world voxel w sits
at index w mod size along each axis, so re-origining a map is masks only.
`hit`, `miss`, `min_height` and `evidence` are [X, Y, Z]; the ten raw
voxel-local moment sums are one [10, X, Y, Z] tensor in the channel order
MOMENT_CHANNELS. (The JAX package's y-paired and 128-lane packed layouts exist
only to fill TPU tiles; utils/convert.py maps between the two.)

Moments are raw sums in the voxel's local frame: n (neighborhood point count,
reference metrics[9]), S1 = sum of (p - v), R2 = sum of (p - v)(p - v)^T.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from gvom_tpu_torch.config import GvomConfig

__all__ = [
    "VoxelGrid",
    "WorldState",
    "BufferState",
    "MapProducts",
    "MOMENT_CHANNELS",
    "UNKNOWN_HEIGHT",
    "empty_voxel_grid",
    "empty_world_state",
    "empty_buffer_state",
    "resolve_device",
]

# Sentinel for "no height measured" in the 2D maps (reference −1000.0, gvom.py:289).
UNKNOWN_HEIGHT = -1000.0

MOMENT_CHANNELS = ("n", "sx", "sy", "sz", "xx", "xy", "xz", "yy", "yz", "zz")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on. CUDA is the default; asking for it
    without a GPU raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "gvom_tpu_torch runs on a CUDA GPU by default and none is available; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    return dev


@dataclasses.dataclass
class VoxelGrid:
    """One dense ego-centered voxel map, or a stack of them (leading dim).

    origin is in voxel units per axis (x,y in xy_resolution units, z in
    z_resolution units), following gvom.py:123-126."""

    hit: torch.Tensor         # [.., X, Y, Z] int32 — lidar endpoint hits
    miss: torch.Tensor        # [.., X, Y, Z] int32 — ray pass-throughs
    min_height: torch.Tensor  # [.., X, Y, Z] float32 — sub-voxel z of the lowest point, 1.0 if none
    mom: torch.Tensor         # [.., 10, X, Y, Z] float32 — raw moments, MOMENT_CHANNELS order
    origin: torch.Tensor      # [.., 3] int32

    @property
    def occupied(self) -> torch.Tensor:
        return self.hit > 0

    @property
    def total(self) -> torch.Tensor:
        return self.hit + self.miss


@dataclasses.dataclass
class WorldState:
    """The persistent fused map (reference `last_combined_*`, gvom.py:77-83).

    `evidence` is the reference's index-map negative-evidence accumulator
    (gvom.py:941-997): the pass count gathered while a voxel stayed
    unoccupied, with slot-order latching and the occupied-wins overwrite."""

    grid: VoxelGrid
    evidence: torch.Tensor   # [X, Y, Z] int32
    valid: torch.Tensor      # [] bool — False until the first combine


@dataclasses.dataclass
class BufferState:
    """Ring buffer of per-scan voxel maps (reference gvom.py:56-67).

    `grids` leaves have a leading dim B+1: slot B is the write-off slot that
    absorbs degenerate scans (never read), so the insert is an unconditional
    write into a slot index computed on the device. `moments` is kernel
    K2's scratch of channels 1-9 (ops/binning.MomentScratch), which the
    ingests keep across scans; the first ingest makes it."""

    grids: VoxelGrid
    slot_valid: torch.Tensor  # [B] bool
    cursor: torch.Tensor      # [] int32 — next insertion slot
    last_slot: torch.Tensor   # [] int32 — most recent scan (its origin is the combined origin)
    moments: Optional[Any] = None   # binning.MomentScratch, or None before the first ingest


@dataclasses.dataclass
class MapProducts:
    """All 2D outputs of one combine step (reference gvom.py:286-354), in the
    window-relative layout (row 0 = window start)."""

    origin: torch.Tensor                # [3] int32, voxel units
    height: torch.Tensor                # [X, Y] f32, UNKNOWN_HEIGHT where unknown
    inferred_height: torch.Tensor       # [X, Y] f32
    slope_x: torch.Tensor               # [X, Y] f32 (rad)
    slope_y: torch.Tensor               # [X, Y] f32 (rad)
    roughness: torch.Tensor             # [X, Y] f32 (log plane-fit MSE; -1 where undefined)
    guessed_height_delta: torch.Tensor  # [X, Y] f32
    positive_obstacle: torch.Tensor     # [X, Y] int32 (0-100 density, 100 on slope trigger)
    negative_obstacle: torch.Tensor     # [X, Y] int32 (0 or 100)
    visibility: torch.Tensor            # [X, Y] int32 (0/1)

    def origin_world(self, cfg: GvomConfig) -> np.ndarray:
        o = self.origin.cpu().numpy().astype(np.float64)
        return o * np.array([cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution])


# ----------------------------------------------------------------------
# constructors


def empty_voxel_grid(cfg: GvomConfig, device="cuda", lead: tuple = ()) -> VoxelGrid:
    dev = resolve_device(device)
    shape = tuple(lead) + cfg.grid_shape
    return VoxelGrid(
        hit=torch.zeros(shape, dtype=torch.int32, device=dev),
        miss=torch.zeros(shape, dtype=torch.int32, device=dev),
        min_height=torch.ones(shape, dtype=torch.float32, device=dev),
        mom=torch.zeros(tuple(lead) + (len(MOMENT_CHANNELS),) + cfg.grid_shape,
                        dtype=torch.float32, device=dev),
        origin=torch.zeros(tuple(lead) + (3,), dtype=torch.int32, device=dev),
    )


def empty_world_state(cfg: GvomConfig, device="cuda") -> WorldState:
    dev = resolve_device(device)
    return WorldState(
        grid=empty_voxel_grid(cfg, dev),
        evidence=torch.zeros(cfg.grid_shape, dtype=torch.int32, device=dev),
        valid=torch.zeros((), dtype=torch.bool, device=dev),
    )


def empty_buffer_state(cfg: GvomConfig, device="cuda") -> BufferState:
    dev = resolve_device(device)
    b = cfg.buffer_size
    return BufferState(
        grids=empty_voxel_grid(cfg, dev, lead=(b + 1,)),
        slot_valid=torch.zeros((b,), dtype=torch.bool, device=dev),
        cursor=torch.zeros((), dtype=torch.int32, device=dev),
        last_slot=torch.zeros((), dtype=torch.int32, device=dev),
    )
