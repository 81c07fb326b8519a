"""Reference-shaped engine facade.

API parity with the reference class (gvom.py:12-410) and with
gvom_tpu/engine/gvom.py: the same constructor signature, `process_pointcloud`,
`combine_maps` (the same 5-tuple) and `get_map_as_occupancy_grid`.

Concurrency contract (the reference's, gvom.py:163-175, 198-208): sensor
threads may ingest while a combine is in flight. `_lock` guards the state:
an ingest enqueues its device work under it (the ring buffer is updated in
place), and a combine enqueues its work under it too, so the combine reads
a whole buffer. `_combine_lock` serializes combines with each other. The
combine's one host sync (reading combine_ok and the outputs) runs outside
`_lock`, so an ingest never waits for a device round trip.

`process_pointcloud` never syncs with the host: degenerate scans are masked
no-ops on the device (the reference copies a cell count back per scan,
gvom.py:147).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.models import pipeline
from gvom_tpu_torch.types import BufferState, WorldState, empty_buffer_state, empty_world_state, resolve_device
from gvom_tpu_torch.utils.metrics import StepMetrics

__all__ = ["Gvom"]


class Gvom:
    """Drop-in engine: `Gvom(xy_resolution, z_resolution, ...)` positional
    parameters as in the reference (gvom.py:29-31), or `Gvom(config=cfg)`.
    Runs on the CUDA GPU unless `device="cpu"` is passed."""

    def __init__(
        self,
        xy_resolution: float = None,
        z_resolution: float = None,
        xy_size: int = None,
        z_size: int = None,
        buffer_size: int = None,
        min_distance: float = None,
        positive_obstacle_threshold: float = None,
        negative_obstacle_threshold: float = None,
        slope_obstacle_threshold: float = None,
        robot_height: float = None,
        robot_radius: float = None,
        ground_to_lidar_height: float = None,
        xy_eigen_dist: int = None,
        z_eigen_dist: int = None,
        *,
        config: Optional[GvomConfig] = None,
        device="cuda",
    ):
        if config is None:
            kw = dict(
                xy_resolution=xy_resolution,
                z_resolution=z_resolution,
                xy_size=xy_size,
                z_size=z_size,
                buffer_size=buffer_size,
                min_distance=min_distance,
                positive_obstacle_threshold=positive_obstacle_threshold,
                negative_obstacle_threshold=negative_obstacle_threshold,
                slope_obstacle_threshold=slope_obstacle_threshold,
                robot_height=robot_height,
                robot_radius=robot_radius,
                ground_to_lidar_height=ground_to_lidar_height,
                xy_eigen_dist=xy_eigen_dist,
                z_eigen_dist=z_eigen_dist,
            )
            config = GvomConfig().replace(**{k: v for k, v in kw.items() if v is not None})
        self.config = config.validate()
        self.device = resolve_device(device)
        self._lock = threading.Lock()          # state: buffer writes, world swaps
        self._combine_lock = threading.Lock()  # serializes combines with each other
        self._buffer: BufferState = empty_buffer_state(self.config, self.device)
        self._world: WorldState = empty_world_state(self.config, self.device)
        self._products = None
        self._scan_count = 0
        self.ego_position = np.zeros(3)
        self.metrics = StepMetrics()

    # ------------------------------------------------------------------
    def _pad(self, pc: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        cap = self.config.max_points
        n = pc.shape[0]
        if n > cap:
            # the reference processes every point (gvom.py:99-110); a
            # fixed-capacity engine must truncate — account for it loudly
            dropped = n - cap
            self.metrics.bump("points_truncated", dropped)
            self.metrics.bump("scans_truncated")
            print(
                f"[WARNING] Scan has {n} points but max_points={cap}; "
                f"dropping {dropped}. Raise GvomConfig.max_points to keep them."
            )
            pc = pc[:cap]
            n = cap
        out = np.zeros((cap, 3), np.float32)
        out[:n] = pc[:n, :3]
        mask = np.zeros((cap,), bool)
        mask[:n] = True
        return out, mask

    def process_pointcloud(self, pointcloud: np.ndarray, ego_position, transform=None):
        """Voxelize one scan into the ring buffer (gvom.py:99-175). Returns
        scan_ok as a device tensor (no host sync), or None for an empty
        cloud."""
        pc = np.asarray(pointcloud)
        if pc.shape[0] == 0:
            print("[WARNING] Processing an empty pointcloud, nothing will happen!")
            return None
        pts, mask = self._pad(pc)
        dev = self.device
        pts_t = torch.from_numpy(pts).to(dev)
        mask_t = torch.from_numpy(mask).to(dev)
        ego = torch.from_numpy(np.asarray(ego_position, np.float32).copy()).to(dev)
        tf = None if transform is None else torch.from_numpy(np.asarray(transform, np.float32).copy()).to(dev)
        with self._lock:
            self.ego_position = np.asarray(ego_position, np.float64)
            _, scan_ok = pipeline.ingest_and_insert(self.config, self._buffer, pts_t, mask_t, ego, tf)
            self._scan_count += 1
        self.metrics.bump("scans_ingested")
        return scan_ok

    def combine_maps(self):
        """Fuse the buffer and the previous map and return the five outputs
        (gvom.py:177-354): (origin_world, positive, negative, roughness,
        visibility) as numpy arrays, or None when the buffer is empty."""
        with self._combine_lock:
            with self._lock:
                if self._scan_count == 0:
                    print("[WARNING] The map buffer is empty, nothing will happen!")
                    return None
                ego = torch.from_numpy(self.ego_position.astype(np.float32)).to(self.device)
                world, products, ok = pipeline.combine(self.config, self._buffer, self._world, ego)
            if not bool(ok):  # the one host sync, outside the state lock
                print("[WARNING] The map buffer is empty, nothing will happen!")
                return None
            with self._lock:
                self._world = world
                self._products = products
            self.metrics.bump("combines")
        origin_world = products.origin_world(self.config)
        pos, neg, rough, vis = (t.cpu().numpy() for t in (
            products.positive_obstacle, products.negative_obstacle, products.roughness, products.visibility))
        return (origin_world, pos, neg, rough, vis)

    # ------------------------------------------------------------------
    def get_map_as_occupancy_grid(self) -> Optional[np.ndarray]:
        """[X,Y,Z] bool occupancy of the last combined map, window layout
        (gvom.py:356-361)."""
        if self._products is None:
            return None
        with self._lock:
            g = self._world.grid
            occ = (g.hit > 0).cpu().numpy()
            origin = g.origin.cpu().numpy()
        for ax in range(3):
            occ = np.roll(occ, -int(origin[ax]) % occ.shape[ax], axis=ax)
        return occ
