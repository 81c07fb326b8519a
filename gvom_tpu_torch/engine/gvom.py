"""Reference-shaped engine facade.

API parity with the reference class (gvom.py:12-410) and with
gvom_tpu/engine/gvom.py: the same constructor signature, `process_pointcloud`,
`combine_maps` (the same 5-tuple), `get_map_as_occupancy_grid`, the three
debug exporters, `reset` and the world checkpoints.

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

Every method that touches the card (ingest, combine, the exporters, reset
and the checkpoints) enqueues its device work, copies and allocations
included, on the CUDA stream that was current when the facade was made,
whatever thread calls it: the kernels are launched on the current stream,
and a thread that had set another one would otherwise race the in-place
buffer writes against the combine, or a reset's fresh buffer against the
next ingest.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.models import pipeline
from gvom_tpu_torch.ops import kernels, moments
from gvom_tpu_torch.types import (BufferState, MapProducts, WorldState, empty_buffer_state, empty_world_state,
                                  resolve_device)
from gvom_tpu_torch.utils.checkpoint import load_world, save_world
from gvom_tpu_torch.utils.metrics import StepMetrics
from gvom_tpu_torch.utils.profiling import annotate

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
        self._stream = None
        if self.device.type == "cuda":
            kernels.check_card_limits(self.config)
            kernels.build_all(self.config)     # nvcc at start-up, never on the map path
            self._stream = torch.cuda.current_stream(self.device)
        self._lock = threading.Lock()          # state: buffer writes, world swaps
        self._combine_lock = threading.Lock()  # serializes combines with each other
        self._buffer: BufferState = empty_buffer_state(self.config, self.device)
        self._world: WorldState = empty_world_state(self.config, self.device)
        self._products = None
        self._scan_count = 0
        self._calls = itertools.count()        # the ids of the ingest and combine spans
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
        with annotate("gvom/ingest", next(self._calls)):
            pc = np.asarray(pointcloud)
            if pc.shape[0] == 0:
                print("[WARNING] Processing an empty pointcloud, nothing will happen!")
                return None
            pts, mask = self._pad(pc)
            dev = self.device
            with self._on_stream():
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
        with annotate("gvom/combine", next(self._calls)), self._on_stream():
            with self._combine_lock:
                with self._lock:
                    if self._scan_count == 0:
                        print("[WARNING] The map buffer is empty, nothing will happen!")
                        return None
                    ego = torch.from_numpy(self.ego_position.astype(np.float32)).to(self.device)
                    world, products, ok = pipeline.combine(self.config, self._buffer, self._world, ego)
                with annotate("gvom/combine/sync"):
                    ok = bool(ok)  # the one host sync, outside the state lock
                if not ok:
                    print("[WARNING] The map buffer is empty, nothing will happen!")
                    return None
                with self._lock:
                    self._world = world
                    self._products = products
                self.metrics.bump("combines")
            with annotate("gvom/combine/to_host"):
                origin_world = products.origin_world(self.config)
                pos, neg, rough, vis = (t.cpu().numpy() for t in (
                    products.positive_obstacle, products.negative_obstacle, products.roughness,
                    products.visibility))
        return (origin_world, pos, neg, rough, vis)

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    # ------------------------------------------------------------------
    def get_map_as_occupancy_grid(self) -> Optional[np.ndarray]:
        """[X,Y,Z] bool occupancy of the last combined map, window layout
        (gvom.py:356-361)."""
        if self._products is None:
            return None
        with self._on_stream(), self._lock:
            g = self._world.grid
            occ = (g.hit > 0).cpu().numpy()
            origin = g.origin.cpu().numpy()
        for ax in range(3):
            occ = np.roll(occ, -int(origin[ax]) % occ.shape[ax], axis=ax)
        return occ

    def make_debug_voxel_map(self) -> Optional[np.ndarray]:
        """[K,8] per occupied voxel: world xyz, hit/total density, hit count,
        eigen features λ0−λ1, λ1−λ2, λ2 (gvom.py:363-378, 452-475). Rows are
        in voxel-linear order on the window layout, as the JAX package's.
        The voxels are gathered on the device and the eigenvalues computed
        at those voxels only; the other columns take the JAX package's host
        arithmetic."""
        if self._products is None:
            print("No data")
            return None
        cfg = self.config
        with self._lock:   # the world is swapped, never written in place: a snapshot suffices
            g = self._world.grid
        with self._on_stream():
            origin_t = g.origin.long()
            occ = torch.roll(g.hit > 0, shifts=[-int(o) for o in origin_t.cpu()], dims=(0, 1, 2))
            win = torch.nonzero(occ)                                  # [K,3] window coordinates
            tor = (win + origin_t) % torch.tensor(cfg.grid_shape, device=win.device)
            xt, yt, zt = tor.unbind(1)
            hit = g.hit[xt, yt, zt]
            tot = hit + g.miss[xt, yt, zt]
            mom = g.mom[:, xt, yt, zt]
            ev = moments.eigenvalues(moments.covariance(mom[0], mom[1:4], mom[4:10]))
            xs, ys, zs = win.cpu().numpy().T
            origin = g.origin.cpu().numpy()
            hit, tot, e = hit.cpu().numpy().astype(np.float32), tot.cpu().numpy().astype(np.float32), ev.cpu().numpy()
        out = np.zeros((len(xs), 8), np.float32)
        if len(xs) == 0:
            return out
        out[:, 0] = (xs + origin[0]) * cfg.xy_resolution
        out[:, 1] = (ys + origin[1]) * cfg.xy_resolution
        out[:, 2] = (zs + origin[2]) * cfg.z_resolution
        out[:, 3] = hit / np.maximum(tot, 1.0)
        out[:, 4] = hit
        out[:, 5] = e[0] - e[1]
        out[:, 6] = e[1] - e[2]
        out[:, 7] = e[2]
        return out

    def _products_numpy(self, *names):
        with self._lock:
            p = self._products
        with self._on_stream():
            return (p.origin.cpu().numpy(),) + tuple(getattr(p, k).cpu().numpy() for k in names)

    def _columns_xy(self, n: int, origin: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """[X*X, n] output and its row index x + y·X with the world xy
        columns filled (gvom.py:424-438)."""
        cfg = self.config
        X = cfg.xy_size
        x, y = np.meshgrid(np.arange(X), np.arange(X), indexing="ij")
        out = np.zeros((X * X, n), np.float32)
        idx = (x + y * X).ravel()
        out[idx, 0] = ((x + origin[0]) * cfg.xy_resolution).ravel()
        out[idx, 1] = ((y + origin[1]) * cfg.xy_resolution).ravel()
        return out, idx

    def make_debug_height_map(self) -> Optional[np.ndarray]:
        """[X*X,7]: world xyz (height − z_res), roughness, slope_x, slope_y,
        |slope| (gvom.py:380-394, 424-438)."""
        if self._products is None:
            print("No data")
            return None
        origin, hm, sx, sy, rough = self._products_numpy("height", "slope_x", "slope_y", "roughness")
        out, idx = self._columns_xy(7, origin)
        out[idx, 2] = (hm - self.config.z_resolution).ravel()
        out[idx, 3] = rough.ravel()
        out[idx, 4] = sx.ravel()
        out[idx, 5] = sy.ravel()
        out[idx, 6] = np.sqrt(sx * sx + sy * sy).ravel()
        return out

    def make_debug_inferred_height_map(self) -> Optional[np.ndarray]:
        """[X*X,3]: world xy, guessed height delta − z_res (gvom.py:396-410)."""
        if self._products is None:
            print("No data")
            return None
        origin, ghd = self._products_numpy("guessed_height_delta")
        out, idx = self._columns_xy(3, origin)
        out[idx, 2] = (ghd - self.config.z_resolution).ravel()
        return out

    # ------------------------------------------------------------------
    @property
    def products(self) -> Optional[MapProducts]:
        return self._products

    @property
    def world_state(self) -> WorldState:
        return self._world

    def reset(self) -> None:
        """Forget every scan and the fused map. Takes the combine lock too,
        so an in-flight combine cannot swap a stale world back in; the ring
        buffer is a fresh one (ingest writes it in place), zero-filled on the
        facade's stream, which the next ingest writes it on."""
        with self._on_stream(), self._combine_lock, self._lock:
            self._buffer = empty_buffer_state(self.config, self.device)
            self._world = empty_world_state(self.config, self.device)
            self._products = None
            self._scan_count = 0

    # --- crash recovery: the fused world is the only state worth keeping;
    # the ring buffer refills from the live scan stream ----------------
    def save_checkpoint(self, path: str) -> str:
        """Snapshot the fused world state to an .npz file that both packages
        read (utils/checkpoint.py). Returns the path written."""
        with self._on_stream(), self._lock:
            return save_world(path, self._world, self.config)

    def load_checkpoint(self, path: str) -> None:
        """Restore a fused world snapshot; ingest and combine continue from
        it. Raises ValueError when its grid is not this configuration's."""
        with self._on_stream():
            world = load_world(path, self.device)
            if tuple(world.grid.hit.shape) != self.config.grid_shape:
                raise ValueError(
                    f"checkpoint grid {tuple(world.grid.hit.shape)} does not match "
                    f"config grid {self.config.grid_shape}"
                )
            with self._combine_lock, self._lock:
                self._world = world
