"""Host pipeline node — the ROS-free equivalent of the reference's
VoxelMapper (gvom_ros.py:14-199), the port's copy of gvom_tpu/engine/node.py.

Wires sensor callbacks and a combine timer to the engine, and derives the
published layer set from the five raw outputs with the reference node's exact
math (gvom_ros.py:141-166):

    hard      = max(100·(pos > density_threshold), neg)
    soft      = 100·(0 < pos ≤ density_threshold)
    ground / all-ground certainty = visibility·100
    negative  = neg
    roughness = ((clamp(r, min_r, max_r) + min_roughness) /
                 (max_roughness − min_roughness))·100
                (the reference *adds* min_roughness — quirk preserved)

Publishers are plain callables, so the same node drives ROS topics
(gvom_tpu_torch.ros), logging, files, or tests. Sensor threads call
`on_pointcloud`, a timer thread drives `publish_maps` (combine); the engine
facade's locks replace the reference's per-slot semaphores, and the facade
keeps every thread's device work on one CUDA stream. An exception in the
timer thread ends its loop, is counted in `metrics` ("timer_errors") and is
raised again by `stop()`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional

import numpy as np

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.engine.gvom import Gvom
from gvom_tpu_torch.utils.metrics import StepMetrics
from gvom_tpu_torch.utils.profiling import annotate

__all__ = ["MapLayers", "VoxelMapperNode"]

Publisher = Callable[[str, np.ndarray, Dict], None]


class MapLayers:
    """One combine's derived outputs (reference topic set, gvom_ros.py:64-70)."""

    def __init__(self, origin, layers: Dict[str, np.ndarray]):
        self.origin = origin
        self.layers = layers

    def __getitem__(self, k):
        return self.layers[k]

    def keys(self):
        return self.layers.keys()


class VoxelMapperNode:
    """The engine behind sensor callbacks and a combine timer. Runs on the
    CUDA GPU unless `device="cpu"` is passed."""

    def __init__(
        self,
        config: Optional[GvomConfig] = None,
        publisher: Optional[Publisher] = None,
        device="cuda",
        **param_overrides,
    ):
        if config is None:
            config = GvomConfig.from_dict(param_overrides) if param_overrides else GvomConfig()
        self.config = config
        self.engine = Gvom(config=config, device=device)
        self.publisher = publisher or (lambda topic, data, meta: None)
        self.odom_data: Optional[np.ndarray] = None
        self.metrics = StepMetrics()
        self._timer: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._timer_error: Optional[BaseException] = None
        self.last_layers: Optional[MapLayers] = None

    # --- callbacks (reference cb_odom / cb_lidar, gvom_ros.py:79-109) ---
    def on_odometry(self, position) -> None:
        self.odom_data = np.asarray(position, dtype=np.float64)

    def on_pointcloud(self, points: np.ndarray, transform: Optional[np.ndarray] = None) -> bool:
        if self.odom_data is None:
            print("no odom")
            return False
        t0 = time.perf_counter()
        self.engine.process_pointcloud(points, self.odom_data, transform)
        self.metrics.record("ingest_s", time.perf_counter() - t0)
        self.metrics.bump("scans")
        return True

    # --- combine + publish (reference cb_timer, gvom_ros.py:113-189) ---
    def publish_maps(self) -> Optional[MapLayers]:
        t0 = time.perf_counter()
        out = self.engine.combine_maps()
        if out is None:
            return None
        self.metrics.record("combine_s", time.perf_counter() - t0)
        self.metrics.bump("combines")
        origin, pos, neg, rough, vis = out
        cfg = self.config
        hard = np.maximum(100 * (pos > cfg.density_threshold), neg).astype(np.int8)
        soft = (100 * (pos <= cfg.density_threshold) * (pos > 0)).astype(np.int8)
        cert = (vis * 100).astype(np.int8)
        # reference quirk preserved: adds min_roughness (gvom_ros.py:163)
        rnorm = (
            (np.maximum(np.minimum(rough, cfg.max_roughness), cfg.min_roughness) + cfg.min_roughness)
            / (cfg.max_roughness - cfg.min_roughness)
        ) * 100
        layers = MapLayers(
            origin,
            {
                "hard_obstacle_map": hard,
                "soft_obstacle_map": soft,
                "positive_obstacle_map": pos,
                "negative_obstacle_map": neg.astype(np.int8),
                "ground_certainty_map": cert,
                "all_ground_certainty_map": cert,
                "roughness_map": rnorm.astype(np.int8),
            },
        )
        meta = {"origin": origin, "resolution": cfg.xy_resolution, "width": cfg.xy_size}
        for name, data in layers.layers.items():
            self.publisher(name, data, meta)
        self.last_layers = layers
        return layers

    # reference channel names, gvom_ros.py:170-189 (debug/lidar is declared
    # but never published by the reference — same here, surface parity)
    DEBUG_CHANNELS = {
        "debug/voxel": ["x", "y", "z", "solid factor", "count",
                        "eigen_line", "eigen_surface", "eigen_point"],
        "debug/height_map": ["x", "y", "z", "roughness", "slope_x", "slope_y",
                             "slope", "obstacles"],
        "debug/inferred_height_map": ["x", "y", "z"],
    }

    def publish_debug(self) -> None:
        for name, fn in (
            ("debug/voxel", self.engine.make_debug_voxel_map),
            ("debug/height_map", self.engine.make_debug_height_map),
            ("debug/inferred_height_map", self.engine.make_debug_inferred_height_map),
        ):
            with annotate("gvom/export"):
                data = fn()
            if data is None:
                continue
            if name == "debug/height_map" and self.last_layers is not None:
                # reference appends the positive-obstacle map as an extra
                # channel, Fortran-flattened (gvom_ros.py:180)
                obs = np.reshape(
                    self.last_layers["positive_obstacle_map"], -1, order="F"
                ).astype(np.float32)
                data = np.concatenate([data, obs[:, None]], axis=1)
            else:
                data = np.asarray(data, np.float32)
            names = list(self.DEBUG_CHANNELS[name])
            if data.shape[1] != len(names):  # height map without an obs layer yet
                names = names[: data.shape[1]]
            self.publisher(name, data, {"channels": names})

    # --- timer loop (reference rospy.Timer at `freq`, gvom_ros.py:72) ---
    def start(self) -> None:
        """Start the timer thread: publish_maps every 1/combine_freq s."""
        if self._timer is not None:
            return
        self._stop.clear()
        self._timer_error = None
        period = 1.0 / self.config.combine_freq

        def loop():
            try:
                while not self._stop.wait(period):
                    self.publish_maps()
            except BaseException as e:  # raised again by stop()
                self.metrics.bump("timer_errors")
                self._timer_error = e

        self._timer = threading.Thread(target=loop, name="gvom-timer", daemon=True)
        self._timer.start()

    def stop(self) -> None:
        """Stop the timer thread and join it (at most 5 s). Raises what the
        timer thread raised, and RuntimeError if it did not end."""
        self._stop.set()
        timer, self._timer = self._timer, None
        if timer is not None:
            timer.join(timeout=5.0)
            if timer.is_alive():
                raise RuntimeError("the timer thread did not end within 5 s")
        err, self._timer_error = self._timer_error, None
        if err is not None:
            raise err
