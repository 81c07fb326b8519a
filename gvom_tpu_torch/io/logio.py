"""Scan-log storage: sequences of (points, ego_pose, transform) triples.

Replaces the reference's "replay a rosbag" workflow with a plain .npz format
that needs no ROS. Used by the replay functions. The port's own copy of
gvom_tpu/io/logio.py (numpy only): the two packages read each other's logs.
"""

from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np

__all__ = ["ScanLog", "save_log", "load_log", "synthesize_log"]

Entry = Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]


class ScanLog:
    def __init__(self, entries: List[Entry]):
        self.entries = entries

    def __len__(self) -> int:
        return len(self.entries)

    def __iter__(self) -> Iterator[Entry]:
        return iter(self.entries)

    def __getitem__(self, i) -> Entry:
        return self.entries[i]


def save_log(path: str, log: ScanLog) -> str:
    arrs = {"n": np.asarray(len(log))}
    for i, (pts, ego, tf) in enumerate(log):
        arrs[f"pts_{i}"] = np.asarray(pts, np.float32)
        arrs[f"ego_{i}"] = np.asarray(ego, np.float64)
        if tf is not None:
            arrs[f"tf_{i}"] = np.asarray(tf, np.float64)
    np.savez_compressed(path, **arrs)
    return path


def load_log(path: str) -> ScanLog:
    with np.load(path) as z:
        n = int(z["n"])
        entries = []
        for i in range(n):
            tf = z[f"tf_{i}"] if f"tf_{i}" in z else None
            entries.append((z[f"pts_{i}"], z[f"ego_{i}"], tf))
    return ScanLog(entries)


def synthesize_log(
    n_scans: int,
    terrain=None,
    channels: int = 64,
    azimuth_steps: int = 1024,
    max_range: float = 60.0,
    speed: float = 2.0,
    dt: float = 0.1,
    seed: int = 0,
    start=(0.5, 0.0, 1.6),
) -> ScanLog:
    """A RELLIS-style drive: ego moves at `speed` m/s, one scan per `dt`."""
    from gvom_tpu_torch.io.synthetic import composite_terrain, simulate_lidar_scan

    terrain = terrain or composite_terrain()
    rng = np.random.default_rng(seed)
    ego = np.asarray(start, np.float64)
    heading = 0.3
    entries = []
    for i in range(n_scans):
        heading += rng.normal(scale=0.05)
        ego = ego + speed * dt * np.array([np.cos(heading), np.sin(heading), 0.0])
        ego[2] = terrain.height(ego[0], ego[1]) + 1.6
        pts = simulate_lidar_scan(
            terrain, ego, channels=channels, azimuth_steps=azimuth_steps,
            max_range=max_range, seed=seed * 1000 + i, coarse_step=0.5, refine_iters=12,
        )
        entries.append((pts.astype(np.float32), ego.copy(), None))
    return ScanLog(entries)
