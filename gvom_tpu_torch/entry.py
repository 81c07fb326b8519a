"""The port's single-step entry point (the counterpart of __graft_entry__.entry).

    fn, args = entry()              # on the CUDA GPU
    fn, args = entry(device="cpu")  # the plain versions on the CPU
    positive, negative, roughness, visibility = fn(*args)

fn(buf, world, points, valid, ego) runs one pipeline.full_step (ingest one
scan into the ring buffer, then combine) on a small configuration (a
64×64×32 grid, 4,096 points, a buffer of 2) and returns four of its map
products. The example arguments are an empty buffer and world and one
synthetic scan of the composite terrain (32 × 64 beams, range 25 m). The
buffer is updated in place, so each call of fn on the same arguments ingests
the scan once more.
"""

from __future__ import annotations

import numpy as np
import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.io import synthetic
from gvom_tpu_torch.models import pipeline
from gvom_tpu_torch.types import empty_buffer_state, empty_world_state, resolve_device

__all__ = ["entry", "small_cfg"]


def small_cfg() -> GvomConfig:
    return GvomConfig(xy_size=64, z_size=32, max_points=4096, buffer_size=2)


def entry(device="cuda"):
    """(fn, example_args) on `device`; see the module docstring."""
    dev = resolve_device(device)
    cfg = small_cfg()
    ego = np.array([0.3, -0.2, 1.5], np.float32)
    pts = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), ego, channels=32, azimuth_steps=64,
                                        max_range=25.0)
    pad, mask = synthetic.pad_scan(pts, cfg.max_points)

    def fn(buf, world, points, valid, ego_position):
        buf, world, products, ok = pipeline.full_step(cfg, buf, world, points, valid, ego_position)
        return products.positive_obstacle, products.negative_obstacle, products.roughness, products.visibility

    example_args = (
        empty_buffer_state(cfg, dev),
        empty_world_state(cfg, dev),
        torch.from_numpy(pad).to(dev),
        torch.from_numpy(mask).to(dev),
        torch.from_numpy(ego).to(dev),
    )
    return fn, example_args
