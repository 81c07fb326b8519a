"""gvom_tpu_torch — the PyTorch/CUDA port of gvom_tpu for an NVIDIA H100.

Plain tensor code is PyTorch; the main path's hot loops are CUDA C++ kernels
written by hand for sm_90a (gvom_tpu_torch/csrc, built at first use by
gvom_tpu_torch/ops/kernels.py). The port imports torch and numpy only, never
jax and nothing of gvom_tpu.

Public API:
    GvomConfig  — frozen configuration
    Gvom        — reference-shaped engine facade (process_pointcloud /
                  combine_maps / get_map_as_occupancy_grid / the debug
                  exporters / reset / checkpoints); runs on the GPU unless
                  device="cpu" is passed
    VoxelMapperNode, MapLayers
                — the live host node: sensor callbacks, a combine timer and
                  the published layers (gvom_tpu_torch.ros wraps it in ROS)
    pipeline    — the functions under the facade (ingest_scan,
                  ingest_and_insert, combine, full_step)
    pipelines   — the package gvom_tpu_torch.models, which re-exports them
                  (the JAX package's name; `import gvom_tpu_torch.pipelines`
                  works too)
    make_batched_step, batched_step
                — a batch of (scan, ego) pairs fused into the world per step
    sequential_replay, batched_replay
                — scan-log replay functions (io.logio holds the log format,
                  io.rosbag reads bags, utils.checkpoint the world snapshots)

Command line: python -m gvom_tpu_torch.cli {replay,convert-bag,parity,selftest};
the bench: python -m gvom_tpu_torch.bench; the single-step entry point:
gvom_tpu_torch.entry.entry(); the NumPy oracle: gvom_tpu_torch.oracle.
"""

import sys as _sys

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.engine.gvom import Gvom
from gvom_tpu_torch.engine.node import MapLayers, VoxelMapperNode
from gvom_tpu_torch.engine.replay import batched_replay, sequential_replay
from gvom_tpu_torch import models as pipelines
from gvom_tpu_torch.models import pipeline
from gvom_tpu_torch.parallel.sharding import batched_step, make_batched_step

# make `import gvom_tpu_torch.pipelines` work, not just attribute access
_sys.modules[__name__ + ".pipelines"] = pipelines

__version__ = "0.1.0"

__all__ = ["GvomConfig", "Gvom", "VoxelMapperNode", "MapLayers", "pipeline", "pipelines", "make_batched_step",
           "batched_step", "sequential_replay", "batched_replay", "__version__"]
