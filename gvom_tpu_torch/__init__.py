"""gvom_tpu_torch — the PyTorch/CUDA port of gvom_tpu for an NVIDIA H100.

Plain tensor code is PyTorch; the main path's hot loops are CUDA C++ kernels
written by hand for sm_90a (gvom_tpu_torch/csrc, built at first use by
gvom_tpu_torch/ops/kernels.py). The port imports torch and numpy only, never
jax and nothing of gvom_tpu.

Public API:
    GvomConfig  — frozen configuration
    Gvom        — reference-shaped engine facade (process_pointcloud /
                  combine_maps / get_map_as_occupancy_grid); runs on the GPU
                  unless device="cpu" is passed
    pipeline    — the functions under the facade (ingest_and_insert, combine,
                  full_step)
"""

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.engine.gvom import Gvom
from gvom_tpu_torch.models import pipeline

__all__ = ["GvomConfig", "Gvom", "pipeline"]
