"""Device compute ops: plain PyTorch on the CPU, the hand-written CUDA
kernels of ops/kernels.py on a card. Importing them builds and loads no
kernel: a kernel's library is built at its first launch."""

from gvom_tpu_torch.ops import binning, grid, maps2d, moments, raycast  # noqa: F401
