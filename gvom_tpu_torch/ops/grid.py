"""Grid geometry: origins, voxel indexing, torus layout, exact f32 rounding.

The reference's ego-centered scrolling-window convention (gvom.py:123-126):
origin = floor(ego/res − size/2) per axis, in voxel units. Grid tensors store
world voxel w at index w mod size (the torus layout), so maps with different
origins align by per-axis masks and never move data.

Every function here runs on the device of its inputs and never syncs with the
host: origins stay tensors, and rolls by an origin are index gathers.
"""

from __future__ import annotations

import torch

from gvom_tpu_torch.config import GvomConfig

__all__ = [
    "fma32",
    "sqrt32",
    "resolution_vector",
    "inv_resolution_vector",
    "size_vector",
    "compute_origin",
    "map_local",
    "in_bounds",
    "overlap_axis_masks",
    "overlap_mask",
    "window_to_torus",
    "torus_to_window",
]


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 fused multiply-add a·b + c.

    The JAX package's reference arithmetic is what XLA compiles, and XLA
    contracts `a*b + c` (and `a/const − c`, after rewriting the division as
    a multiply by the f32 reciprocal) into one fused multiply-add. Floors of
    those values decide voxel rows, so the port rounds the same expressions
    once, too. PyTorch has no fma operator; this one is exact: the float64
    product of two float32 values is exact, the float64 sum is made
    round-to-odd (TwoSum error, then nudge an even result toward the error),
    and rounding that to float32 is then the correctly rounded fma, because
    float64 carries more than 2·24 + 2 bits."""
    a64 = a.double()
    b64 = b.double() if torch.is_tensor(b) else torch.tensor(float(b), dtype=torch.float64, device=a.device)
    c64 = c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.full_like(s, float("inf")), torch.full_like(s, float("-inf")))
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root. PyTorch's vectorized CPU
    float32 sqrt can be one ulp off; the float64 root of a float32 value,
    rounded to float32, is the correctly rounded one (53 ≥ 2·24 + 2 bits),
    on every device."""
    return torch.sqrt(x.double()).float()


def resolution_vector(cfg: GvomConfig, device) -> torch.Tensor:
    return torch.tensor([cfg.xy_resolution, cfg.xy_resolution, cfg.z_resolution],
                        dtype=torch.float32, device=device)


def inv_resolution_vector(cfg: GvomConfig, device) -> torch.Tensor:
    """f32(1 / res): the constant XLA multiplies by where the reference
    divides by the resolution."""
    return torch.reciprocal(resolution_vector(cfg, device))


def size_vector(cfg: GvomConfig, device) -> torch.Tensor:
    return torch.tensor([cfg.xy_size, cfg.xy_size, cfg.z_size], dtype=torch.int32, device=device)


def compute_origin(cfg: GvomConfig, ego_position: torch.Tensor) -> torch.Tensor:
    """Grid origin in voxel units (gvom.py:123-126): floor(ego/res − size/2)."""
    dev = ego_position.device
    half = torch.tensor([cfg.xy_size / 2.0, cfg.xy_size / 2.0, cfg.z_size / 2.0],
                        dtype=torch.float32, device=dev)
    e = ego_position.float()
    return torch.floor(fma32(e, inv_resolution_vector(cfg, dev), -half)).to(torch.int32)


def map_local(cfg: GvomConfig, points: torch.Tensor, origin: torch.Tensor) -> torch.Tensor:
    """[N,3] map-local voxel coordinates points/res − origin (float32)."""
    dev = points.device
    inv = inv_resolution_vector(cfg, dev).expand_as(points)
    return fma32(points, inv, -origin.float().expand_as(points))


def in_bounds(cfg: GvomConfig, vox: torch.Tensor) -> torch.Tensor:
    size = size_vector(cfg, vox.device)
    return torch.all((vox >= 0) & (vox < size), dim=-1)


def overlap_axis_masks(cfg: GvomConfig, o_target: torch.Tensor, o_source: torch.Tensor):
    """Per-axis bool factors [X], [Y], [Z] of overlap_mask."""
    out = []
    for ax, size in enumerate(cfg.grid_shape):
        i = torch.arange(size, dtype=torch.int32, device=o_target.device)
        rel_t = torch.remainder(i - o_target[ax], size)
        d = o_target[ax] - o_source[ax]
        out.append((rel_t >= -torch.clamp(d, max=0)) & (rel_t < size - torch.clamp(d, min=0)))
    return out


def overlap_mask(cfg: GvomConfig, o_target: torch.Tensor, o_source: torch.Tensor) -> torch.Tensor:
    """[X,Y,Z] bool: torus cells where the source's stored world voxel equals
    the target window's world voxel (the two windows' overlap)."""
    mx, my, mz = overlap_axis_masks(cfg, o_target, o_source)
    return mx[:, None, None] & my[None, :, None] & mz[None, None, :]


def _roll_index(size: int, shift: torch.Tensor, device) -> torch.Tensor:
    i = torch.arange(size, dtype=torch.int64, device=device)
    return torch.remainder(i - shift.to(torch.int64), size)


def window_to_torus(arr: torch.Tensor, origin: torch.Tensor, grid_ndim: int = 3) -> torch.Tensor:
    """torus[(r + o) mod size] = window[r] along the trailing grid axes."""
    for k in range(grid_ndim):
        ax = arr.ndim - grid_ndim + k
        arr = arr.index_select(ax, _roll_index(arr.shape[ax], origin[k], arr.device))
    return arr


def torus_to_window(arr: torch.Tensor, origin: torch.Tensor, grid_ndim: int = 3) -> torch.Tensor:
    """Inverse of window_to_torus: window[r] = torus[(r + o) mod size]."""
    for k in range(grid_ndim):
        ax = arr.ndim - grid_ndim + k
        arr = arr.index_select(ax, _roll_index(arr.shape[ax], -origin[k], arr.device))
    return arr
