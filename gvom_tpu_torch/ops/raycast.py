"""Free-space ray accumulation (the reference's DDA march, gvom.py:1091-1150).

Every kept point traces a ray from the ego toward the point in voxel units,
stepping so the dominant axis advances exactly one voxel per step, adding one
to the pass count of each traversed voxel, and stopping once the accumulated
step length reaches ray_length − 1. Step k's position is start + k·step, an
affine function of k, so out-of-grid steps are simply not counted.

`ray_geometry` and `march_inputs` run in PyTorch on either device; the march
itself is kernel K1 on the GPU (ops/kernels.py, csrc/raycast.cu) and
`ray_pass_counts_plain` on the CPU. Both follow three exactness rules of the
JAX package (gvom_tpu/ops/raycast.py), so the counts agree bit for bit:
  * the dominant step is exactly ±1;
  * the dominant row is the integer floor(start_rel) ± k, never floor(start + k);
  * position and liveness round the product before the add:
    start_rel + fl(k·step) and fl((k−1)·delta) < budget.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import grid as gridops
from gvom_tpu_torch.ops.binning import sum_sq3

__all__ = ["RayMarch", "ray_geometry", "march_inputs", "ray_pass_counts_plain", "ray_pass_counts"]


def ray_geometry(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, ego_position: torch.Tensor):
    """Per-ray march parameters (start [3], step [N,3], delta [N], budget [N],
    dom [N] int32, length [N]); step k (1-based) is taken iff
    (k−1)·delta < budget. Rounded as the reference's compiled arithmetic:
    the division by the resolution is a multiply by its f32 reciprocal, and
    end − start and the squared length are fused multiply-adds."""
    inv = gridops.inv_resolution_vector(cfg, points.device)
    start = ego_position.float() * inv
    slope = gridops.fma32(points, inv.expand_as(points), -start.expand_as(points))
    length = gridops.sqrt32(sum_sq3(slope))
    ok = keep & (length > 0)
    one = torch.ones_like(length)
    s = torch.where(ok[:, None], slope / torch.where(length > 0, length, one)[:, None],
                    torch.zeros_like(slope))
    a = s.abs()
    smax = a.amax(dim=1)
    dom = torch.where(smax == a[:, 2], 2, torch.where(smax == a[:, 1], 1, 0)).to(torch.int32)
    ok = ok & (smax > 0)
    safe = torch.where(smax > 0, smax, one)
    step = s / safe[:, None]
    # the dominant component is mathematically ±1 — force it exactly
    axes = torch.arange(3, device=points.device)
    step = torch.where(axes[None, :] == dom[:, None], torch.sign(s), step)
    delta = 1.0 / safe
    budget = torch.where(ok, length - 1.0, -one)
    return start, step, delta, budget, dom, length


class RayMarch(NamedTuple):
    """What the march needs, in map-local voxel units."""

    start_rel: torch.Tensor  # [3] f32 — ego/res − origin
    start_i: torch.Tensor    # [3] int32 — floor(start_rel)
    step: torch.Tensor       # [N,3] f32
    delta: torch.Tensor      # [N] f32
    budget: torch.Tensor     # [N] f32
    dom: torch.Tensor        # [N] int32


def march_inputs(cfg: GvomConfig, points, keep, ego_position, origin) -> RayMarch:
    _, step, delta, budget, dom, _ = ray_geometry(cfg, points, keep, ego_position)
    inv = gridops.inv_resolution_vector(cfg, points.device)
    # start − origin in one rounding, as the reference's compiled start_rel
    start_rel = gridops.fma32(ego_position.float(), inv, -origin.float())
    start_i = torch.floor(start_rel).to(torch.int32)
    return RayMarch(start_rel, start_i, step.contiguous(), delta.contiguous(),
                    budget.contiguous(), dom.contiguous())


def ray_pass_counts_plain(cfg: GvomConfig, m: RayMarch, origin: torch.Tensor) -> torch.Tensor:
    """[X,Y,Z] int32 pass counts in the torus layout — the plain twin of K1,
    one vectorized step at a time like ray_pass_counts_xla."""
    dev = m.step.device
    X, Y, Z = cfg.grid_shape
    size = gridops.size_vector(cfg, dev)
    axes = torch.arange(3, device=dev)
    is_dom = axes[None, :] == m.dom[:, None].long()
    s_dom = m.step.gather(1, m.dom[:, None].long())[:, 0]
    sgn = torch.where(s_dom < 0, -1, 1).to(torch.int32)
    x0_dom = m.start_i[m.dom.long()]
    acc = torch.zeros(X * Y * Z, dtype=torch.int32, device=dev)
    for k in range(1, cfg.ray_steps + 1):
        kf = float(k)
        pos = m.start_rel[None, :] + kf * m.step
        vox = torch.floor(pos).to(torch.int32)
        vox = torch.where(is_dom, (x0_dom + k * sgn)[:, None], vox)
        inb = torch.all((vox >= 0) & (vox < size[None, :]), dim=1)
        act = ((kf - 1.0) * m.delta < m.budget) & inb
        vt = torch.remainder(vox + origin[None, :], size[None, :]).long()
        flat = (vt[:, 0] * Y + vt[:, 1]) * Z + vt[:, 2]
        acc.index_put_((torch.where(act, flat, 0),), act.to(torch.int32), accumulate=True)
    return acc.view(X, Y, Z)


def ray_pass_counts(cfg: GvomConfig, points, keep, ego_position, origin) -> torch.Tensor:
    """[X,Y,Z] int32 pass counts of one scan, torus layout: kernel K1 for CUDA
    tensors, the plain version for CPU tensors."""
    from gvom_tpu_torch.ops import kernels

    m = march_inputs(cfg, points, keep, ego_position.float(), origin)
    return kernels.ray_pass_counts(cfg, m, origin)
