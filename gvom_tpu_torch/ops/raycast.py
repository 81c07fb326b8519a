"""Free-space ray accumulation (the reference's DDA march, gvom.py:1091-1150).

Every kept point traces a ray from the ego toward the point in voxel units,
stepping so the dominant axis advances exactly one voxel per step, adding one
to the pass count of each traversed voxel, and stopping once the accumulated
step length reaches ray_length − 1. Step k's position is start + k·step, an
affine function of k, so out-of-grid steps are simply not counted.

On the GPU the geometry and the march are kernel K1 (ops/kernels.py,
csrc/raycast.cu), one launch for S scans. Its plain twin, `pass_counts_plain`,
runs `ray_geometry` and `march_inputs` and then `ray_pass_counts_plain` for
each scan. Both follow three exactness rules of the JAX package
(gvom_tpu/ops/raycast.py), so the counts agree bit for bit:
  * the dominant step is exactly ±1;
  * the dominant row is the integer floor(start_rel) ± k, never floor(start + k);
  * a position is one fused multiply-add, fma(k, step, start_rel), as every
    JAX path computes it (XLA:CPU contracts the product into the add through
    its optimization_barrier, and the Pallas kernel in interpret mode does
    the same); liveness is fl((k−1)·delta) < budget, with no add to contract.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import grid as gridops
from gvom_tpu_torch.ops.binning import check_y_window, sum_sq3

__all__ = ["RayMarch", "ray_geometry", "march_inputs", "ray_pass_counts_plain", "pass_counts_plain",
           "ray_pass_counts"]


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


def ray_pass_counts_plain(cfg: GvomConfig, m: RayMarch, origin: torch.Tensor, y_window=None,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[X,Y,Z] int32 pass counts in the torus layout — the plain twin of K1,
    one vectorized step at a time like ray_pass_counts_xla.

    y_window = (ys0, Ys): only the torus rows [ys0, ys0+Ys), as [X,Ys,Z]; a
    slab row is ty = vt_y − ys0 ∈ [0, Ys), no wrap. `out` is a grid of that
    shape to add the counts into (the batched step adds every scan's passes
    into one miss grid); it is returned."""
    dev = m.step.device
    X, Y, Z = cfg.grid_shape
    ys0, Ys = check_y_window(cfg, y_window)
    size = gridops.size_vector(cfg, dev)
    axes = torch.arange(3, device=dev)
    is_dom = axes[None, :] == m.dom[:, None].long()
    s_dom = m.step.gather(1, m.dom[:, None].long())[:, 0]
    sgn = torch.where(s_dom < 0, -1, 1).to(torch.int32)
    x0_dom = m.start_i[m.dom.long()]
    if out is None:
        out = torch.zeros((X, Ys, Z), dtype=torch.int32, device=dev)
    acc = out.view(-1)
    for k in range(1, cfg.ray_steps + 1):
        kf = float(k)
        pos = gridops.fma32(m.step, kf, m.start_rel[None, :].expand_as(m.step))
        vox = torch.floor(pos).to(torch.int32)
        vox = torch.where(is_dom, (x0_dom + k * sgn)[:, None], vox)
        inb = torch.all((vox >= 0) & (vox < size[None, :]), dim=1)
        act = ((kf - 1.0) * m.delta < m.budget) & inb
        vt = torch.remainder(vox + origin[None, :], size[None, :]).long()
        ty = vt[:, 1] - ys0
        act = act & (ty >= 0) & (ty < Ys)
        flat = (vt[:, 0] * Ys + ty) * Z + vt[:, 2]
        acc.index_put_((torch.where(act, flat, 0),), act.to(torch.int32), accumulate=True)
    return out


def pass_counts_plain(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, egos: torch.Tensor,
                      origin: torch.Tensor, y_window=None, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain twin of kernel K1's signature: S scans (points [S,N,3],
    keep [S,N], egos [S,3]) at one origin, each scan's march inputs built
    and marched in turn, all added into one [X,Ys,Z] grid."""
    if out is None:
        X, _, Z = cfg.grid_shape
        out = torch.zeros((X, check_y_window(cfg, y_window)[1], Z), dtype=torch.int32, device=points.device)
    for s in range(points.shape[0]):
        m = march_inputs(cfg, points[s], keep[s], egos[s], origin)
        ray_pass_counts_plain(cfg, m, origin, y_window, out)
    return out


def ray_pass_counts(cfg: GvomConfig, points, keep, ego_position, origin, y_window=None,
                    out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[X,Ys,Z] int32 pass counts of one scan (points [N,3], keep [N], its
    ego [3]), torus layout: kernel K1 for CUDA tensors, the plain version
    for CPU tensors. y_window and out as in ray_pass_counts_plain."""
    from gvom_tpu_torch.ops import kernels

    return kernels.ray_pass_counts(cfg, points[None].contiguous(), keep[None].contiguous(),
                                   ego_position.float().reshape(1, 3).contiguous(), origin,
                                   y_window=y_window, out=out)
