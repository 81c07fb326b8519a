"""The benchmark's frozen copy of the port's plain PyTorch version of this stage, which the
benchmark's comparison holds the port against; it imports nothing of the port.

Free-space ray accumulation (the reference's DDA march, gvom.py:1091-1150).

Every kept point traces a ray from the ego toward the point in voxel units,
stepping so the dominant axis advances exactly one voxel per step, adding one
to the pass count of each traversed voxel, and stopping once the accumulated
step length reaches ray_length − 1. Step k's position is start + k·step, an
affine function of k, so out-of-grid steps are simply not counted.

`pass_counts_plain` marches every kept ray of S scans, each from its own
ego, into one grid. It follows three exactness rules of the JAX package
(gvom_tpu/ops/raycast.py), as the port's kernel does, so the counts agree
bit for bit:
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

from benchmark.reference.config import GvomConfig
from benchmark.reference import grid as gridops
from benchmark.reference.binning import sum_sq3

__all__ = ["RayMarch", "ray_geometry", "march_inputs", "pass_counts_plain"]


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


def pass_counts_plain(cfg: GvomConfig, points: torch.Tensor, keep: torch.Tensor, egos: torch.Tensor,
                      origin: torch.Tensor, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """S scans (points [S,N,3], keep [S,N], egos [S,3]) at one origin, all
    added into one [X,Y,Z] grid. Every kept ray of every scan marches in one
    vectorized pass: the counts are integer adds, so their order is free,
    and each ray's position is fma(k, step, start_rel) of its own scan's
    start."""
    if out is None:
        out = torch.zeros(cfg.grid_shape, dtype=torch.int32, device=points.device)
    parts = []
    for s in range(points.shape[0]):
        sel = keep[s]
        m = march_inputs(cfg, points[s][sel], sel[sel], egos[s], origin)
        n = m.step.shape[0]
        parts.append((m.start_rel.expand(n, 3), m.start_i.expand(n, 3), m))
    if not parts:
        return out
    start_rel = torch.cat([p[0] for p in parts]).contiguous()
    start_i = torch.cat([p[1] for p in parts])
    m = RayMarch(start_rel, start_i, *(torch.cat([getattr(p[2], f) for p in parts])
                                         for f in ("step", "delta", "budget", "dom")))
    return _march(cfg, m, origin, out)


def _march(cfg: GvomConfig, m: RayMarch, origin: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """The march of rays that each carry their own start_rel [R,3] and
    start_i [R,3]: step k (1-based) of a ray adds one pass to the voxel at
    floor(fma(k, step, start_rel)), its dominant axis the integer
    start_i ± k, when (k−1)·delta < budget and the voxel is in the grid;
    counts in the torus layout. A ray whose liveness test has failed fails it
    at every later step, so such rays leave the march every few steps; the
    counts are added by bincount (integer adds, in any order)."""
    dev = m.step.device
    X, Y, Z = cfg.grid_shape
    size = gridops.size_vector(cfg, dev)
    axes = torch.arange(3, device=dev)
    dom = m.dom[:, None].long()
    rays = dict(step=m.step, start_rel=m.start_rel, delta=m.delta, budget=m.budget,
                is_dom=axes[None, :] == dom, sgn=torch.where(m.step.gather(1, dom)[:, 0] < 0, -1, 1).to(torch.int32),
                x0_dom=m.start_i.gather(1, dom)[:, 0])
    acc = out.view(-1)
    for k in range(1, cfg.ray_steps + 1):
        kf = float(k)
        r = rays
        pos = gridops.fma32(r["step"], kf, r["start_rel"])
        vox = torch.floor(pos).to(torch.int32)
        vox = torch.where(r["is_dom"], (r["x0_dom"] + k * r["sgn"])[:, None], vox)
        inb = torch.all((vox >= 0) & (vox < size[None, :]), dim=1)
        act = ((kf - 1.0) * r["delta"] < r["budget"]) & inb
        vt = torch.remainder(vox[act] + origin[None, :], size[None, :]).long()
        flat = (vt[:, 0] * Y + vt[:, 1]) * Z + vt[:, 2]
        acc += torch.bincount(flat, minlength=acc.numel()).to(acc.dtype)
        if k % 8 == 0:
            live = kf * r["delta"] < r["budget"]
            rays = {key: t[live] for key, t in r.items()}
    return out
