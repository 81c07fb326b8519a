"""The comparison that decides `correct`: the program's state and maps
against the reference's, as two numbers.

  * mismatch    the elements that differ, over the world's hit, miss,
                evidence, min_height (bitwise), origin and valid and over
                every map (bitwise; NaN equal to NaN). The port computes
                each of them in integer arithmetic or in the same rounded
                float32 steps as its plain version, so a sound run reads 0.
  * moment_err  the largest gap of a moment channel, over every voxel and
                the ten channels, per point of the voxel (|a − b| / max(n,
                1), n the reference's count): the kernels add float32 terms
                in an order of their own.

Each is held against the limit that the cell's file states.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchmark.reference.config import MAP_FIELDS, VoxelGrid, WorldState

__all__ = ["Tally", "to_ref_world", "host_copy", "pinned_like", "copy_into"]

WORLD_EXACT = ("hit", "miss", "min_height", "origin")


def _differ(a: torch.Tensor, b: torch.Tensor) -> int:
    a, b = a.to(b.device), b
    if a.shape != b.shape:
        return max(a.numel(), b.numel())
    if a.dtype.is_floating_point:
        nan = torch.isnan(a) & torch.isnan(b)
        return int(((a.view(torch.int32) != b.view(torch.int32)) & ~nan).sum())
    return int((a != b).sum())


class Tally:
    """Running totals of the two numbers over every comparison of a run."""

    def __init__(self):
        self.mismatch = 0
        self.moment_err = 0.0
        self.compared = 0
        self.notes = []

    def world(self, what: str, prog, ref: WorldState) -> None:
        g, r = prog.grid, ref.grid
        n = 0
        for k in WORLD_EXACT:
            n += _differ(getattr(g, k), getattr(r, k))
        n += _differ(prog.evidence, ref.evidence) + _differ(prog.valid.reshape(1), ref.valid.reshape(1))
        cnt = torch.clamp(r.mom[0], min=1.0)
        err = float(((g.mom.to(r.mom.device) - r.mom).abs() / cnt[None]).amax())
        self._add(what + " world", n, err)

    def products(self, what: str, prog, ref) -> None:
        n = sum(_differ(getattr(prog, k), getattr(ref, k)) for k in MAP_FIELDS)
        self._add(what + " maps", n, 0.0)

    def arrays(self, what: str, prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> None:
        n = 0
        for k, b in ref.items():
            a = prog[k]
            if a.shape != b.shape:
                n += max(a.size, b.size)
            elif a.dtype.kind == "f":
                n += int(((a != b) & ~(np.isnan(a) & np.isnan(b))).sum())
            else:
                n += int((a != b).sum())
        self._add(what + " returned maps", n, 0.0)

    def _add(self, what: str, n: int, err: float) -> None:
        self.compared += 1
        self.mismatch += n
        self.moment_err = max(self.moment_err, err)
        if n:
            self.notes.append(f"{what}: {n} elements differ")

    def numbers(self) -> Dict[str, float]:
        return {"mismatch": self.mismatch, "moment_err": self.moment_err}


def to_ref_world(w, device) -> WorldState:
    """A world of the program (any object with the state's fields) as the
    reference's record, on `device`."""
    g = w.grid
    return WorldState(grid=VoxelGrid(hit=g.hit.to(device), miss=g.miss.to(device),
                                     min_height=g.min_height.to(device), mom=g.mom.to(device),
                                     origin=g.origin.to(device)),
                      evidence=w.evidence.to(device), valid=w.valid.to(device))


def _tensors(w):
    g = w.grid
    return [g.hit, g.miss, g.min_height, g.mom, g.origin, w.evidence, w.valid]


def host_copy(w) -> WorldState:
    """A synchronous host copy of a world."""
    t = [x.cpu() for x in _tensors(w)]
    return WorldState(grid=VoxelGrid(*t[:5]), evidence=t[5], valid=t[6])


def pinned_like(w) -> WorldState:
    """Pinned host tensors shaped as a world's, for copy_into."""
    t = [torch.empty(x.shape, dtype=x.dtype, pin_memory=True) for x in _tensors(w)]
    return WorldState(grid=VoxelGrid(*t[:5]), evidence=t[5], valid=t[6])


def copy_into(dst: WorldState, w) -> None:
    """Enqueue copies of a world into pinned host tensors on the current
    stream, without waiting for them."""
    for d, s in zip(_tensors(dst), _tensors(w)):
        d.copy_(s, non_blocking=True)
