"""State carried between the JAX package and the port.

This system has no weights: its state is what carries over. The JAX package
stores its channels in layouts that fill TPU tiles, the port in the logical
torus layout (types.py):

  * hit, miss, min_height, evidence: JAX stores the contiguous reshape
    [.., X, Y/2, 2Z] of the logical [.., X, Y, Z] grid (its grid.pack_yz);
    undoing it is a reshape.
  * moments: JAX stores [.., X, 5, Y, Vp] with two channels per slot, one in
    lanes [0, Z) and one in [Z, 2Z) (its moments.pack_moments):
        slot  lanes [0:Z]  lanes [Z:2Z]
        0     n            sz
        1     sx           xz
        2     sy           yz
        3     xx           xy
        4     yy           zz
    The port stores [.., 10, X, Y, Z] in MOMENT_CHANNELS order.

Everything here takes and returns numpy arrays only: a caller that holds JAX
state converts it with np.asarray first. The JAX state is read by its field
names (hit_pk, miss_pk, minh_pk, mom, origin; evidence_pk, valid; grids,
slot_valid, cursor, last_slot), so nothing of the JAX package is imported.
"""

from __future__ import annotations

from typing import Dict, Union

import numpy as np
import torch

from gvom_tpu_torch.types import MOMENT_CHANNELS, BufferState, VoxelGrid, WorldState, resolve_device

__all__ = ["logical_from_jax_numpy", "from_jax_numpy", "to_numpy"]

# (packed slot, upper lane half?) of each logical channel
_PACKED_AT = {
    "n": (0, False), "sx": (1, False), "sy": (2, False), "sz": (0, True),
    "xx": (3, False), "xy": (3, True), "xz": (1, True),
    "yy": (4, False), "yz": (2, True), "zz": (4, True),
}


def _unpack_yz(a: np.ndarray) -> np.ndarray:
    *lead, r, l = a.shape
    return np.asarray(a).reshape(*lead, 2 * r, l // 2)


def _unpack_moments(mom: np.ndarray, z: int) -> np.ndarray:
    """[.., X, 5, Y, Vp] → [.., 10, X, Y, Z]."""
    mom = np.asarray(mom)
    chans = []
    for name in MOMENT_CHANNELS:
        s, hi = _PACKED_AT[name]
        lanes = slice(z, 2 * z) if hi else slice(0, z)
        chans.append(mom[..., :, s, :, lanes])
    return np.stack(chans, axis=-4)


def logical_from_jax_numpy(state) -> Dict[str, np.ndarray]:
    """The logical numpy arrays of a JAX VoxelGrid, WorldState or BufferState
    whose leaves are numpy arrays: the same keys as to_numpy returns."""
    if hasattr(state, "grids"):
        out = {k: v for k, v in logical_from_jax_numpy(state.grids).items()}
        out.update(slot_valid=np.asarray(state.slot_valid), cursor=np.asarray(state.cursor),
                   last_slot=np.asarray(state.last_slot))
        return out
    if hasattr(state, "evidence_pk"):
        out = logical_from_jax_numpy(state.grid)
        out.update(evidence=_unpack_yz(state.evidence_pk), valid=np.asarray(state.valid))
        return out
    hit = _unpack_yz(state.hit_pk)
    return {
        "hit": hit,
        "miss": _unpack_yz(state.miss_pk),
        "min_height": _unpack_yz(state.minh_pk),
        "mom": _unpack_moments(state.mom, hit.shape[-1]),
        "origin": np.asarray(state.origin),
    }


def _t(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.array(a)).to(dev)   # a writable copy


def from_jax_numpy(state, device="cuda") -> Union[VoxelGrid, WorldState, BufferState]:
    """The port's state from a JAX VoxelGrid, WorldState or BufferState whose
    leaves are numpy arrays."""
    dev = resolve_device(device)
    d = logical_from_jax_numpy(state)
    grid = VoxelGrid(hit=_t(d["hit"], dev), miss=_t(d["miss"], dev), min_height=_t(d["min_height"], dev),
                     mom=_t(d["mom"], dev), origin=_t(d["origin"], dev))
    if "slot_valid" in d:
        return BufferState(grids=grid, slot_valid=_t(d["slot_valid"], dev), cursor=_t(d["cursor"], dev),
                           last_slot=_t(d["last_slot"], dev))
    if "evidence" in d:
        return WorldState(grid=grid, evidence=_t(d["evidence"], dev), valid=_t(d["valid"], dev))
    return grid


def _np(x: torch.Tensor) -> np.ndarray:
    # a copy: on the CPU .numpy() shares memory with a buffer updated in place
    return x.detach().cpu().numpy().copy()


def to_numpy(state: Union[VoxelGrid, WorldState, BufferState]) -> Dict[str, np.ndarray]:
    """The logical numpy arrays of the port's state (keys as
    logical_from_jax_numpy)."""
    if isinstance(state, BufferState):
        out = to_numpy(state.grids)
        out.update(slot_valid=_np(state.slot_valid), cursor=_np(state.cursor), last_slot=_np(state.last_slot))
        return out
    if isinstance(state, WorldState):
        out = to_numpy(state.grid)
        out.update(evidence=_np(state.evidence), valid=_np(state.valid))
        return out
    return {k: _np(getattr(state, k)) for k in ("hit", "miss", "min_height", "mom", "origin")}
