"""Checkpoint / resume of the world state.

The reference's only persistent state is the last_combined_* rotation carrying
the fused map across cycles (gvom.py:268-274), lost on a crash. Here the
world is snapshotted to one .npz file in the JAX package's LOGICAL layout
(gvom_tpu/utils/checkpoint.py's npz form): hit, miss, min_height, evidence
[X, Y, Z], origin [3], valid, the packed moments [X, 5, Y, Vp]
(utils/convert.py) and, when given, the configuration as JSON bytes. A
checkpoint written by either package loads in the other. Resume = load +
continue the replay.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.types import WorldState, resolve_device
from gvom_tpu_torch.utils import convert

__all__ = ["save_world", "load_world"]


def save_world(path: str, world: WorldState, cfg: Optional[GvomConfig] = None) -> str:
    """Snapshot the world state to `path` (".npz" is appended if missing).
    Returns the path written."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    arrs = convert.to_jax_logical(world)
    if cfg is not None:
        arrs["config_json"] = np.frombuffer(cfg.to_json().encode(), dtype=np.uint8)
    # atomic: write to a tmp name, then rename into place. A crash in the
    # middle of a save must never leave a torn file under the final name
    tmp = path[:-4] + ".tmp.npz"  # keep .npz so savez does not append one
    np.savez_compressed(tmp, **arrs)
    os.replace(tmp, path)
    return path


def load_world(path: str, device="cuda") -> WorldState:
    """The world state of a checkpoint written by save_world here or by the
    JAX package's npz form, on `device`."""
    dev = resolve_device(device)   # before the file is read: no card, no load
    with np.load(path) as z:
        missing = [k for k in ("hit", "miss", "min_height", "mom", "origin", "evidence", "valid") if k not in z]
        if missing:
            raise KeyError(f"checkpoint {path!r} lacks {missing}")
        return convert.from_jax_logical({k: z[k] for k in z.files if k != "config_json"}, dev)
