"""Checkpoint / resume of the world state.

The reference's only persistent state is the last_combined_* rotation carrying
the fused map across cycles (gvom.py:268-274), lost on a crash. Here the
world is snapshotted to one .npz file in the JAX package's LOGICAL layout
(gvom_tpu/utils/checkpoint.py's npz form): hit, miss, min_height, evidence
[X, Y, Z], origin [3], valid, the packed moments [X, 5, Y, Vp]
(utils/convert.py) and, when given, the configuration as JSON bytes. A
checkpoint written by either package loads in the other. Resume = load +
continue the replay.

A world sharded over a (data, space) mesh (parallel/sharding.shard_world)
is saved in the same logical form: every rank calls save_world, the slabs
are gathered, rank 0 writes the file and the others wait for it. Every rank
calls load_world with the mesh and gets its slab.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.parallel.sharding import gather_world, shard_world
from gvom_tpu_torch.types import WorldState, resolve_device
from gvom_tpu_torch.utils import convert

__all__ = ["save_world", "load_world"]


def save_world(path: str, world: WorldState, cfg: Optional[GvomConfig] = None, mesh=None) -> str:
    """Snapshot the world state to `path` (".npz" is appended if missing).
    Returns the path written. With a mesh, `world` is this rank's slab and
    every rank of the mesh calls save_world with the same path."""
    if not path.endswith(".npz"):
        path = path + ".npz"
    if mesh is not None:
        world = gather_world(world, mesh)
        if mesh.rank == 0:
            save_world(path, world, cfg)
        mesh.barrier()       # no rank reads the file before it is in place
        return path
    arrs = convert.to_jax_logical(world)
    if cfg is not None:
        arrs["config_json"] = np.frombuffer(cfg.to_json().encode(), dtype=np.uint8)
    # atomic: write to a tmp name, then rename into place. A crash in the
    # middle of a save must never leave a torn file under the final name
    tmp = path[:-4] + ".tmp.npz"  # keep .npz so savez does not append one
    np.savez_compressed(tmp, **arrs)
    os.replace(tmp, path)
    return path


def load_world(path: str, device="cuda", mesh=None) -> WorldState:
    """The world state of a checkpoint written by save_world here or by the
    JAX package's npz form, on `device`; with a mesh, this rank's slab of it
    on the mesh's device."""
    dev = resolve_device(device)   # before the file is read: no card, no load
    with np.load(path) as z:
        missing = [k for k in ("hit", "miss", "min_height", "mom", "origin", "evidence", "valid") if k not in z]
        if missing:
            raise KeyError(f"checkpoint {path!r} lacks {missing}")
        arrs = {k: z[k] for k in z.files if k != "config_json"}
    if mesh is None:
        return convert.from_jax_logical(arrs, dev)
    return shard_world(convert.from_jax_logical(arrs, "cpu"), mesh)
