"""Count the rows where the JAX package's grid.voxel_indices rounds
differently run eagerly and under jax.jit, and where the port's
grid.voxel_indices differs from each, on the CPU.

Eagerly the JAX function divides by the resolution; under jit XLA rewrites
p/res − origin as one FMA with f32(1/res), which the port computes. The
points: 200,000 Gaussian (σ = 60 m) and 200,000 on voxel boundaries (k·res,
rounded in float32 and from float64) or one or two ulps past them, from
numpy.random.default_rng(seed). Prints one JSON line.

    JAX_PLATFORMS=cpu python scripts/voxel_indices_rounding.py [--seed 0] [--origin -37 12 -5]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gvom_tpu.config import GvomConfig  # noqa: E402
from gvom_tpu.ops import grid as jgrid  # noqa: E402

from gvom_tpu_torch import config as tconfig  # noqa: E402
from gvom_tpu_torch.ops import grid  # noqa: E402


def points(rng, res_xy: float, res_z: float, n: int = 200_000) -> np.ndarray:
    res = np.array([res_xy, res_xy, res_z])
    gauss = rng.normal(0.0, 60.0, (n, 3)).astype(np.float32)
    k = rng.integers(-400, 400, (n, 3)).astype(np.float64)
    faces = np.where(rng.random((n, 3)) < 0.5, (k.astype(np.float32) * res.astype(np.float32)),
                     (k * res).astype(np.float32)).astype(np.float32)
    for _ in range(2):      # a third of the rows stay on the face, a third go one ulp past, a third two
        step = rng.integers(0, 2, (n, 3)).astype(bool)
        faces = np.where(step, np.nextafter(faces, np.where(rng.random((n, 3)) < 0.5, np.inf, -np.inf)
                                            .astype(np.float32)), faces)
    return np.concatenate([gauss, faces])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--origin", type=int, nargs=3, default=(-37, 12, -5))
    args = ap.parse_args()
    origin = np.array(args.origin, np.int32)
    out = dict(seed=args.seed, origin=origin.tolist(), rows={})
    for res_xy, res_z in ((0.4, 0.2), (0.3, 0.15)):
        cfg = dataclasses.replace(GvomConfig(), xy_resolution=res_xy, z_resolution=res_z)
        tcfg = tconfig.GvomConfig.from_dict(cfg.to_dict())
        p = points(np.random.default_rng(args.seed), res_xy, res_z)
        eager = np.asarray(jgrid.voxel_indices(cfg, jnp.asarray(p), jnp.asarray(origin)))
        jitted = np.asarray(jax.jit(jgrid.voxel_indices, static_argnums=0)(cfg, jnp.asarray(p), jnp.asarray(origin)))
        port = grid.voxel_indices(tcfg, torch.from_numpy(p), torch.from_numpy(origin)).numpy()
        row = lambda a, b: int((a != b).any(axis=1).sum())
        out["rows"][f"({res_xy}, {res_z})"] = dict(total=len(p), eager_vs_jit=row(eager, jitted),
                                                   port_vs_jit=row(port, jitted), port_vs_eager=row(port, eager))
    print(json.dumps(out))
    return 0 if all(r["port_vs_jit"] == 0 for r in out["rows"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
