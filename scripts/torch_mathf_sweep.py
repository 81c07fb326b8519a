"""Sweep the port's float32 log and atan2 against the JAX package's, on the CPU.

gvom_tpu_torch.ops.grid.log32 is checked against the jitted `jnp.log` on
every positive float32 (the subnormals, the normals and +inf), in chunks;
atan2_32 against the jitted `jnp.arctan2` on pairs of the plane fit's domain
(y = a0/m, x = 1/m with m = sqrt(a0² + a1² + 1), a0 and a1 uniform in
(−1, 1) and log-uniform over 16 decades), on random bit patterns with x > 0
and with any sign, and on a grid of special values. Every value is compared
bitwise (NaN equal to NaN). Prints one JSON line and exits 1 on a
difference.

    JAX_PLATFORMS=cpu python scripts/torch_mathf_sweep.py [--chunk-log2 24] [--pairs 10000000]
"""

from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from gvom_tpu_torch.ops.grid import atan2_32, log32  # noqa: E402


def differ(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.view(np.uint32) != b.view(np.uint32)) & ~(np.isnan(a) & np.isnan(b))


def sweep_log(chunk: int) -> dict:
    jlog = jax.jit(jnp.log)
    top = 0x7F800000  # +inf, the last positive value that is not NaN
    n_diff = 0
    first = []
    for lo in range(1, top + 1, chunk):
        bits = np.arange(lo, min(lo + chunk, top + 1), dtype=np.uint32)
        x = bits.view(np.float32)
        ref = np.asarray(jlog(x))
        got = log32(torch.from_numpy(x)).numpy()
        d = differ(ref, got)
        n_diff += int(d.sum())
        first += [hex(int(b)) for b in bits[d][:4 - len(first)]]
    return {"values": top, "differ": n_diff, "first": first}


def sweep_atan2(pairs: int, seed: int) -> dict:
    jatan2 = jax.jit(jnp.arctan2)
    rng = np.random.default_rng(seed)

    def fit(a0, a1):
        m = np.sqrt(a0.astype(np.float64) ** 2 + a1.astype(np.float64) ** 2 + 1.0).astype(np.float32)
        return (a0 / m).astype(np.float32), (np.float32(1.0) / m).astype(np.float32)

    def bits(n):
        return rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)

    special = np.array([0.0, -0.0, 1.0, -1.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-30, 3e38,
                        np.nextafter(np.float32(1), np.float32(2)), np.nextafter(np.float32(1), np.float32(0)),
                        2.0 ** -29, 2.0 ** 25, 0.4375, 11 / 16, 1.1875, 2.4375], np.float32)
    sy, sx = np.meshgrid(special, special)
    log_uniform = lambda n: (rng.standard_normal(n) * 10.0 ** rng.uniform(-8, 8, n)).astype(np.float32)
    sets = {
        "fit_uniform": fit(rng.uniform(-1, 1, pairs).astype(np.float32), rng.uniform(-1, 1, pairs).astype(np.float32)),
        "fit_log_uniform": fit(log_uniform(pairs), log_uniform(pairs)),
        "bits_x_positive": (bits(pairs), np.abs(bits(pairs))),
        "bits_any": (bits(pairs), bits(pairs)),
        "special_grid": (sy.ravel().copy(), sx.ravel().copy()),
    }
    out = {}
    for name, (y, x) in sets.items():
        d = differ(np.asarray(jatan2(y, x)), atan2_32(torch.from_numpy(y), torch.from_numpy(x)).numpy())
        out[name] = {"pairs": int(y.size), "differ": int(d.sum())}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunk-log2", type=int, default=24)
    ap.add_argument("--pairs", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-log", action="store_true", help="only the atan2 sweep")
    args = ap.parse_args(argv)
    t0 = time.time()
    res = {"libc": "-".join(platform.libc_ver()), "jax": jax.__version__, "torch": torch.__version__}
    if not args.skip_log:
        res["log32"] = sweep_log(1 << args.chunk_log2)
    res["atan2_32"] = sweep_atan2(args.pairs, args.seed)
    res["seconds"] = round(time.time() - t0, 1)
    print(json.dumps(res))
    bad = res.get("log32", {}).get("differ", 0) + sum(v["differ"] for v in res["atan2_32"].values())
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
