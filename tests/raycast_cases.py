"""Inputs that exercise K1's block sort (csrc/raycast.cu: each block orders
its rays by live steps before the march), made with numpy alone.

Each case is S scans of world-frame points [S, n, 3] f32, keep [S, n],
egos [S, 3] f32 and one origin [3] int32 on a 64×64×32 grid at 0.4 m, the
inputs of the many-scan K1 signature (kernels.ray_pass_counts), with the
ray budget the case pins. No JAX here: tests/test_torch_raycast.py holds
the plain twin to the JAX package on these inputs (CPU), and
tests/test_torch_raycast_card.py holds the kernel to the plain twin on the
same inputs (card).
"""

import numpy as np

GRID = dict(xy_size=64, z_size=32, max_points=1024, buffer_size=3)
RES = 0.4            # the config's default resolution, metres a voxel
EGO = np.array([0.3, -0.2, 1.5], np.float32)
N = 700              # rays a scan: two whole blocks of 256 and a ragged third
SLAB = (48, 16)      # a y_window holding the egos' torus rows (63 and 61)

# name: what the case adds over the scenes the other tests march
CASES = {
    "dead_blocks": "a block of unkept rays, a block whose rays have at most one live step, a ragged block",
    "ties": "axis-aligned rays of three lengths: whole warps of equal live counts",
    "capped": "rays longer than a 12-step budget, so most counts are the cap",
    "capped_past_key": "a 600-step budget: live counts past the sort key's cap of 511 tie at it",
    "one_live_ray": "one live ray in a scan's last, ragged block; every other ray unkept",
}


def _origin(ego):
    half = np.array([GRID["xy_size"] / 2, GRID["xy_size"] / 2, GRID["z_size"] / 2])
    return np.floor(ego / RES - half).astype(np.int32)


def _directions(rng, n):
    d = rng.normal(size=(n, 3))
    d[:, 2] *= 0.5
    return d / np.linalg.norm(d, axis=1, keepdims=True)


def _rays(rng, ego, lengths_vox, dirs=None):
    dirs = _directions(rng, len(lengths_vox)) if dirs is None else dirs
    return (ego[None, :] + dirs * (np.asarray(lengths_vox)[:, None] * RES)).astype(np.float32)


def make(name: str, seed: int = 0) -> dict:
    """The case's dict(points, keep, egos, origin, ray_steps)."""
    rng = np.random.default_rng(seed + sum(map(ord, name)))
    egos = [EGO, EGO + np.array([1.3, -0.9, 0.1], np.float32)]
    ray_steps = None
    if name == "dead_blocks":
        pts, keep = [], []
        for s, ego in enumerate(egos):
            lengths = np.concatenate([rng.uniform(1, 40, 256),          # unkept below
                                      rng.uniform(0.2, 2.0, 256),       # at most one live step
                                      rng.uniform(1, 40, N - 512)])
            k = np.ones(N, bool)
            k[:256] = False
            if s == 1:
                k[512:] = rng.random(N - 512) < 0.3
            pts.append(_rays(rng, ego, lengths))
            keep.append(k)
    elif name == "ties":
        axes = np.eye(3)[rng.integers(0, 3, N)] * rng.choice([-1.0, 1.0], (N, 1))
        pts = [_rays(rng, ego, rng.choice([4.5, 11.5, 19.5], N), axes) for ego in egos]
        keep = [np.ones(N, bool)] * 2
    elif name == "capped":
        ray_steps = 12
        pts = [_rays(rng, ego, rng.uniform(1, 60, N)) for ego in egos]
        keep = [rng.random(N) < 0.9 for _ in egos]
    elif name == "capped_past_key":
        ray_steps = 600
        pts = [_rays(rng, ego, rng.uniform(1, 800, N)) for ego in egos]
        keep = [np.ones(N, bool)] * 2
    elif name == "one_live_ray":
        egos = egos[:1]
        pts = [_rays(rng, EGO, rng.uniform(1, 40, N))]
        k = np.zeros(N, bool)
        k[N - 7] = True
        keep = [k]
    else:
        raise ValueError(f"unknown case {name!r}")
    return dict(points=np.stack(pts).astype(np.float32), keep=np.stack(keep), egos=np.stack(egos).astype(np.float32),
                origin=_origin(EGO), ray_steps=ray_steps)


def config(case: dict) -> dict:
    """The case's config fields (GRID and its ray budget)."""
    return dict(GRID, ray_steps_override=case["ray_steps"])
