"""The reference against the port's plain path on a 64×64×32 grid, and the
roofline's counts against counting by hand."""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from benchmark import roofline, scangen
from benchmark.check import Tally
from benchmark.reference import grid as gridops
from benchmark.reference import pipeline as ref
from benchmark.reference.config import GvomConfig as RefConfig
from benchmark.reference.config import empty_world_state

SMALL = dict(xy_size=64, z_size=32, max_points=8 * 64)


def _drive(n=12):
    feats = scangen.lap_features(20.0, {"set_seed": 5, "sectors": 8, "kinds": {"wall": 0.4, "boulder": 0.4, "trench": 0.2,
                                                                    "none": 0.0},
                                           "clearance_m": 3.0, "offset_m": [0.0, 6.0], "boulder_radius_m": [0.5, 1.0],
                                           "boulder_height_m": [0.5, 1.0], "wall_length_m": [2.0, 4.0],
                                           "wall_width_m": [0.4, 0.8], "wall_height_m": [1.0, 2.0],
                                           "trench_length_m": [2.0, 4.0], "trench_width_m": [1.0, 1.5],
                                           "trench_depth_m": [0.5, 1.0]})
    terrain = scangen.lap_terrain(torch.from_numpy(feats))
    phi = torch.arange(n, dtype=torch.float64) * 0.05
    x, y = 20.0 * torch.cos(phi), 20.0 * torch.sin(phi)
    egos = torch.stack([x, y, terrain(x, y) + 1.0], 1).float()
    pts, hit = scangen.simulate_scans(terrain, egos, 8, 64, max_range=30.0, noise_std=0.02,
                                      generator=torch.Generator().manual_seed(3))
    return pts.float(), hit, egos


def test_batched_steps_equal_the_ports_plain_step():
    from gvom_tpu_torch.config import GvomConfig
    from gvom_tpu_torch.engine.replay import batched_ray_steps
    from gvom_tpu_torch.parallel.sharding import make_batched_step
    from gvom_tpu_torch.types import empty_world_state as port_world

    pts, hit, egos = _drive(8)
    cfg = GvomConfig().replace(**SMALL)
    cfg = cfg.replace(ray_steps_override=batched_ray_steps(cfg, egos.numpy(), 4))
    rcfg = RefConfig.from_dict(cfg.to_dict())
    assert rcfg.ray_steps == ref.batched_ray_steps(rcfg, egos.numpy(), 4)
    step = make_batched_step(cfg, "cpu")
    w, rw = port_world(cfg, "cpu"), empty_world_state(rcfg, "cpu")
    t = Tally()
    for b in range(2):
        sl = slice(4 * b, 4 * b + 4)
        w, p = step(w, pts[sl], hit[sl], egos[sl])
        rw, rp, _ = ref.batched_step(rcfg, rw, pts[sl], hit[sl], egos[sl])
        t.world(f"step {b}", w, rw)
        t.products(f"step {b}", p, rp)
    assert int((rw.grid.hit > 0).sum()) > 100
    assert t.mismatch == 0 and t.moment_err == 0.0, t.notes


def test_live_maps_equal_the_ports_plain_facade():
    from gvom_tpu_torch.config import GvomConfig
    from gvom_tpu_torch.engine.gvom import Gvom

    pts, hit, egos = _drive(6)
    cfg = GvomConfig().replace(**SMALL)
    rcfg = RefConfig.from_dict(cfg.to_dict())
    g = Gvom(config=cfg, device="cpu")
    buf, rw = ref.new_buffer(rcfg, "cpu"), empty_world_state(rcfg, "cpu")
    t = Tally()
    for j in range(6):
        scan = pts[j][hit[j]]
        g.process_pointcloud(scan.numpy(), egos[j].numpy())
        out = g.combine_maps()
        ref.ingest(rcfg, buf, scan, egos[j])
        rw, rp, _ = ref.combine(rcfg, buf, rw, egos[j])
        t.world(f"map {j}", g.world_state, rw)
        t.products(f"map {j}", g.products, rp)
        assert np.array_equal(out[1], rp.positive_obstacle.numpy())
    assert t.mismatch == 0 and t.moment_err == 0.0, t.notes


def test_box_counts_and_the_epilogue_terms_by_hand():
    g = torch.Generator().manual_seed(1)
    t = (torch.rand((6, 7, 5), generator=g) < 0.3).to(torch.int32)
    r = (1, 2, 1)
    got = roofline.box_counts(t, r)
    for i, j, k in itertools.product(*(range(s - 2 * q) for s, q in zip(t.shape, r))):
        assert int(got[i, j, k]) == int(t[i:i + 3, j:j + 5, k:k + 3].sum())
    cfg = RefConfig(xy_size=4, z_size=3, xy_eigen_dist=1, z_eigen_dist=1)
    n_w = torch.zeros((6, 6, 5))
    n_w[1, 1, 1], n_w[2, 2, 2], n_w[5, 5, 4] = 3, 1, 2
    targets = torch.zeros(cfg.grid_shape, dtype=torch.bool)
    targets[0, 0, 0] = True                       # its box is padded [0:3, 0:3, 0:3]
    nbytes, ops_s = roofline.epilogue_bound(cfg, n_w, targets, 48, mask=False)
    assert ops_s * roofline.F32_OPS_PER_S == pytest.approx(52 * 2)    # two non-empty neighbours
    # ten channels written over 48 voxels, n read over the 27 voxels its box reaches, the nine others at the two
    # non-empty ones among them
    assert nbytes == 4 * (10 * 48 + 27 + 9 * 2)


def test_merge_and_step_bounds_count_what_the_step_touches():
    pts, hit, egos = _drive(4)
    rcfg = RefConfig(**SMALL)
    rcfg = rcfg.replace(ray_steps_override=ref.batched_ray_steps(rcfg, egos.numpy(), 4))
    w0 = empty_world_state(rcfg, "cpu")
    w1, _, parts = ref.batched_step(rcfg, w0, pts, hit, egos)
    V = rcfg.voxel_count
    nbytes, _ = roofline.merge_bound(rcfg, w0, parts.contrib)
    occ = int((parts.contrib.hit > 0).sum())
    # an invalid old world: only its moments are read, where the windows overlap and the merged voxel is occupied
    om = gridops.overlap_mask(rcfg, parts.contrib.origin, w0.grid.origin) & (w1.grid.hit > 0)
    assert nbytes == 4 * (3 * V + 10 * occ + 10 * int(om.sum()) + 14 * V + 5 * 64 * 64 + 10)
    b = roofline.replay_step_bounds(rcfg, w1, parts, tuple(hit.shape))
    assert set(b) == {"prepare", "raycast", "binning", "epilogue", "merge", "plane_fit", "guess"}
    n_pass = int(parts.contrib.miss.sum())
    k1_bytes, k1_ops = roofline.k1_bound(hit.numel(), 4, int(parts.keep.sum()), n_pass, V)
    assert b["raycast"] == pytest.approx(roofline.bound_ms(k1_bytes, k1_ops)) and n_pass > 1000
    assert dataclasses.is_dataclass(parts)
