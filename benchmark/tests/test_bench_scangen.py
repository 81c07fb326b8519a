"""The drive's scan generator against the port's io/synthetic at a small size."""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from benchmark import harness, scangen


@pytest.mark.parametrize("sensor", [(0.0, 0.0, 1.0), (6.5, -3.0, 1.3), (12.0, 9.0, 0.7)])
def test_scans_agree_with_io_synthetic(sensor):
    from gvom_tpu_torch.io import synthetic

    want = synthetic.simulate_lidar_scan(synthetic.composite_terrain(), sensor, channels=8, azimuth_steps=64,
                                         max_range=40.0)
    pts, hit = scangen.simulate_scans(scangen.composite_terrain, torch.tensor([sensor], dtype=torch.float64),
                                      channels=8, azimuth_steps=64, max_range=40.0)
    got = pts[0][hit[0]].numpy()
    assert got.shape == want.shape and got.shape[0] > 100
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    cut, cut_hit = scangen.simulate_scans(scangen.composite_terrain, torch.tensor([sensor], dtype=torch.float64),
                                          channels=8, azimuth_steps=64, max_range=40.0,
                                          ceiling=scangen.COMPOSITE_CEILING)
    assert torch.equal(cut, pts) and torch.equal(cut_hit, hit)


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_the_march_cut_at_the_ceiling_gives_the_same_scans(seed):
    """Rays leave the march once above the terrain's ceiling: the lap's
    scans are the same, bit for bit, in float32 as make_lap makes them."""
    p = json.loads((harness.PKG / "drives" / "lap.json").read_text())["features"]
    feats = scangen.lap_features(20.0, dict(p, set_seed=seed, sectors=16, offset_m=[0.0, 5.0]))
    terrain = scangen.lap_terrain(torch.from_numpy(feats))
    phi = torch.tensor([0.0, 0.9, 2.1, 4.4], dtype=torch.float64)
    x, y = 20.0 * torch.cos(phi), 20.0 * torch.sin(phi)
    sensors = torch.stack([x, y, terrain(x, y) + 1.0], 1).float()
    runs = [scangen.simulate_scans(terrain, sensors, 16, 128, max_range=60.0, noise_std=0.02,
                                   generator=torch.Generator().manual_seed(seed), ceiling=c)
            for c in (None, scangen.lap_ceiling(feats))]
    (a, ha), (b, hb) = runs
    assert torch.equal(ha, hb) and torch.equal(a, b)
    assert 0.3 < float(ha.float().mean()) < 0.8   # the sky holds no return, the ground does


def _lap(seed):
    drive = json.loads((harness.PKG / "drives" / "lap.json").read_text())
    drive.update(scans=16)
    drive["features"]["sectors"] = 16
    sensor = json.loads((harness.PKG / "configs" / "os1_64.json").read_text())["sensor"]
    sensor.update(channels=8, azimuth_steps=32)
    return scangen.make_lap(sensor, drive, 1.0, seed, torch.device("cpu"))


def test_the_lap_comes_from_the_seed():
    a, b, c = _lap(2 ** 31 + 7), _lap(2 ** 31 + 7), _lap(4)
    for k in ("points", "valid", "egos"):
        assert torch.equal(a[k], b[k])
    # one drive: the same features and egos from every seed, its range noise drawn from the seed
    assert np.array_equal(a["features"], c["features"]) and torch.equal(a["egos"], c["egos"])
    assert not torch.equal(a["points"], c["points"])
    n = a["counts"]
    assert bool((n > 0).all()) and torch.equal(a["valid"].sum(1), n)
    # returns first, zeros after; consecutive egos 0.4 m apart along the lap
    assert bool((a["points"][~a["valid"]] == 0).all())
    chord = (a["egos"][1:, :2] - a["egos"][:-1, :2]).norm(dim=1)
    arc = 2 * a["radius"] * np.arcsin(chord.double().numpy() / (2 * a["radius"]))
    assert np.abs(arc - 4.0 / 10.0).max() < 1e-4


def test_features_stay_off_the_path_and_in_their_sector():
    p = json.loads((harness.PKG / "drives" / "lap.json").read_text())["features"]
    radius = 65.0
    f = scangen.lap_features(radius, p)
    k = p["sectors"]
    box = f[:, 4] != 0
    assert (np.abs(f[box, 1] - radius) - f[box, 3] >= p["clearance_m"] - 1e-9).all()
    dome = f[:, 5] > 0
    assert (np.abs(f[dome, 1] - radius) - f[dome, 5] >= p["clearance_m"] - 1e-9).all()
    half_arc = 0.5 * (2 * np.pi / k) * (f[:, 1] - np.maximum(f[:, 3], f[:, 5]))
    assert (f[:, 2] <= half_arc + 1e-9).all() and (f[:, 5] <= half_arc + 1e-9).all()
