"""K1 (csrc/raycast.cu) on the card against its plain twin, bit for bit, on
the inputs its block sort adds (tests/raycast_cases.py), on one scan and on
a 64-scan batch of the benchmark's lap, in the full grid and the slab
form; and the schedule counts of its stats entry (kernels.ray_march_stats)
equal to those of the plain twin (raycast.march_stats_plain), in the sorted
order and in launch order.

Every test needs a CUDA card: it takes the `card` fixture, which skips
without one. The file imports no JAX (the card's machine has none); on
the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_raycast_card.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import raycast_cases
from gvom_tpu_torch.config import GvomConfig
from gvom_tpu_torch.ops import kernels, raycast

pytestmark = pytest.mark.card

ROOT = Path(__file__).resolve().parent.parent
LAP_BATCH = (64, 128)    # the lap's second batch of 64 scans, at its last scan's origin
LAP_SCAN = 100           # one scan of it
LAP_SEED = 3_000_000_019  # the run's seed: the range noise


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def case_inputs(name, dev):
    c = raycast_cases.make(name)
    cfg = GvomConfig(**raycast_cases.config(c))
    return cfg, [torch.from_numpy(c[k].copy()).to(dev) for k in ("points", "keep", "egos", "origin")]


def plain(cfg, inputs, y_window=None):
    return raycast.pass_counts_plain(cfg, *(t.cpu() for t in inputs), y_window)


@pytest.mark.parametrize("y_window", [None, raycast_cases.SLAB])
@pytest.mark.parametrize("case", sorted(raycast_cases.CASES))
def test_k1_sort_cases_bitwise_plain(card, case, y_window):
    """K1 on each case, one launch of its S scans, equals the plain twin bit
    for bit; the launch is counted by the form's own counter."""
    cfg, inputs = case_inputs(case, card)
    counter = kernels.RAY_SLAB if y_window else kernels.RAY
    launches = counter.launches
    got = kernels.ray_pass_counts(cfg, *inputs, y_window=y_window)
    assert counter.launches == launches + 1
    np.testing.assert_array_equal(got.cpu().numpy(), plain(cfg, inputs, y_window).numpy())


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("window", [256, 1024])
@pytest.mark.parametrize("case", sorted(raycast_cases.CASES))
def test_k1_march_stats_equal_twin(card, case, window, sort):
    """The stats entry on each case, at both windows and in both orders:
    its three counts equal the plain twin's exactly, and its pass counts
    the plain twin's."""
    cfg, inputs = case_inputs(case, card)
    passes, counts = kernels.ray_march_stats(cfg, *inputs, window=window, sort=sort)
    twin = raycast.march_stats_plain(cfg, *(t.cpu() for t in inputs), window=window, sort=sort)
    assert counts.cpu().tolist() == twin.tolist()
    np.testing.assert_array_equal(passes.cpu().numpy(), plain(cfg, inputs).numpy())


@pytest.fixture(scope="module")
def lap():
    """(cfg, points [64, N, 3], keep, egos, origin) of the lap's batch on the
    card: the benchmark's lap (benchmark/scangen.make_lap) sliced as its
    replay slices it, with its ray budget, prepared as the batched step
    prepares it (the world frame of its last scan, dead scans dropped)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from benchmark import scangen
    from gvom_tpu_torch.engine.replay import batched_ray_steps

    dev = torch.device("cuda", 0)
    conf = json.loads((ROOT / "benchmark/configs/os1_128.json").read_text())
    drive = json.loads((ROOT / "benchmark/drives/lap.json").read_text())
    made = scangen.make_lap(conf["sensor"], drive, conf["gvom"]["ground_to_lidar_height"], LAP_SEED, dev)
    cfg = GvomConfig.from_dict(conf["gvom"])
    cfg = cfg.replace(ray_steps_override=batched_ray_steps(cfg, made["egos"].cpu().numpy(),
                                                           LAP_BATCH[1] - LAP_BATCH[0]))
    b = slice(*LAP_BATCH)
    be = made["egos"][b].contiguous()
    p, keep, origin, _ = kernels.prepare_points(cfg, made["points"][b].contiguous(), made["valid"][b].contiguous(),
                                                be, frame_ego=be[-1].contiguous(), drop_dead=True)
    return cfg, p, keep, be, origin


@pytest.mark.parametrize("y_window", [None, (64, 64)])
def test_k1_lap_scan_bitwise_plain(lap, y_window):
    """One scan of the lap (one launch, 256 rays a block) equals the plain
    twin bit for bit, in the full grid and a quarter slab."""
    cfg, p, keep, egos, origin = lap
    s = slice(LAP_SCAN - LAP_BATCH[0], LAP_SCAN - LAP_BATCH[0] + 1)
    inputs = [p[s].contiguous(), keep[s].contiguous(), egos[s].contiguous(), origin]
    assert kernels.ray_window(1, p.shape[1], kernels._sms(p.device)) == 256
    got = kernels.ray_pass_counts(cfg, *inputs, y_window=y_window)
    np.testing.assert_array_equal(got.cpu().numpy(), raycast.pass_counts_plain(cfg, *inputs, y_window).cpu().numpy())
    assert int(got.sum()) > 100_000


def test_k1_lap_batch_bitwise_plain(lap):
    """The 64-scan batch in one launch (1,024 rays a block on an H100)
    equals the plain twin bit for bit."""
    cfg, p, keep, egos, origin = lap
    got = kernels.ray_pass_counts(cfg, p, keep, egos, origin)
    np.testing.assert_array_equal(got.cpu().numpy(), raycast.pass_counts_plain(cfg, p, keep, egos, origin).cpu().numpy())


def test_k1_lap_batch_lane_utilisation(lap):
    """On the 64-scan batch the stats entry's counts equal the plain twin's
    in both orders; the sorted march keeps more than 0.6 of the issued
    lane-steps busy, the launch order about 0.3."""
    cfg, p, keep, egos, origin = lap
    util = {}
    for sort in (True, False):
        _, counts = kernels.ray_march_stats(cfg, p, keep, egos, origin, sort=sort)
        window = kernels.ray_window(*p.shape[:2], kernels._sms(p.device))
        twin = raycast.march_stats_plain(cfg, p, keep, egos, origin, window=window, sort=sort)
        assert counts.cpu().tolist() == twin.tolist()
        util[sort] = counts[0].item() / counts[1].item()
    assert util[True] > 0.6
    assert 0.2 < util[False] < 0.4
