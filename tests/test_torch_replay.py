"""The port's replay functions, scan logs and checkpoints
(gvom_tpu_torch.engine.replay, io.logio, utils.checkpoint) against gvom_tpu's,
on the CPU: sequential and batched replay of one synthesized log (whole and
partial final batch, one entry with a transform), logs and checkpoints
written by each package and read by the other, and a resumed run equal to
the straight one."""

import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest

from gvom_tpu.config import GvomConfig
from gvom_tpu.engine import replay as jreplay
from gvom_tpu.io import logio as jlogio
from gvom_tpu.parallel.mesh import make_mesh
from gvom_tpu.utils import checkpoint as jcheckpoint

from gvom_tpu_torch.engine import replay as treplay
from gvom_tpu_torch.io import logio as tlogio
from gvom_tpu_torch.utils import checkpoint as tcheckpoint

from torch_helpers import (assert_products_equal, assert_state_equal, convert, jax_numpy,
                           products_numpy, tcfg)

LIDAR = dict(channels=8, azimuth_steps=32, max_range=10.0)
N_SCANS = 7


@pytest.fixture(scope="module")
def cfg():
    return GvomConfig(xy_size=32, z_size=16, max_points=1024, buffer_size=2)


@pytest.fixture(scope="module")
def log():
    """The same drive from both packages' synthesize_log; entry 2 carries a
    sensor transform."""
    a, b = jlogio.synthesize_log(N_SCANS, seed=4, **LIDAR), tlogio.synthesize_log(N_SCANS, seed=4, **LIDAR)
    for (pa, ea, _), (pb, eb, _) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ea, eb)
    tf = np.eye(4)
    tf[:3, 3] = [0.1, -0.05, 0.02]
    b.entries[2] = (b.entries[2][0], b.entries[2][1], tf)
    return b


@pytest.fixture(scope="module")
def batched(cfg, log):
    """batch size → (JAX result, port result): 7 scans in batches of 4 end
    in a partial batch of 3; a batch of 7 is the whole log in one step."""
    mesh = make_mesh(jax.devices()[:1])
    return {b: (jreplay.batched_replay(cfg, log, b, mesh=mesh, raycast_impl="xla"),
                treplay.batched_replay(tcfg(cfg), log, b, device="cpu")) for b in (4, 7)}


def test_sequential_replay_matches_jax(cfg, log):
    jeng, jout, jmet = jreplay.sequential_replay(cfg, log, combine_every=2, raycast_impl="xla")
    teng, tout, tmet = treplay.sequential_replay(tcfg(cfg), log, combine_every=2, device="cpu")
    assert len(jout) == len(tout) == N_SCANS // 2
    counters = tmet.snapshot()["counters"]
    assert counters["scans"] == N_SCANS and counters["combines"] == N_SCANS // 2
    for a, b in zip(jout, tout):
        for name, x, y in zip(("origin", "positive", "negative", "roughness", "visibility"), a, b):
            np.testing.assert_array_equal(np.asarray(y), np.asarray(x), err_msg=name)
    assert_state_equal(convert.to_numpy(teng._buffer), convert.logical_from_jax_numpy(jax_numpy(jeng._buffer)),
                       "ring buffer after the replay")


@pytest.mark.parametrize("batch_size", [4, 7])
def test_batched_replay_matches_jax(batched, batch_size):
    (jworld, jprods, jmet), (tworld, tprods, tmet) = batched[batch_size]
    n_batches = -(-N_SCANS // batch_size)
    assert len(jprods) == len(tprods) == n_batches
    counters = tmet.snapshot()["counters"]
    assert counters["scans"] == N_SCANS and counters["batches"] == n_batches
    assert_state_equal(convert.to_numpy(tworld), convert.logical_from_jax_numpy(jax_numpy(jworld)),
                       f"world, batches of {batch_size}")
    for i, (jp, tp) in enumerate(zip(jprods, tprods)):
        assert_products_equal(products_numpy(tp), products_numpy(jp), f"batch {i}")


def test_drift_bounded_ray_budget(cfg, log):
    """The replay's static DDA budget: the centered bound plus the worst
    in-batch ego drift, capped at the any-in-grid bound."""
    egos = np.stack([e for _, e, _ in log])
    c = tcfg(cfg)
    steps = treplay.batched_ray_steps(c, egos, 4)
    size = max(c.xy_size, c.z_size)
    assert size // 2 + 6 < steps <= size + 4
    far = egos.copy()
    far[0] += 1000.0
    assert treplay.batched_ray_steps(c, far, 4) == size + 4


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_scan_log_round_trip(tmp_path, log, writer):
    """save_log / load_log: a log written by either package reads back equal
    in the other, transform included."""
    path = str(tmp_path / "log.npz")
    (jlogio if writer == "jax" else tlogio).save_log(path, log)
    back = (tlogio if writer == "jax" else jlogio).load_log(path)
    assert len(back) == len(log) == N_SCANS
    for (p, e, tf), (p2, e2, tf2) in zip(log, back):
        np.testing.assert_array_equal(p2, p)
        np.testing.assert_array_equal(e2, e)
        assert (tf is None) == (tf2 is None)
        if tf is not None:
            np.testing.assert_array_equal(tf2, tf)
    assert back[2][2] is not None and back[0][2] is None


def test_checkpoint_written_by_jax_loads_in_the_port(tmp_path, monkeypatch, cfg, batched):
    (jworld, _, _), (tworld, _, _) = batched[4]
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)   # gvom_tpu's npz form
    path = jcheckpoint.save_world(str(tmp_path / "jax_world"), jworld, cfg)
    assert path.endswith(".npz")
    loaded = tcheckpoint.load_world(path, device="cpu")
    ref = convert.logical_from_jax_numpy(jax_numpy(jworld))
    got = convert.to_numpy(loaded)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_checkpoint_written_by_the_port_loads_in_jax(tmp_path, cfg, batched):
    (_, _, _), (tworld, _, _) = batched[4]
    path = tcheckpoint.save_world(str(tmp_path / "port_world"), tworld, tcfg(cfg))
    assert path.endswith(".npz") and not os.path.exists(path[:-4] + ".tmp.npz")
    jworld = jcheckpoint.load_world(path)
    ref = convert.to_numpy(tworld)
    got = convert.logical_from_jax_numpy(jax_numpy(jworld))
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    with np.load(path) as z:
        assert GvomConfig.from_dict(json.loads(bytes(z["config_json"]).decode())) == cfg
    again = tcheckpoint.load_world(path, device="cpu")
    for k, v in convert.to_numpy(again).items():
        np.testing.assert_array_equal(v, ref[k], err_msg=k)


def test_load_world_refuses_a_torn_checkpoint(tmp_path):
    path = str(tmp_path / "torn.npz")
    np.savez(path, hit=np.zeros((2, 2, 2), np.int32))
    with pytest.raises(KeyError, match="evidence"):
        tcheckpoint.load_world(path, device="cpu")


def test_resume_equals_straight_run(tmp_path, cfg, log):
    """A replay checkpointed after every batch, then resumed from the first
    checkpoint with that batch skipped, ends in the straight run's world."""

    class Beats:
        n = 0

        def beat(self):
            self.n += 1

    c = tcfg(cfg)
    # pin the budget, so the resumed run rasterizes as the straight one did
    egos = np.stack([e for _, e, _ in log])
    c = dataclasses.replace(c, ray_steps_override=treplay.batched_ray_steps(c, egos, 3))
    hb = Beats()
    straight, prods, met = treplay.batched_replay(c, log, 3, device="cpu", checkpoint_dir=str(tmp_path),
                                                  checkpoint_every=1, heartbeat=hb)
    assert met.snapshot()["counters"]["checkpoints"] == 3 == hb.n
    assert sorted(os.listdir(tmp_path)) == ["world_b1.npz", "world_b2.npz", "world_b3.npz"]
    resumed, prods2, met2 = treplay.batched_replay(c, log, 3, device="cpu",
                                                   resume_from=str(tmp_path / "world_b1.npz"), skip_batches=1)
    counters = met2.snapshot()["counters"]
    assert counters["skipped_batches"] == 1 and counters["batches"] == 2 and len(prods2) == 2
    a, b = convert.to_numpy(straight), convert.to_numpy(resumed)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    np.testing.assert_array_equal(prods2[-1].positive_obstacle.numpy(), prods[-1].positive_obstacle.numpy())
    final = tcheckpoint.load_world(str(tmp_path / "world_b3.npz"), device="cpu")
    np.testing.assert_array_equal(convert.to_numpy(final)["mom"], a["mom"])
