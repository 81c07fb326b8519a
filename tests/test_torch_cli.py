"""The port's command line (python -m gvom_tpu_torch.cli) and its failure
tools (gvom_tpu_torch/utils/failures.py), on the CPU. The CLI runs as
subprocesses, each with a time limit: convert-bag, replay with
--device cpu, and selftest, which needs a GPU and so exits non-zero here.
The failure tools: the heartbeat monitor, the resumable checkpoints of the
port and supervise restarting an inline worker."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from gvom_tpu.io.logio import load_log as jax_load_log
from gvom_tpu_torch import GvomConfig
from gvom_tpu_torch.io import rosbag
from gvom_tpu_torch.io.logio import load_log
from gvom_tpu_torch.types import empty_world_state
from gvom_tpu_torch.utils.checkpoint import save_world
from gvom_tpu_torch.utils.failures import HeartbeatMonitor, load_resumable, resume_latest, supervise

from test_rosbag import _make_messages

ROOT = Path(__file__).resolve().parent.parent
TIMEOUT_S = 120


def cli(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "gvom_tpu_torch.cli", *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=TIMEOUT_S)


def test_convert_bag(tmp_path):
    msgs, clouds = _make_messages()
    bag, out = str(tmp_path / "drive.bag"), str(tmp_path / "drive.npz")
    rosbag.write_minimal_bag(bag, msgs, chunked="bz2")
    r = cli("convert-bag", bag, out)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.splitlines()[-1])["scans"] == len(clouds)
    for log in (load_log(out), jax_load_log(out)):       # a log that both packages read
        assert len(log) == len(clouds)
        for (pts, ego, tf), (xyz, pos) in zip(log, clouds):
            np.testing.assert_array_equal(pts, xyz)
            np.testing.assert_array_equal(ego, pos)
            assert tf is None


@pytest.mark.parametrize("mode", ["--sequential", "--batch=2"])
def test_replay_on_the_cpu(mode):
    r = cli("replay", mode, "--device", "cpu", "--scans", "3", "--grid", "32", "--grid-z", "16", "--points", "1024",
            "--channels", "8", "--azimuth", "64")
    assert r.returncode == 0, r.stderr
    out = json.loads(r.stdout.splitlines()[-1])
    assert out["scans"] == 3 and out["device"] == "cpu" and out["counters"]["scans"] == 3
    assert out["launches"] == {}                       # the plain versions ran, no kernel
    if mode == "--sequential":
        assert out["counters"]["combines"] == 3 and out["timings"]["combine_s"]["n"] == 3
    else:
        assert out["batches"] == 2 and out["counters"]["batches"] == 2


def test_selftest_needs_a_gpu():
    r = cli("selftest")
    assert r.returncode != 0 and "no CUDA device" in r.stderr and r.stdout == ""


def _wait_for(pred, timeout=2.0, poll=0.02):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if pred():
            return True
        time.sleep(poll)
    return False


def test_heartbeat_detects_a_dead_peer_and_its_restart(tmp_path):
    failures = []
    a = HeartbeatMonitor(str(tmp_path), 0, 2, interval_s=0.02, timeout_s=0.2, on_failure=failures.append)
    b = HeartbeatMonitor(str(tmp_path), 1, 2, interval_s=0.02, timeout_s=0.2)
    with a, b:
        assert _wait_for(lambda: a.check_peers() == [])
        b.stop()
        assert _wait_for(lambda: a.dead_peers() == [1])
        assert failures and failures[-1] == [1]
        with HeartbeatMonitor(str(tmp_path), 1, 2, interval_s=0.02, timeout_s=0.2):
            assert _wait_for(lambda: a.check_peers() == [])


def test_resumable_checkpoints_of_the_port(tmp_path, monkeypatch):
    assert resume_latest(str(tmp_path)) is None and load_resumable(str(tmp_path), device="cpu") is None
    cfg = GvomConfig(xy_size=8, z_size=8, max_points=16, buffer_size=2)
    world = empty_world_state(cfg, "cpu")
    world.grid.hit[1, 2, 3] = 7
    save_world(str(tmp_path / "world_b3"), world, cfg)
    (tmp_path / "world_b7.npz").write_bytes(b"torn")
    (tmp_path / "unrelated.txt").write_bytes(b"")
    assert resume_latest(str(tmp_path)) == (str(tmp_path / "world_b7.npz"), 7)
    loaded, batches = load_resumable(str(tmp_path), device="cpu")
    assert batches == 3 and int(loaded.grid.hit[1, 2, 3]) == 7
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_resumable(str(tmp_path))


_FLAKY_WORKER = """
import os, sys
marker = sys.argv[1]
if not os.path.exists(marker):
    open(marker, "w").close()
    sys.exit(17)
"""


def test_supervise_restarts_a_crashed_worker_and_kills_a_hung_one(tmp_path):
    codes = supervise([sys.executable, "-c", _FLAKY_WORKER, str(tmp_path / "crashed_once")], max_restarts=2,
                      poll_s=0.02)
    assert codes == [17, 0]
    hb = tmp_path / "hb"
    hb.mkdir()
    with pytest.raises(RuntimeError, match=r"exit codes \[-9, -9\]"):
        supervise([sys.executable, "-c", "import time; time.sleep(30)"], max_restarts=1, heartbeat_dir=str(hb),
                  heartbeat_timeout_s=0.3, heartbeat_startup_grace_s=0.3, poll_s=0.05)
