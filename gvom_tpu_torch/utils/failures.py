"""Failure detection and elastic recovery (SURVEY.md §5); the port's copy of
gvom_tpu/utils/failures.py, over the port's checkpoints.

The reference has no failure handling beyond degenerate-input guards
(gvom.py:107-109, 148-150, 179-181); a crash loses the entire fused map
(the last_combined_* rotation, gvom.py:268-274). Here long replays are
resumable: the world pytree is checkpointed periodically
(engine/replay.batched_replay), and this module adds the two host-side
pieces that make that an actual recovery story:

  * HeartbeatMonitor — liveness detection across processes/hosts via a
    shared directory (one file per process; works over NFS for multi-host
    runs, where a hung peer gives no failure callback — it just stalls
    the collective).
  * supervise / resume_latest — restart-from-last-checkpoint supervision
    of a worker command: the supervisor loop that turns deterministic
    replay + periodic snapshots into elastic recovery.
"""

from __future__ import annotations

import os
import re
import subprocess
import threading
import time
import zipfile
import zlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from gvom_tpu_torch.types import resolve_device
from gvom_tpu_torch.utils.checkpoint import load_world

__all__ = ["HeartbeatMonitor", "resume_latest", "load_resumable", "supervise"]


class HeartbeatMonitor:
    """File-based heartbeat: each process periodically touches
    `dir/hb_<pid>` with a monotonically increasing sequence number; any
    process can ask which peers are stale. File mtimes are NOT compared
    across hosts (clocks may skew) — staleness is judged by whether the
    peer's sequence number advanced since the previous check, timed by the
    local clock only."""

    def __init__(
        self,
        directory: str,
        process_id: int,
        n_processes: int,
        interval_s: float = 0.5,
        timeout_s: float = 3.0,
        on_failure: Optional[Callable[[List[int]], None]] = None,
        startup_grace_s: Optional[float] = None,
    ):
        """timeout_s must exceed the peer's worst inter-beat gap — for a
        worker that beats once per fused batch (engine/replay) that includes
        the batch's compute, so size it above the worst batch wall time.
        startup_grace_s (default 10×timeout_s) applies only BEFORE a peer's
        first observed beat: a worker still importing torch or building its
        kernels (routinely ≫ timeout_s) is not declared hung."""
        self.directory = directory
        self.process_id = int(process_id)
        self.n_processes = int(n_processes)
        self.interval_s = float(interval_s)
        self.timeout_s = float(timeout_s)
        self.startup_grace_s = (
            10.0 * self.timeout_s if startup_grace_s is None else float(startup_grace_s)
        )
        self.on_failure = on_failure
        self._seq = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # peer -> (last seen seq, local time it advanced)
        self._last: Dict[int, Tuple[int, float]] = {}
        self._dead: List[int] = []
        self._lock = threading.Lock()
        os.makedirs(directory, exist_ok=True)

    def _path(self, pid: int) -> str:
        return os.path.join(self.directory, f"hb_{pid}")

    def beat(self) -> None:
        """Write one heartbeat (atomic rename so readers never see a torn
        file)."""
        self._seq += 1
        tmp = self._path(self.process_id) + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(self._seq))
        os.replace(tmp, self._path(self.process_id))

    def check_peers(self) -> List[int]:
        """Returns process ids whose heartbeat has not advanced within
        timeout_s (missing file counts as never having beaten).

        Liveness is any CHANGE of the peer's sequence number, not an
        increase: a restarted worker resets its seq to 1 while its pre-crash
        file (holding a higher seq) may persist — requiring seq to grow would
        declare the healthy restarted worker dead until it outlived its own
        past)."""
        now = time.monotonic()
        dead = []
        for pid in range(self.n_processes):
            if pid == self.process_id:
                continue
            seq = -1
            try:
                with open(self._path(pid)) as f:
                    seq = int(f.read().strip() or -1)
            except (OSError, ValueError):
                pass
            prev = self._last.get(pid)
            if prev is None or seq != prev[0]:
                self._last[pid] = (seq, now)
            elif now - prev[1] > (self.timeout_s if seq >= 0 else self.startup_grace_s):
                dead.append(pid)
        with self._lock:
            self._dead = dead
        return dead

    def dead_peers(self) -> List[int]:
        with self._lock:
            return list(self._dead)

    def _run(self) -> None:
        while not self._stop.is_set():
            self.beat()
            dead = self.check_peers()
            if dead and self.on_failure is not None:
                self.on_failure(dead)
            self._stop.wait(self.interval_s)

    def start(self) -> "HeartbeatMonitor":
        self.beat()  # visible immediately, before the first interval
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=self.timeout_s)
            self._thread = None

    def __enter__(self) -> "HeartbeatMonitor":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


_CKPT_RE = re.compile(r"world_b(\d+)(?:\.npz)?$")


def resume_latest(checkpoint_dir: str) -> Optional[Tuple[str, int]]:
    """Newest periodic checkpoint written by batched_replay:
    (path, batches already fused into it), or None if there is none."""
    ranked = _ranked_checkpoints(checkpoint_dir)
    return ranked[0] if ranked else None


def _ranked_checkpoints(checkpoint_dir: str) -> List[Tuple[str, int]]:
    try:
        names = os.listdir(checkpoint_dir)
    except OSError:
        return []
    out = []
    for name in names:
        m = _CKPT_RE.match(name)
        if m:
            out.append((os.path.join(checkpoint_dir, name), int(m.group(1))))
    out.sort(key=lambda t: -t[1])
    return out


def load_resumable(checkpoint_dir: str, device="cuda"):
    """Load the newest checkpoint that actually loads, on `device`: (world,
    batches), or None. A torn/corrupt newest file (e.g. the process died
    mid-save on a filesystem without atomic rename) falls back to the
    next-older intact one instead of poisoning every restart."""
    dev = resolve_device(device)   # no card is an error, not a corrupt file
    for path, batches in _ranked_checkpoints(checkpoint_dir):
        try:
            return load_world(path, dev), batches
        except (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile, zlib.error):
            continue
    return None


def supervise(
    cmd: Sequence[str],
    max_restarts: int = 3,
    env: Optional[dict] = None,
    heartbeat_dir: Optional[str] = None,
    heartbeat_timeout_s: float = 5.0,
    heartbeat_startup_grace_s: Optional[float] = None,
    poll_s: float = 0.2,
) -> List[int]:
    """Run `cmd` to completion, restarting it after crashes (the worker is
    expected to resume from its own checkpoints — see engine/replay).

    With `heartbeat_dir`, the worker is also KILLED and restarted when its
    heartbeat (process id 0 in that directory) goes stale — the hung-worker
    case exit codes never report. Returns the list of exit codes observed;
    the last one is 0 on success. Raises RuntimeError when the restart
    budget is exhausted."""
    codes: List[int] = []
    for _ in range(max_restarts + 1):
        if heartbeat_dir is not None:
            # clear the worker's previous heartbeat so the fresh monitor
            # can't baseline on a stale pre-crash seq (it would otherwise
            # wait for the restarted worker's 1,2,3… to CHANGE from the old
            # high value — harmless now that liveness is seq inequality, but
            # a missing file also makes startup_grace_s apply cleanly)
            try:
                os.remove(os.path.join(heartbeat_dir, "hb_0"))
            except OSError:
                pass
        proc = subprocess.Popen(list(cmd), env=env)
        mon = None
        if heartbeat_dir is not None:
            # supervisor is peer 1 of 2: it only watches, the worker beats
            mon = HeartbeatMonitor(
                heartbeat_dir, process_id=1, n_processes=2,
                timeout_s=heartbeat_timeout_s,
                startup_grace_s=heartbeat_startup_grace_s,
            )
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            if mon is not None and 0 in mon.check_peers():
                proc.kill()
                proc.wait()
                rc = -9
                break
            time.sleep(poll_s)
        codes.append(int(rc))
        if rc == 0:
            return codes
    raise RuntimeError(f"worker failed after {max_restarts} restarts: exit codes {codes}")
