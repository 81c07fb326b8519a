"""The traced stretch of a `--trace 1` run.

The window runs WAIT_SHARE of its time untraced first: CUDA events around
those iterations give their device time per iteration, which is what the
window's own rate runs at. Then the profiler starts, on its own schedule:
WARMUP iterations traced and thrown away (a trace can lose its first
launches, and the profiler's own start-up falls there), then ACTIVE
iterations traced. The profiler records CUDA
activity only (kernels, copies, fills, and the host's CUDA calls), and the
benchmark opens no host span: recording every host operation would slow
the host, and the trace would show the profiler's cost instead of the
program's. The device queue is drained before the traced iterations and
after them, so every device operation between the first CUDA call of the
stretch and its last device synchronisation belongs to them. The port's
launch counters are read at both ends.
"""

from __future__ import annotations

import sys
import time
import warnings

import torch

__all__ = ["WAIT_SHARE", "WARMUP", "ACTIVE", "TracedStretch", "launch_counts"]

WAIT_SHARE = 0.3   # of the window's seconds, untraced before the profiler's warm-up
WARMUP = 3
ACTIVE = 12


def launch_counts() -> dict:
    from gvom_tpu_torch.ops import kernels

    return {k.name: k.launches for k in kernels.KERNELS}


class TracedStretch:
    """The traced run's schedule over a window of `seconds`. Call before(i)
    and after(i) around iteration i's work, and stop() once the window has
    closed. The profiler starts at the first iteration that begins
    WAIT_SHARE · seconds into the window; until then `first` and `last`
    lie past every iteration."""

    def __init__(self, path, seconds: float):
        self.start_after_s = WAIT_SHARE * seconds
        self.wait = None
        self.first = self.last = sys.maxsize
        self.active = ACTIVE
        self.path = path
        self.prof = None
        self._ev = {k: torch.cuda.Event(enable_timing=True) for k in ("u0", "u1", "t0", "t1")}
        self.deltas = {}
        self.untraced_ms = None   # device ms an iteration, untraced (iterations 0 .. wait − 1)
        self.traced_ms = None     # device ms an iteration, traced

    def traced(self, i: int) -> bool:
        return self.first <= i <= self.last

    def _start(self, i: int) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule

        self._ev["u1"].record()
        self.wait = i
        self.first = i + WARMUP
        self.last = self.first + ACTIVE - 1
        warnings.filterwarnings("ignore", message="Warning: Profiler clears events")
        path = self.path
        self.prof = profile(activities=[ProfilerActivity.CUDA],
                            schedule=schedule(wait=0, warmup=WARMUP, active=ACTIVE, repeat=1),
                            on_trace_ready=lambda p: p.export_chrome_trace(str(path)))
        self.prof.start()

    def before(self, i: int) -> None:
        """Before iteration i's work."""
        if i == 0:
            self._t0 = time.perf_counter()
            self._ev["u0"].record()
        elif self.prof is None and time.perf_counter() - self._t0 >= self.start_after_s:
            self._start(i)
        if i == self.first:
            self._c0 = launch_counts()
            self._ev["t0"].record()

    def after(self, i: int) -> None:
        """After iteration i's work."""
        if i == self.first - 1:
            torch.cuda.synchronize()
        if i == self.last:
            self._ev["t1"].record()
            torch.cuda.synchronize()
            c1 = launch_counts()
            self.deltas = {k: c1[k] - self._c0[k] for k in c1}
            self.untraced_ms = self._ev["u0"].elapsed_time(self._ev["u1"]) / self.wait
            self.traced_ms = self._ev["t0"].elapsed_time(self._ev["t1"]) / self.active
        if self.prof is not None:
            self.prof.step()

    def stop(self) -> None:
        if self.prof is not None:
            self.prof.stop()
