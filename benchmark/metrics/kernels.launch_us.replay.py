"""kernels.launch_us.replay: host µs of one ctypes launch call of a port
kernel, by the program's `kernel/*` spans inside the traced steps, median.
Nothing where the program keeps no span or the clock does not fit."""

import statistics

from benchmark.spans import traced_steps


def read(rec):
    got = traced_steps(rec)
    if not got:
        return None
    steps = got["steps"]
    us = [1e-3 * (s.end_ns - s.start_ns) for s in got["spans"] if s.name.startswith("kernel/")
          and any(t.start_ns <= s.start_ns and s.end_ns <= t.end_ns for t in steps)]
    return statistics.median(us) if us else None
