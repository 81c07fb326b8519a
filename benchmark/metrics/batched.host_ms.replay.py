"""batched.host_ms.replay: host ms from a batched step's call to its return,
by the program's own `step` span, median over the traced steps (selected on
the device trace's clock, benchmark/spans.py). Nothing where the program
keeps no span or the clock does not fit."""

import statistics

from benchmark.spans import traced_steps


def read(rec):
    got = traced_steps(rec)
    return statistics.median(s.end_ns - s.start_ns for s in got["steps"]) * 1e-6 if got else None
