"""device.idle_ms_in_step.replay: the traced stretch's device idle time that
falls inside the program's `step` spans, on the fitted clock
(benchmark/spans.py), in ms over the traced steps. The rest of the idle
time belongs to the loop and the profiler. Nothing where the program keeps
no span or the clock does not fit."""

from benchmark.spans import idle_inside, traced_steps


def read(rec):
    got = traced_steps(rec)
    return 1e3 * idle_inside(got["trace"], got["steps"], got["fit"]) / len(got["steps"]) if got else None
