"""The device's idle share of the untraced window, in %: 1 − (the traced
maps' device busy time, the union of their operations' time, over their
count) / (a map's time in the untraced part of the window, by CUDA events).
A map's device work does not depend on the host's pace, which the profiler
slows; the untraced maps run at the window's own pace. Nothing where the
trace lost a launch of a port kernel."""

from benchmark.trace import incomplete


def read(rec):
    t, untraced_ms = rec.get("trace"), rec.get("untraced_ms")
    if not t or incomplete(t) or not untraced_ms:
        return None
    return 100.0 * (1.0 - 1e3 * t["busy_s"] / rec["traced_iters"] / untraced_ms)
