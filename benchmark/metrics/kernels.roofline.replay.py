"""kernels.roofline.replay: the port's kernels in the traced steps, the sum
of their bounds over the sum of their device time, in %. Nothing where
the trace lost a launch of any of them."""

from benchmark.trace import incomplete


def read(rec):
    t, bounds = rec.get("trace"), rec.get("bounds")
    if not t or not bounds or incomplete(t):
        return None
    dev_s = sum(t["groups"][g]["seconds"] for g in bounds)
    return 100.0 * sum(bounds.values()) * 1e-3 / dev_s if dev_s > 0 else None
