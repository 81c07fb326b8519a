"""batched.enqueue_ms.replay: host ms until the step call returns, median
over steps each called on an idle device queue (how close the host is to
setting the pace)."""

import statistics


def read(rec):
    ms = rec.get("enqueue_ms")
    return statistics.median(ms) if ms else None
