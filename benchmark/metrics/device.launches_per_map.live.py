"""device.launches_per_map.live: every device operation (kernel, copy,
fill) in the traced maps, per map. Nothing where the trace's count of a
port kernel differs from its launch counter."""

from benchmark.trace import incomplete


def read(rec):
    t = rec.get("trace")
    if not t or incomplete(t) or not rec["traced"]["j"]:
        return None
    return t["device_ops"] / len(rec["traced"]["j"])
