"""facade.combine_ms.live: median host ms of combine_maps over the window's
maps."""

import statistics


def read(rec):
    return statistics.median(rec["combine_ms"]) if rec.get("combine_ms") else None
