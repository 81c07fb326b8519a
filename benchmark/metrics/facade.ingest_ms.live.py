"""facade.ingest_ms.live: median host ms of process_pointcloud over the
window's maps."""

import statistics


def read(rec):
    return statistics.median(rec["ingest_ms"]) if rec.get("ingest_ms") else None
