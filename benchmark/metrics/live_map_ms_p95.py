"""live_map_ms_p95: the 95th percentile over every map of the window of
process_pointcloud's call to combine_maps' return, host clock, in ms."""

import numpy as np


def read(rec):
    if rec["loop"] != "live" or not rec["latencies_s"]:
        return None
    return float(np.percentile(np.asarray(rec["latencies_s"]) * 1e3, 95))
