"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its metrics are found by
name from BENCHMARK.json (benchmark/harness.py). Needs a CUDA card; the
last line of standard output is the result as one JSON object.
"""

import os
import sys
import time

T_CALLED = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _process_start() -> float:
    """The perf_counter reading at which this process started, from the
    kernel's record of it (in clock ticks since boot), else the moment this
    file began to run."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return T_CALLED - max(0.0, min(age, 60.0))
    except (OSError, ValueError, IndexError):
        return T_CALLED


if __name__ == "__main__":
    t_start = _process_start()
    # every cache that a run writes stays inside the checkout, at a fixed path
    cache = os.path.join(ROOT, "bench_out", "cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    sys.path[0] = ROOT   # the package's modules by their package names only (it has a trace.py)
    from benchmark.harness import main

    sys.exit(main(sys.argv[1:], t_start))
